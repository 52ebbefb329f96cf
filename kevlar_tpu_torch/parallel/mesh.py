"""A ('data', 'shard') mesh of torch devices in one process.

Counterpart of ``kevlar_tpu/parallel/mesh.py``.  ``kevlar_tpu`` runs its
sharded programs single-process over a ``jax.sharding.Mesh``; the port does
the same over a :class:`Mesh` that holds a 2-D grid of ``torch.device``\\ s,
and moves data between them with the in-process collectives of
:mod:`kevlar_tpu_torch.parallel.collectives`.  A device may appear more
than once in the grid: four shards on one card are four slices of its
memory, counted and exchanged exactly as on four cards.
"""

import torch


class Mesh:
    """``devices[d][s]``: the device of data row ``d``, shard ``s``;
    ``shape`` = ``{'data': n_data, 'shard': n_shard}``."""

    def __init__(self, devices):
        self.devices = [[torch.device(dev) for dev in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or not widths.pop():
            raise ValueError('a mesh is a non-empty grid of devices')
        self.shape = {'data': len(self.devices),
                      'shard': len(self.devices[0])}

    def cells(self):
        """Every ``(d, s)`` of the grid, row by row."""
        return [(d, s) for d in range(self.shape['data'])
                for s in range(self.shape['shard'])]

    @property
    def first(self):
        """The device of cell (0, 0), where results are gathered."""
        return self.devices[0][0]


def _available(device):
    """Every card for ``'cuda'``, the one named for ``'cuda:i'``; None for
    the CPU, which stands in for as many mesh devices as asked."""
    device = torch.device(device)
    if device.type == 'cpu':
        return None
    if device.type != 'cuda':
        raise ValueError('no mesh of {} devices'.format(device.type))
    if device.index is not None:
        return [device]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def device_grid(n_data=None, n_shard=None, devices=None, device='cuda'):
    """Pick a (data, shard) grid: returns ``(n_data, n_shard, devices)``.

    With no ``devices``, ``device`` says what is available: on ``'cuda'``
    every card, whose count the grid must fill; on ``'cpu'`` the CPU,
    repeated as often as the grid asks (an axis not given is 1).  An
    explicit ``devices`` list may name a device more than once.  The
    default grid is all shard, as in ``kevlar_tpu`` (memory scales with
    the shards)."""
    if devices is None:
        devices = _available(device)
        if devices is None:
            n_data = n_data or 1
            n_shard = n_shard or 1
            devices = [torch.device('cpu')] * (n_data * n_shard)
    devices = [torch.device(dev) for dev in devices]
    n = len(devices)
    if n_data is None and n_shard is None:
        n_shard = n
        n_data = 1
    elif n_data is None:
        n_data = n // n_shard
    elif n_shard is None:
        n_shard = n // n_data
    if n_data * n_shard != n or n_data < 1 or n_shard < 1:
        raise ValueError(
            'cannot build a {}x{} (data x shard) mesh from {} available '
            'device(s); --shards must divide the device count (use '
            'devices= for an explicit device list, which may name a card '
            'more than once)'.format(n_data, n_shard, n))
    return n_data, n_shard, devices


def make_mesh(n_data=None, n_shard=None, devices=None, device='cuda'):
    """Build a :class:`Mesh` with ('data', 'shard') axes (see
    :func:`device_grid`)."""
    n_data, n_shard, devices = device_grid(n_data, n_shard, devices, device)
    return Mesh([devices[d * n_shard:(d + 1) * n_shard]
                 for d in range(n_data)])
