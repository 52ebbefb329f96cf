"""A ('data', 'shard') mesh of torch devices, in one process or over ranks.

Counterpart of ``kevlar_tpu/parallel/mesh.py``.  ``kevlar_tpu`` runs its
sharded programs over a ``jax.sharding.Mesh``; the port does the same over
a :class:`Mesh` that holds a 2-D grid of ``torch.device``\\ s, and moves
data between them with the collectives of
:mod:`kevlar_tpu_torch.parallel.collectives`.  A device may appear more
than once in the grid: four shards on one card are four slices of its
memory, counted and exchanged exactly as on four cards.

Every cell is owned by a rank.  Without a process group every cell is
rank 0's and one process drives the whole mesh.  After
:func:`init_distributed` (``jax.distributed.initialize``'s counterpart),
:func:`make_mesh` spans every rank's devices, as ``jax.devices()`` spans
every process's: each rank holds, computes and adds only its own cells,
and the collectives cross ranks through ``torch.distributed`` sub-groups.
Every rank runs the same program on the same input and builds the same
mesh, as every JAX process does.
"""

import torch
import torch.distributed as dist


def _initialized():
    return dist.is_available() and dist.is_initialized()


def _rank():
    return dist.get_rank() if _initialized() else 0


class Mesh:
    """``devices[d][s]``: the device of data row ``d``, shard ``s``;
    ``ranks[d][s]``: the rank that owns it; ``shape`` = ``{'data': n_data,
    'shard': n_shard}``.

    ``devices`` is a grid of devices, all this process's (rank 0's without
    a process group), or of ``(rank, device)`` pairs, which need
    :func:`init_distributed` first.  A mesh of pairs is *distributed*: it
    makes, once and on every rank in the same order, a ``torch.distributed``
    sub-group for the ranks of the whole mesh and of each group of each
    axis (``new_group`` must be called by every rank for every group), so
    every rank of the process group must build it, even a rank that owns
    none of its cells."""

    def __init__(self, devices):
        cells = [list(row) for row in devices]
        paired = [isinstance(c, tuple) for row in cells for c in row]
        widths = {len(row) for row in cells}
        if not cells or len(widths) != 1 or not widths.pop():
            raise ValueError('a mesh is a non-empty grid of devices')
        if any(paired) and not all(paired):
            raise ValueError('name every cell of a mesh as (rank, device) or '
                             'none')
        self.rank = _rank()
        self.distributed = all(paired)
        if self.distributed:
            if not _initialized():
                raise ValueError('a mesh whose cells name ranks needs a '
                                 'process group: call init_distributed '
                                 'first')
            world = dist.get_world_size()
            self.ranks = [[int(r) for r, _ in row] for row in cells]
            self.devices = [[torch.device(dev) for _, dev in row]
                            for row in cells]
            bad = {r for row in self.ranks for r in row
                   if not 0 <= r < world}
            if bad:
                raise ValueError('ranks {} are outside the process group of '
                                 '{}'.format(sorted(bad), world))
        else:
            self.devices = [[torch.device(dev) for dev in row]
                            for row in cells]
            self.ranks = [[self.rank] * len(row) for row in cells]
        self.shape = {'data': len(self.devices),
                      'shard': len(self.devices[0])}
        self.backend = dist.get_backend() if self.distributed else None
        self._process_groups = {}
        if self.distributed:
            for cells_ in [self.cells()] + self.groups('shard') + \
                    self.groups('data'):
                key = self._ranks_of(cells_)
                if key in self._process_groups:
                    continue
                # gloo moves host memory: a one-rank group stays in the
                # process; NCCL's is a device-side no-op that keeps every
                # NCCL call of the program checked on one rank
                self._process_groups[key] = dist.new_group(list(key)) \
                    if len(key) > 1 or self.backend == 'nccl' else None

    def cells(self):
        """Every ``(d, s)`` of the grid, row by row."""
        return [(d, s) for d in range(self.shape['data'])
                for s in range(self.shape['shard'])]

    def groups(self, axis):
        """The cells of each group of ``axis``: a data row's shards, or a
        shard column's data rows."""
        n_data, n_shard = self.shape['data'], self.shape['shard']
        if axis == 'shard':
            return [[(d, s) for s in range(n_shard)] for d in range(n_data)]
        if axis == 'data':
            return [[(d, s) for d in range(n_data)] for s in range(n_shard)]
        raise ValueError('no mesh axis {!r}'.format(axis))

    def is_local(self, d, s):
        """Whether this rank owns cell ``(d, s)``."""
        return self.ranks[d][s] == self.rank

    def local_cells(self):
        """The cells this rank owns, row by row."""
        return [c for c in self.cells() if self.is_local(*c)]

    def elsewhere(self):
        """``{rank: [cells]}`` of the cells other ranks own."""
        out = {}
        for d, s in self.cells():
            if not self.is_local(d, s):
                out.setdefault(self.ranks[d][s], []).append((d, s))
        return out

    @property
    def home(self):
        """The device of this rank's first cell, where results are
        gathered."""
        local = self.local_cells()
        if not local:
            raise ValueError('rank {} owns no cell of this mesh'.format(
                self.rank))
        d, s = local[0]
        return self.devices[d][s]

    def _ranks_of(self, cells):
        return tuple(sorted({self.ranks[d][s] for d, s in cells}))

    def process_group(self, cells):
        """The process group that joins the ranks of ``cells``, or None
        where the collective over them stays in this process."""
        if not self.distributed:
            return None
        return self._process_groups[self._ranks_of(cells)]

    def row(self, d):
        """Data row ``d`` as a mesh of its own (its 'shard' group is this
        mesh's, so no process group is made)."""
        out = Mesh.__new__(Mesh)
        out.__dict__.update(self.__dict__)
        out.devices = [self.devices[d]]
        out.ranks = [self.ranks[d]]
        out.shape = {'data': 1, 'shard': self.shape['shard']}
        return out

    def _key(self):
        return tuple(tuple(zip(r, (str(x) for x in dev)))
                     for r, dev in zip(self.ranks, self.devices))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


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


def _gathered(local):
    """Every rank's ``local`` devices as ``(rank, device)`` pairs, in rank
    order (a collective over the whole process group)."""
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(dev) for dev in local])
    return [(rank, torch.device(dev)) for rank, devs in enumerate(lists)
            for dev in devs]


def device_grid(n_data=None, n_shard=None, devices=None, device='cuda'):
    """Pick a (data, shard) grid: returns ``(n_data, n_shard, devices)``.

    With no ``devices``, ``device`` says what is available: on ``'cuda'``
    every card, whose count the grid must fill; on ``'cpu'`` the CPU,
    repeated as often as the grid asks (an axis not given is 1).  After
    :func:`init_distributed` that is every rank's: each rank's cards (or
    its even share of the grid's CPU cells, at least one) are gathered in
    rank order as ``(rank, device)`` pairs.  An explicit ``devices`` list
    may name a device more than once, and may name cells as ``(rank,
    device)`` pairs.  The default grid is all shard, as in ``kevlar_tpu``
    (memory scales with the shards)."""
    if devices is None:
        devices = _available(device)
        if devices is None:
            want = (n_data or 1) * (n_shard or 1)
            world = dist.get_world_size() if _initialized() else 1
            devices = [torch.device('cpu')] * -(-want // world)
        if _initialized():
            devices = _gathered(devices)
    devices = [(cell[0], torch.device(cell[1])) if isinstance(cell, tuple)
               else torch.device(cell) for cell in devices]
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


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, **kwargs):
    """Start multi-host execution: ``jax.distributed.initialize``'s
    counterpart, over ``torch.distributed.init_process_group``.

    ``coordinator_address`` is ``host:port`` (rank 0's, as
    ``tcp://host:port``) or a URL ``init_process_group`` takes as it is
    (``tcp://``, ``file://``, ``env://``); with no arguments the standard
    environment variables are used (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``num_processes`` and
    ``process_id`` are the world size and this process's rank.
    ``backend`` is ``'nccl'`` (the default: between cards) or ``'gloo'``
    (host memory: the CPU, or ranks that share a card); a failed start
    raises, and NCCL never falls back to gloo.  ``kwargs`` go to
    ``init_process_group`` (``timeout``, ...).  Under NCCL, set each rank's
    card first (``torch.cuda.set_device``).

    After it, :func:`make_mesh` spans every rank's devices and the sharded
    programs run unchanged.  Returns every rank's devices as ``(rank,
    torch.device)`` pairs in rank order, as ``jax.devices()`` lists every
    process's: its cards, or the CPU on a rank without one."""
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = 'tcp://' + coordinator_address
    dist.init_process_group(backend or 'nccl', init_method=init_method,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id,
                            **kwargs)
    local = _available('cuda') if torch.cuda.is_available() else None
    return _gathered(local or [torch.device('cpu')])
