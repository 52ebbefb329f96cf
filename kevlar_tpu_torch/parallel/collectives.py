"""In-process collectives over one axis of a :class:`~kevlar_tpu_torch.
parallel.mesh.Mesh`: the port's counterparts of ``lax.all_to_all``,
``lax.psum``, ``lax.pmin`` and ``lax.pmax`` in ``kevlar_tpu``'s
``shard_map`` programs.

A value over the mesh is a grid ``values[d][s]`` of tensors, each on
``mesh.devices[d][s]``.  A collective over ``'shard'`` works within each
data row, one over ``'data'`` within each shard column.  Every exchange is
a ``tensor.to(device, non_blocking=True)``: PyTorch runs a copy between two
cards on the source's current stream after it waits on the destination's,
and makes the destination's current stream wait for the copy, so each copy
follows the kernel that produced its source and precedes the one that
reads it (the port launches every kernel on
``torch.cuda.current_stream(device)``).  Between the cards of one host a
copy is a peer copy over NVLink, 450 GB/s each way on an H100; a device
that appears twice in the mesh copies nothing (``to`` returns the tensor
itself), which is all one card can show.  Results on one device may be one
tensor, or views of the senders' (:func:`all_to_all_parts`): treat them as
read-only.
"""

import torch


def _groups(mesh, axis):
    """The cells of each group of ``axis``: a data row's shards, or a shard
    column's data rows."""
    n_data, n_shard = mesh.shape['data'], mesh.shape['shard']
    if axis == 'shard':
        return [[(d, s) for s in range(n_shard)] for d in range(n_data)]
    if axis == 'data':
        return [[(d, s) for d in range(n_data)] for s in range(n_shard)]
    raise ValueError('no mesh axis {!r}'.format(axis))


def _reduce(mesh, values, axis, op):
    out = [[None] * mesh.shape['shard'] for _ in range(mesh.shape['data'])]
    for group in _groups(mesh, axis):
        home = mesh.devices[group[0][0]][group[0][1]]
        total = values[group[0][0]][group[0][1]]
        for d, s in group[1:]:
            total = op(total, values[d][s].to(home, non_blocking=True))
        for d, s in group:
            out[d][s] = total.to(mesh.devices[d][s], non_blocking=True)
    return out


def psum(mesh, values, axis):
    """Each member of a group of ``axis`` gets the group's sum."""
    return _reduce(mesh, values, axis, torch.add)


def pmin(mesh, values, axis):
    """Each member of a group of ``axis`` gets the group's minimum."""
    return _reduce(mesh, values, axis, torch.minimum)


def pmax(mesh, values, axis):
    """Each member of a group of ``axis`` gets the group's maximum."""
    return _reduce(mesh, values, axis, torch.maximum)


def all_to_all_parts(mesh, send):
    """``lax.all_to_all`` over ``'shard'`` (``split_axis=1``), its parts
    unstacked: ``send[d][s]`` is ``[T, S, ...]``, and the result at ``(d,
    s)`` is the list over senders ``j`` of ``send[d][j][:, s]`` on device
    ``(d, s)``.  Where sender and receiver are one device a part is that
    view of the sender's buffer and no byte moves; between cards it is one
    copy a part."""
    n_shard = mesh.shape['shard']
    return [[[send[d][j][:, s].to(mesh.devices[d][s], non_blocking=True)
              for j in range(n_shard)] for s in range(n_shard)]
            for d in range(mesh.shape['data'])]


def all_to_all(mesh, send):
    """``lax.all_to_all`` over ``'shard'`` with ``split_axis=1,
    concat_axis=1, tiled=True``: ``send[d][s]`` is ``[T, S, C]``, and the
    result at ``(d, s)`` is ``[T, S, C]`` with ``out[d][s][:, j] =
    send[d][j][:, s]``: every shard gets slice ``s`` of every sender of its
    data row, stacked (a copy, on one card too; the routed consume takes
    :func:`all_to_all_parts` instead)."""
    return [[torch.stack(parts, dim=1) for parts in row]
            for row in all_to_all_parts(mesh, send)]
