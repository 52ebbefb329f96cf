"""Collectives over one axis of a :class:`~kevlar_tpu_torch.parallel.mesh.
Mesh`: the port's counterparts of ``lax.all_to_all``, ``lax.psum``,
``lax.pmin`` and ``lax.pmax`` in ``kevlar_tpu``'s ``shard_map`` programs,
and of ``process_allgather`` (:func:`share`).

A value over the mesh is a grid ``values[d][s]`` of tensors, each on
``mesh.devices[d][s]``; a cell another rank owns holds None.  A collective
over ``'shard'`` works within each data row, one over ``'data'`` within
each shard column.

Within a rank every exchange is a ``tensor.to(device,
non_blocking=True)``: PyTorch runs a copy between two cards on the
source's current stream after it waits on the destination's, and makes the
destination's current stream wait for the copy, so each copy follows the
kernel that produced its source and precedes the one that reads it (the
port launches every kernel on ``torch.cuda.current_stream(device)``).
Between the cards of one host a copy is a peer copy over NVLink, 450 GB/s
each way on an H100; a device that appears twice in the mesh copies
nothing (``to`` returns the tensor itself).  Results on one device may be
one tensor, or views of the senders' (:func:`all_to_all_parts`): treat
them as read-only.

Across ranks (a distributed mesh), a group reduces on each rank first,
then goes through the process group of its ranks
(:meth:`~kevlar_tpu_torch.parallel.mesh.Mesh.process_group`): NCCL moves
tensors on the rank's current card; gloo moves host tensors, so a CUDA
tensor is copied to fresh pinned host memory, exchanged and copied back,
synchronously (no staging buffer outlives its call).  Every rank calls
every collective of every group it holds cells of, in the same order,
whatever its data: no rank may skip one on a value only it has seen.
"""

import torch
import torch.distributed as dist

_DTYPES = (torch.uint8, torch.bool, torch.int64)


def _wire(mesh):
    """The device tensors cross ranks on: the current card under NCCL,
    the host under gloo."""
    if mesh.backend == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _to_wire(mesh, x):
    """A copy of ``x`` that the process group may overwrite, on the wire
    (pinned host memory for a CUDA tensor under gloo)."""
    wire = _wire(mesh)
    if wire.type == 'cpu' and x.is_cuda:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x)
        return out
    return x.to(wire, copy=True)


def _empty_wire(mesh, shape, dtype):
    """A receive buffer on the wire (pinned under gloo where there is a
    card)."""
    wire = _wire(mesh)
    return torch.empty(shape, dtype=dtype, device=wire,
                       pin_memory=wire.type == 'cpu' and
                       torch.cuda.is_available())


def _reduce(mesh, values, axis, op, reduce_op):
    out = [[None] * mesh.shape['shard'] for _ in range(mesh.shape['data'])]
    for group in mesh.groups(axis):
        local = [c for c in group if mesh.is_local(*c)]
        if not local:
            continue
        home = mesh.devices[local[0][0]][local[0][1]]
        total = values[local[0][0]][local[0][1]]
        for d, s in local[1:]:
            total = op(total, values[d][s].to(home, non_blocking=True))
        pg = mesh.process_group(group)
        if pg is not None:
            total = _to_wire(mesh, total)
            dist.all_reduce(total, op=reduce_op, group=pg)
            total = total.to(home)
        for d, s in local:
            out[d][s] = total.to(mesh.devices[d][s], non_blocking=True)
    return out


def psum(mesh, values, axis):
    """Each member of a group of ``axis`` gets the group's sum."""
    return _reduce(mesh, values, axis, torch.add, dist.ReduceOp.SUM)


def pmin(mesh, values, axis):
    """Each member of a group of ``axis`` gets the group's minimum."""
    return _reduce(mesh, values, axis, torch.minimum, dist.ReduceOp.MIN)


def pmax(mesh, values, axis):
    """Each member of a group of ``axis`` gets the group's maximum."""
    return _reduce(mesh, values, axis, torch.maximum, dist.ReduceOp.MAX)


def _exchange(mesh, pg, chunks, in_sizes, dtype, device):
    """``all_to_all_single`` over ``pg``: the 1-D ``chunks[i]`` go to the
    group's ``i``-th rank (sorted ranks), ``in_sizes[i]`` elements come
    from it; returns the received elements, rank by rank, on ``device``."""
    send = torch.cat([c.reshape(-1).to(device) for c in chunks])
    recv = _empty_wire(mesh, (sum(in_sizes),), dtype)
    dist.all_to_all_single(recv, _to_wire(mesh, send), list(in_sizes),
                           [c.numel() for c in chunks], group=pg)
    return recv.to(device)


def all_to_all_parts(mesh, send, pops=None):
    """``lax.all_to_all`` over ``'shard'`` (``split_axis=1``), its parts
    unstacked: ``send[d][s]`` is ``[T, S, C]``, and the result at ``(d,
    s)`` is the list over senders ``j`` of ``send[d][j][:, s]`` on device
    ``(d, s)``.  Where sender and receiver are one device a part is that
    view of the sender's buffer and no byte moves; between cards of a rank
    it is one copy a part.

    With ``pops`` (``[T, S]`` int32 beside each send buffer: bin ``(t,
    s)`` holds ``min(pops[t, s], C)`` filled slots, the rest is never
    read) returns ``(parts, part_pops)``, each part's populations beside
    it.  Between ranks the populations go first, then only each bin's
    filled prefix, packed per peer rank (one ``all_to_all_single`` each);
    the receiver lays each part's rows into a ``[T, C']`` buffer, ``C'``
    its longest row, and leaves the rest of each row unwritten.  Without
    ``pops`` every slot is filled and whole bins move."""
    n_shard = mesh.shape['shard']
    parts = [[None] * n_shard for _ in range(mesh.shape['data'])]
    got = [[None] * n_shard for _ in range(mesh.shape['data'])]
    for d, row in enumerate(mesh.groups('shard')):
        local = [s for s in range(n_shard) if mesh.is_local(d, s)]
        if not local:
            continue
        for s in local:
            dev = mesh.devices[d][s]
            parts[d][s] = [None if not mesh.is_local(d, j) else
                           send[d][j][:, s].to(dev, non_blocking=True)
                           for j in range(n_shard)]
            if pops is not None:
                got[d][s] = [None if not mesh.is_local(d, j) else
                             pops[d][j][:, s].to(dev, non_blocking=True)
                             for j in range(n_shard)]
        pg = mesh.process_group(row)
        if pg is not None:
            _cross_ranks(mesh, pg, d, local, send, pops, parts, got)
    return parts if pops is None else (parts, got)


def _cross_ranks(mesh, pg, d, local, send, pops, parts, got):
    """The parts of row ``d`` whose sender and receiver lie on different
    ranks, into ``parts`` and ``got``."""
    n_shard = mesh.shape['shard']
    peers = list(dist.get_process_group_ranks(pg))
    owned = {r: [s for s in range(n_shard) if mesh.ranks[d][s] == r]
             for r in peers}
    outgoing = {r: [] if r == mesh.rank else
                [(j, s) for j in local for s in owned[r]] for r in peers}
    incoming = {r: [] if r == mesh.rank else
                [(j, s) for j in owned[r] for s in local] for r in peers}
    dev = mesh.devices[d][local[0]]
    T, _, C = send[d][local[0]].shape
    if pops is None:
        sent = {(j, s): [C] * T for r in peers for j, s in outgoing[r]}
        recv_n = {(j, s): [C] * T for r in peers for j, s in incoming[r]}
        recv_pops = None
    else:
        # the populations first: [T] int32 a pair
        flat = _exchange(
            mesh, pg, [torch.cat([pops[d][j][:, s].to(dev)
                                  for j, s in outgoing[r]] +
                                 [torch.empty(0, dtype=torch.int32,
                                              device=dev)])
                       for r in peers],
            [T * len(incoming[r]) for r in peers], torch.int32, dev)
        pairs = [p for r in peers for p in incoming[r]]
        recv_pops = dict(zip(pairs, flat.reshape(len(pairs), T)))
        host = {j: pops[d][j].cpu() for j in local}
        sent = {(j, s): [min(int(host[j][t, s]), C) for t in range(T)]
                for r in peers for j, s in outgoing[r]}
        counts = flat.cpu()
        recv_n = {p: [min(int(counts[i * T + t]), C) for t in range(T)]
                  for i, p in enumerate(pairs)}
    # then each bin's filled prefix, row by row, pair by pair
    flat = _exchange(
        mesh, pg, [torch.cat([send[d][j][t, s, :sent[j, s][t]].to(dev)
                              for j, s in outgoing[r] for t in range(T)] +
                             [torch.empty(0, dtype=send[d][local[0]].dtype,
                                          device=dev)])
                   for r in peers],
        [sum(sum(recv_n[p]) for p in incoming[r]) for r in peers],
        send[d][local[0]].dtype, dev)
    at = 0
    for r in peers:
        for j, s in incoming[r]:
            n = recv_n[j, s]
            target = mesh.devices[d][s]
            if pops is None:
                part = flat[at:at + T * C].reshape(T, C)
            else:
                part = torch.empty((T, max(max(n), 1)), dtype=flat.dtype,
                                   device=dev)
                for t in range(T):
                    part[t, :n[t]] = flat[at + sum(n[:t]):at + sum(n[:t + 1])]
                got[d][s][j] = recv_pops[j, s].to(target)
            parts[d][s][j] = part.to(target)
            at += sum(n)


def all_to_all(mesh, send):
    """``lax.all_to_all`` over ``'shard'`` with ``split_axis=1,
    concat_axis=1, tiled=True``: ``send[d][s]`` is ``[T, S, C]``, and the
    result at ``(d, s)`` is ``[T, S, C]`` with ``out[d][s][:, j] =
    send[d][j][:, s]``: every shard gets slice ``s`` of every sender of its
    data row, stacked (a copy, on one card too; the routed consume takes
    :func:`all_to_all_parts` instead)."""
    return [[None if parts is None else torch.stack(parts, dim=1)
             for parts in row] for row in all_to_all_parts(mesh, send)]


def share(mesh, pieces, owners, device=None):
    """``process_allgather`` of results: ``pieces[i]`` is a tensor on rank
    ``owners[i]`` (None on the others); every rank of the mesh gets every
    piece, on ``device`` (default ``mesh.home``).  The owner sends the
    piece's dtype and shape first, so pieces may be ragged.  On a mesh of
    one process the pieces stay where they are."""
    if not mesh.distributed:
        return list(pieces)
    device = mesh.home if device is None else device
    pg = mesh.process_group(mesh.cells())
    out = []
    for piece, owner in zip(pieces, owners):
        if pg is None:      # every cell is this rank's
            out.append(piece.to(device))
            continue
        head = torch.zeros(10, dtype=torch.int64)
        if owner == mesh.rank:
            head[0] = _DTYPES.index(piece.dtype)
            head[1] = piece.dim()
            head[2:2 + piece.dim()] = torch.tensor(piece.shape)
        head = head.to(_wire(mesh))
        dist.broadcast(head, src=owner, group=pg)
        head = head.tolist()
        if owner == mesh.rank:
            buf = _to_wire(mesh, piece.contiguous())
        else:
            buf = _empty_wire(mesh, head[2:2 + head[1]], _DTYPES[head[0]])
        dist.broadcast(buf, src=owner, group=pg)
        out.append(buf.to(device))
    return out
