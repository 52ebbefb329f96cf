"""Exact seed-index search on the device, for the localizer (B7).

The localizer's seed matching (the reference's ``bwa mem -k s -T s -a``
subprocess, kevlar/localize.py:131-144) is an exact lookup of canonical
seed keys against every seed-sized window of the reference genome.  The
host path of :class:`kevlar_tpu_torch.reference.SeedIndex` binary-searches
the sorted 64-bit fold keys with numpy; its ``'device'`` backend keeps the
keys on the card and answers a whole seed batch with two
``torch.searchsorted`` calls (:func:`seed_ranges`).

The keys are uint64, and torch has no unsigned 64-bit search: they travel
as int64 with the sign bit flipped (:func:`ordered_int64`), which keeps
their order.  The fold keys are uniform over 64 bits, so half of them are
at or above 2^63: a plain cast (or ``torch.from_numpy`` of a uint64 view)
would put those first and return wrong ranges with no error.

The ``'sharded'`` backend cuts the sorted keys into one contiguous run per
shard of a mesh (:func:`shard_keys`) and searches every shard
(:func:`seed_ranges_sharded`), as ``kevlar_tpu``'s ``seed_ranges_sharded``
does over its mesh.
"""

import numpy as np
import torch

_SIGN = np.uint64(1 << 63)

# calls of seed_ranges (each is two torch.searchsorted launches)
launches = 0


def ordered_int64(keys):
    """uint64 keys -> int64 keys in the same order (sign bit flipped)."""
    keys = np.asarray(keys, dtype=np.uint64)
    return (keys ^ _SIGN).view(np.int64)


def seed_ranges(keys, queries):
    """Match ranges of query keys in a sorted key tensor.

    ``keys``: sorted int64 tensor (from :func:`ordered_int64`);
    ``queries``: int64 tensor of the same encoding, on the same device.
    Returns ``(start, count)`` int64 tensors, one entry per query: the
    insertion point on the left, and the number of keys equal to the query.
    """
    global launches
    launches += 1
    start = torch.searchsorted(keys, queries, side='left')
    stop = torch.searchsorted(keys, queries, side='right')
    return start, stop - start


def shard_keys(keys, n_shard):
    """Split a sorted uint64 key array into ``n_shard`` runs.

    Returns ``(shards, n_valid, base)``: ``shards`` [n_shard, cap] int64,
    the runs as order-preserving int64 (:func:`ordered_int64`), each padded
    with int64 max; ``n_valid`` [n_shard], the real keys of each run; and
    ``base`` [n_shard] int64, each run's offset in the whole array (it stays
    on the host: genome-scale indexes pass 2^31 entries).  A search holds
    each run to its ``n_valid`` prefix, so a real key of 2^64 - 1 (int64
    max once ordered) never matches the padding."""
    keys = np.asarray(keys, dtype=np.uint64)
    n = len(keys)
    cap = max(1, -(-n // n_shard))
    shards = np.full((n_shard, cap), np.iinfo(np.int64).max, dtype=np.int64)
    n_valid = np.zeros(n_shard, dtype=np.int64)
    base = np.zeros(n_shard, dtype=np.int64)
    for s in range(n_shard):
        a, b = min(s * cap, n), min((s + 1) * cap, n)
        shards[s, :b - a] = ordered_int64(keys[a:b])
        n_valid[s] = b - a
        base[s] = a
    return shards, n_valid, base


def seed_ranges_sharded(mesh, shards, queries, n_valid, base):
    """Match ranges against keys sharded over the mesh's 'shard' axis.

    ``shards``: one int64 tensor of a run's keys per shard, on
    ``mesh.devices[0][s]`` (:func:`shard_keys`; None where another rank
    owns the cell); ``queries``: int64 tensor of :func:`ordered_int64`
    keys; ``n_valid`` and ``base`` as :func:`shard_keys` returns them.
    Every shard of data row 0 (the others would repeat it) runs
    :func:`seed_ranges` on its valid prefix, on the rank that owns it; the
    count is a sum over the shards, and the first shard with a hit and its
    local start come from minima over the shards with hits; every rank of
    the mesh gets them.  Returns numpy ``(start int64, count int64)`` in
    the whole array's index space; start is int64 max where count is 0
    (the global index math stays on the host, as genome-scale indexes pass
    2^31 entries)."""
    from kevlar_tpu_torch.parallel import collectives
    row = mesh.row(0)
    nohit = np.iinfo(np.int64).max
    local = [s for _, s in row.local_cells()]
    starts, counts, firsts = ([None] * row.shape['shard'] for _ in range(3))
    for s in local:
        q = queries.to(row.devices[0][s])
        if int(n_valid[s]):
            start, cnt = seed_ranges(shards[s][:int(n_valid[s])], q)
        else:
            start = cnt = torch.zeros_like(q)
        starts[s] = start
        counts[s] = cnt
        firsts[s] = torch.where(cnt > 0, s, nohit)
    count = collectives.psum(row, [counts], 'shard')[0]
    first = collectives.pmin(row, [firsts], 'shard')[0]
    start = collectives.pmin(row, [[
        torch.where(first[s] == s, starts[s], nohit) if s in local else None
        for s in range(row.shape['shard'])]], 'shard')[0]
    mine = local[0] if local else None
    count, first, start = (x.cpu().numpy() for x in collectives.share(
        mesh, [None if mine is None else x[mine] for x in (count, first,
                                                           start)],
        [mesh.ranks[0][0]] * 3, device=torch.device('cpu')))
    out = np.full(count.shape, nohit, dtype=np.int64)
    hit = count > 0
    out[hit] = np.asarray(base, dtype=np.int64)[first[hit]] + start[hit]
    return out, count
