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
