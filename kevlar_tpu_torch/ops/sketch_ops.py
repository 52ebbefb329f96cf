"""Count-Min sketch operations over device tensors: the consume, the count
gather and occupancy, with the dispatch to their CUDA kernels.

Counterpart of ``kevlar_tpu/ops/sketch_ops.py`` (B3, B4) and of the B10
scatter (``tools/scatter_probe.py``).  The sketch is a ``uint8 [ntables,
width]`` tensor in the persistent layout: ``counter_bits`` of 1, 4 or 8,
bit-packed LSB-first in bucket order (bucket i in bits ``[bits*(i % cpb),
...)`` of byte ``i // cpb``), the layout ``kevlar_tpu`` saves.  Counters
saturate at 1, 15 or 255.

A consume (:func:`consume_packed`) hashes a wire-format batch (K1), drops
k-mers outside the band and, with a mask, those the mask screens out (the
mask's counts come from K2), computes each table's bucket index in int64,
and scatter-adds 1 per (table, k-mer) into an int32 accumulator (K3),
where index -1 means skip.  The :class:`Accumulator` is bucket-ordered
(``[ntables, tablesize]``): the planar layout of the JAX package exists
for the TPU's tiling and is not carried over.  It lives for one
``consume_seqfile`` call, unpacked from the tables at its start and
saturated and packed back at its end.  Saturating once at the end gives
the same counts as saturating per increment, because the adds are
monotone.

Dispatch: on CUDA tensors :func:`gather_counts` and :func:`scatter_add`
launch their kernels; on CPU tensors they run the plain versions beside
them.  No path falls back from one to the other.
"""

import torch

from kevlar_tpu_torch.ops import hashing, kmer_cuda

COUNTERS_PER_BYTE = {1: 8, 4: 2, 8: 1}
MAXCOUNT = {1: 1, 4: 15, 8: 255}

# An int32 counter takes this many increments before it could wrap; a
# consume saturates its accumulator before the windows it has scattered
# since the last saturation could pass it.
_I32_HEADROOM = (1 << 31) - 1 - 255


def packed_width(tablesize, counter_bits):
    """Bytes per table row for ``tablesize`` buckets at ``counter_bits``."""
    cpb = COUNTERS_PER_BYTE[counter_bits]
    return -(-int(tablesize) // cpb)


def pack_rows(values, counter_bits):
    """uint8 [T, Z] counter values -> uint8 [T, packed_width] rows."""
    if counter_bits == 8:
        return values.contiguous()
    cpb = COUNTERS_PER_BYTE[counter_bits]
    T, Z = values.shape
    pad = (-Z) % cpb
    if pad:
        values = torch.nn.functional.pad(values, (0, pad))
    shifts = torch.arange(cpb, device=values.device) * counter_bits
    words = values.reshape(T, -1, cpb).to(torch.int32) << shifts
    return words.sum(dim=2).to(torch.uint8)


def unpack_rows(packed, counter_bits, tablesize):
    """uint8 [T, packed_width] rows -> uint8 [T, tablesize] counter values."""
    if counter_bits == 8:
        return packed
    cpb = COUNTERS_PER_BYTE[counter_bits]
    shifts = (torch.arange(cpb, device=packed.device) *
              counter_bits).to(torch.uint8)
    mask = (1 << counter_bits) - 1
    values = (packed[:, :, None] >> shifts) & mask
    return values.reshape(packed.shape[0], -1)[:, :tablesize]


def _check_tables(tables, counter_bits, tablesize):
    if tables.dtype != torch.uint8 or tables.dim() != 2 or \
            not tables.is_contiguous():
        raise ValueError('tables must be a contiguous 2-D uint8 tensor, got '
                         '{} {}'.format(tables.dtype, tuple(tables.shape)))
    if counter_bits not in COUNTERS_PER_BYTE:
        raise ValueError('counter_bits must be 1, 4 or 8')
    if not 1 <= tablesize < (1 << 31) or \
            tables.shape[1] != packed_width(tablesize, counter_bits):
        raise ValueError('{} bytes per row do not hold {} buckets at {} '
                         'bits'.format(tables.shape[1], tablesize,
                                       counter_bits))


def gather_counts(tables, h1, h2, counter_bits, tablesize):
    """Min-over-tables count of each (h1, h2) pair: uint8 [N].

    ``tables`` [T, W] uint8 in the persistent layout; ``h1``/``h2`` [N]
    int32 holding uint32 bits, on the tables' device.  A CUDA tensor
    launches K2, a CPU tensor runs :func:`gather_counts_plain`."""
    _check_tables(tables, counter_bits, tablesize)
    for name, x in (('h1', h1), ('h2', h2)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError('{} must be a contiguous 1-D int32 tensor'
                             .format(name))
        if x.device != tables.device:
            raise ValueError('{} is on {}, tables on {}'.format(
                name, x.device, tables.device))
    if h1.shape != h2.shape:
        raise ValueError('h1 and h2 differ in shape')
    kind = tables.device.type
    if kind == 'cuda':
        return kmer_cuda.gather_counts_cuda(tables, h1, h2, counter_bits,
                                            tablesize)
    if kind == 'cpu':
        return gather_counts_plain(tables, h1, h2, counter_bits, tablesize)
    raise ValueError('no gather engine for device ' + str(tables.device))


def gather_counts_plain(tables, h1, h2, counter_bits, tablesize):
    """Plain PyTorch version of the K2 kernel, on any device."""
    a = hashing.to_u32(h1)
    b = hashing.to_u32(h2)
    counts = None
    for t in range(tables.shape[0]):
        idx = hashing.table_index(a, b, t, tablesize)
        if counter_bits == 8:
            c = tables[t][idx]
        elif counter_bits == 4:
            c = (tables[t][idx >> 1] >> ((idx & 1) << 2).to(torch.uint8)) \
                & 0xF
        else:
            c = (tables[t][idx >> 3] >> (idx & 7).to(torch.uint8)) & 1
        counts = c if counts is None else torch.minimum(counts, c)
    return counts


def scatter_add(acc, idx):
    """``acc[t, j] += 1`` for every ``j = idx[t, n]`` in ``[0, C)``; any
    other index (-1 by convention) is skipped.  ``acc`` [T, C] int32 is
    updated in place and returned; ``idx`` [T, N] int32 on its device.  A
    CUDA tensor launches K3, a CPU tensor runs :func:`scatter_add_plain`."""
    if acc.dtype != torch.int32 or acc.dim() != 2 or \
            not acc.is_contiguous():
        raise ValueError('acc must be a contiguous 2-D int32 tensor')
    if idx.dtype != torch.int32 or idx.dim() != 2 or \
            not idx.is_contiguous():
        raise ValueError('idx must be a contiguous 2-D int32 tensor')
    if idx.shape[0] != acc.shape[0]:
        raise ValueError('idx has {} tables, acc {}'.format(
            idx.shape[0], acc.shape[0]))
    if idx.device != acc.device:
        raise ValueError('idx is on {}, acc on {}'.format(idx.device,
                                                          acc.device))
    kind = acc.device.type
    if kind == 'cuda':
        return kmer_cuda.scatter_add_cuda(acc, idx)
    if kind == 'cpu':
        return scatter_add_plain(acc, idx)
    raise ValueError('no scatter engine for device ' + str(acc.device))


def scatter_add_plain(acc, idx):
    """Plain PyTorch version of the K3 kernel, on any device."""
    C = acc.shape[1]
    for t in range(acc.shape[0]):
        j = idx[t]
        j = j[(j >= 0) & (j < C)].to(torch.int64)
        acc[t].index_add_(0, j, torch.ones_like(j, dtype=torch.int32))
    return acc


class Accumulator:
    """The int32 accumulator of one consume: the tables' counters unpacked
    to ``[T, tablesize]`` bucket order, with the count of windows
    scattered since its last saturation (an upper bound on any counter's
    growth), so that no counter can wrap."""

    def __init__(self, tables, counter_bits, tablesize):
        self.counter_bits = counter_bits
        self.tablesize = tablesize
        self.acc = unpack_rows(tables, counter_bits, tablesize).to(
            torch.int32)
        self._since_saturation = 0

    def add(self, idx):
        if self._since_saturation + idx.shape[1] > _I32_HEADROOM:
            self.acc.clamp_(max=MAXCOUNT[self.counter_bits])
            self._since_saturation = 0
        scatter_add(self.acc, idx)
        self._since_saturation += idx.shape[1]

    def tables(self):
        """Close the consume: saturate at the counter width's maximum and
        pack to the persistent layout."""
        sat = self.acc.clamp(max=MAXCOUNT[self.counter_bits]).to(
            torch.uint8)
        return pack_rows(sat, self.counter_bits)


def consume_packed(accumulator, packed, badmask, L, ksize, numbands=None, band=None, mask=None, mask_threshold=0,
                   consume_masked=False):
    """Count every k-mer of a wire-format batch into ``accumulator``.

    Banding keeps k-mers whose primary hash falls in the band, ``h1 &
    (numbands-1) == band`` (0-based band).  ``mask`` is ``(tables,
    counter_bits, tablesize)`` of a mask sketch on the same device: k-mers
    whose mask count is ``<= mask_threshold`` are kept, or ``>=`` with
    ``consume_masked``.
    """
    h1, h2, valid = hashing.kmer_hashes_packed(packed, badmask, L, ksize)
    h1, h2, valid = h1.reshape(-1), h2.reshape(-1), valid.reshape(-1) != 0
    a = hashing.to_u32(h1)
    b = hashing.to_u32(h2)
    if numbands:
        valid = valid & ((a & (numbands - 1)) == band)
    if mask is not None:
        mcnt = gather_counts(mask[0], h1, h2, mask[1], mask[2])
        if consume_masked:
            valid = valid & (mcnt >= mask_threshold)
        else:
            valid = valid & (mcnt <= mask_threshold)
    tablesize = accumulator.tablesize
    idx = torch.stack([hashing.table_index(a, b, t, tablesize)
                       for t in range(accumulator.acc.shape[0])])
    idx = torch.where(valid, idx, -1).to(torch.int32)
    accumulator.add(idx)


def occupancy(tables, counter_bits, tablesize):
    """Occupied buckets in table 0 (khmer-style ``n_occupied``), counting
    only the ``tablesize`` real buckets of a packed row."""
    row = unpack_rows(tables[:1], counter_bits, tablesize)
    return int(torch.count_nonzero(row))
