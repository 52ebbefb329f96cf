"""Count-Min sketch operations over device tensors: the consume, the count
gather and occupancy, with the dispatch to their CUDA kernels.

Counterpart of ``kevlar_tpu/ops/sketch_ops.py`` (B3, B4) and of the B10
scatter (``tools/scatter_probe.py``).  The sketch is a ``uint8 [ntables,
width]`` tensor in the persistent layout: ``counter_bits`` of 1, 4 or 8,
bit-packed LSB-first in bucket order (bucket i in bits ``[bits*(i % cpb),
...)`` of byte ``i // cpb``), the layout ``kevlar_tpu`` saves.  Counters
saturate at 1, 15 or 255.

A consume (:func:`consume_codes`) hashes a batch of base codes (K1), gets
the mask's counts where there is a mask (K2), and hands hashes, validity
and mask counts to :func:`consume_hashes` (K3), which drops k-mers outside
the band and those the mask screens out, computes each table's bucket index
and adds 1 per (table, kept k-mer) into an int32 accumulator: one kernel on
a card, :func:`consume_hashes_plain` (int64 index arithmetic, then
:func:`scatter_add_plain`) on the CPU.  :func:`mark_hashes` is the same
kernel writing 1 into 8-bit tables instead (a presence sketch).
:func:`scatter_add` is K3's other entry, from given indices, where -1 means
skip; :func:`scatter_add_parts` is the same kernel over the bins an owner
of a routed consume receives, each read up to its population where it
lies.  The :class:`Accumulator` is bucket-ordered (``[ntables,
tablesize]``): the planar layout of the JAX package exists for the TPU's
tiling and is not carried over.  It lives for one consume (a
``consume_seqfile`` call, a ``Sketch.consuming()`` block), unpacked from
the tables at its start and saturated and packed back at its end.
Saturating once at the end gives the same counts as saturating per
increment, because the adds are monotone.

The gather and the consume also work on one range of buckets ``[lo, lo +
span)`` of a hash space of ``total``, the shard of a
:class:`kevlar_tpu_torch.parallel.ShardedSketch`: the gather reads 255
outside it, the consume adds only inside it.  :func:`route` bins hashed
k-mers by the shard that owns their bucket, each bin in k-mer order, for a
sharded sketch's routed consume.

:func:`pack_sample_tables` interleaves S samples' 8-bit tables four to a
word, and :func:`gather_counts_words` gathers every sample's count from
those words, one 4-byte load for four samples (the screen of
:func:`kevlar_tpu_torch.ops.novel_ops.count_and_screen_stack_packed`).

Dispatch: on CUDA tensors :func:`gather_counts_multi`,
:func:`gather_counts_words`,
:func:`consume_hashes`, :func:`mark_hashes`, :func:`scatter_add`,
:func:`scatter_add_parts` and :func:`route` launch their kernels; on CPU
tensors they run the plain versions beside them.  No path falls back from
one to the other.
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


def _bucket_range(sample):
    """``(tables, counter_bits, total, lo, span)`` of a gather sample:
    ``(tables, counter_bits, tablesize)`` holds the whole hash space."""
    if len(sample) == 5:
        return tuple(sample)
    tables, counter_bits, tablesize = sample
    return tables, counter_bits, tablesize, 0, tablesize


def _check_tables(tables, counter_bits, total, lo=0, span=None):
    if span is None:
        span = total
    if tables.dtype != torch.uint8 or tables.dim() != 2 or \
            not tables.is_contiguous():
        raise ValueError('tables must be a contiguous 2-D uint8 tensor, got '
                         '{} {}'.format(tables.dtype, tuple(tables.shape)))
    if counter_bits not in COUNTERS_PER_BYTE:
        raise ValueError('counter_bits must be 1, 4 or 8')
    if not 1 <= total < (1 << 31) or not 0 <= lo < (1 << 31) or \
            not 1 <= span < (1 << 31):
        raise ValueError('a hash space of {} buckets, range [{}, {} + {}): '
                         'out of [1, 2^31)'.format(total, lo, lo, span))
    if tables.shape[1] != packed_width(span, counter_bits):
        raise ValueError('{} bytes per row do not hold {} buckets at {} '
                         'bits'.format(tables.shape[1], span, counter_bits))


def gather_counts_multi(samples, h1, h2):
    """Min-over-tables count of each (h1, h2) pair in each sketch: uint8
    [S, N].

    ``samples`` are ``(tables, counter_bits, tablesize)`` triples, tables
    [T, W] uint8 in the persistent layout, or ``(tables, counter_bits,
    total, lo, span)``: rows that hold the buckets ``[lo, lo + span)`` of a
    hash space of ``total``, where a bucket outside them counts 255.
    ``h1``/``h2`` [N] int32 holding uint32 bits, on the tables' device.
    CUDA tensors launch K2 once for all sketches, CPU tensors run
    :func:`gather_counts_multi_plain`."""
    if not samples:
        raise ValueError('no sketch to gather from')
    for name, x in (('h1', h1), ('h2', h2)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError('{} must be a contiguous 1-D int32 tensor'
                             .format(name))
    if h1.shape != h2.shape or h1.device != h2.device:
        raise ValueError('h1 and h2 differ in shape or device')
    for sample in samples:
        tables = sample[0]
        _check_tables(*_bucket_range(sample))
        if tables.device != h1.device:
            raise ValueError('h1 is on {}, tables on {}'.format(
                h1.device, tables.device))
    kind = h1.device.type
    if kind == 'cuda':
        return kmer_cuda.gather_counts_cuda(samples, h1, h2)
    if kind == 'cpu':
        return gather_counts_multi_plain(samples, h1, h2)
    raise ValueError('no gather engine for device ' + str(h1.device))


def gather_counts(tables, h1, h2, counter_bits, tablesize):
    """:func:`gather_counts_multi` of one sketch: uint8 [N]."""
    return gather_counts_multi([(tables, counter_bits, tablesize)], h1,
                               h2)[0]


def gather_counts_multi_plain(samples, h1, h2):
    """Plain PyTorch version of the K2 kernel, on any device."""
    counts = []
    for sample in samples:
        tables, bits, total, lo, span = _bucket_range(sample)
        counts.append(gather_counts_plain(tables, h1, h2, bits, total, lo,
                                          span))
    return torch.stack(counts)


def gather_counts_plain(tables, h1, h2, counter_bits, tablesize, lo=0,
                        span=None):
    """One sketch of :func:`gather_counts_multi_plain`: uint8 [N]
    (``tablesize`` is the hash space; the rows hold ``[lo, lo + span)``)."""
    if span is None:
        span = tablesize
    a = hashing.to_u32(h1)
    b = hashing.to_u32(h2)
    counts = None
    for t in range(tables.shape[0]):
        idx = hashing.table_index(a, b, t, tablesize) - lo
        own = (idx >= 0) & (idx < span)
        idx = torch.where(own, idx, 0)
        if counter_bits == 8:
            c = tables[t][idx]
        elif counter_bits == 4:
            c = (tables[t][idx >> 1] >> ((idx & 1) << 2).to(torch.uint8)) \
                & 0xF
        else:
            c = (tables[t][idx >> 3] >> (idx & 7).to(torch.uint8)) & 1
        c = torch.where(own, c, 255)
        counts = c if counts is None else torch.minimum(counts, c)
    return counts


def pack_sample_tables(tables_list):
    """Interleave S samples' uint8 ``[ntables, tablesize]`` tables (8-bit
    counters, one shape, one device) into ``ceil(S/4)`` word tensors:
    byte ``s % 4`` of word tensor ``s // 4`` at bucket ``(t, i)`` is sample
    s's counter there (0 where a last word has fewer than four samples).
    Counterpart of ``kevlar_tpu.ops.sketch_ops.pack_sample_tables``; the
    words are uint32 values held in int32 tensors, as the port holds the
    uint32 hashes.  Built on the tables' device, four samples a byte
    column of a ``[ntables, tablesize, 4]`` uint8 tensor viewed as int32
    (byte j is the word's bits ``8j .. 8j+7`` on a little-endian machine,
    which the CPU and the card both are)."""
    if not tables_list:
        raise ValueError('no tables to pack')
    first = tables_list[0]
    for tables in tables_list:
        if tables.dtype != torch.uint8 or tables.dim() != 2 or \
                tables.shape != first.shape or tables.device != first.device:
            raise ValueError('the tables to pack must be uint8 [ntables, '
                             'tablesize] tensors of one shape and device')
    words = []
    for w in range(0, len(tables_list), 4):
        group = torch.zeros(tuple(first.shape) + (4,), dtype=torch.uint8,
                            device=first.device)
        for j, tables in enumerate(tables_list[w:w + 4]):
            group[..., j] = tables
        words.append(group.view(torch.int32).reshape(first.shape))
    return tuple(words)


def gather_counts_words(words, nsamples, h1, h2):
    """Min-over-tables count of each (h1, h2) pair in each of ``nsamples``
    samples packed into ``words`` (:func:`pack_sample_tables`): uint8 [S,
    N].  Counterpart of ``kevlar_tpu.ops.sketch_ops.gather_counts_multi``
    over packed words (``:105``); the port's :func:`gather_counts_multi`
    takes sketches as they lie.  ``h1``/``h2`` [N] int32 holding uint32
    bits, on the words' device.  CUDA tensors launch ``kt_gather_words``,
    CPU tensors run :func:`gather_counts_words_plain`."""
    if not words or len(words) != -(-nsamples // 4):
        raise ValueError('{} samples need {} word tensors, got {}'.format(
            nsamples, -(-nsamples // 4), len(words)))
    for w in words:
        if w.dtype != torch.int32 or w.dim() != 2 or \
                not w.is_contiguous() or w.shape != words[0].shape or \
                w.device != h1.device:
            raise ValueError('word tensors must be contiguous int32 [ntables, '
                             'tablesize] tensors of one shape, on h1\'s '
                             'device')
    if not 1 <= words[0].shape[1] < (1 << 31):
        raise ValueError('tablesize must be in [1, 2^31)')
    for name, x in (('h1', h1), ('h2', h2)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError('{} must be a contiguous 1-D int32 tensor'
                             .format(name))
    if h1.shape != h2.shape or h1.device != h2.device:
        raise ValueError('h1 and h2 differ in shape or device')
    kind = h1.device.type
    if kind == 'cuda':
        return kmer_cuda.gather_words_cuda(words, nsamples, h1, h2)
    if kind == 'cpu':
        return gather_counts_words_plain(words, nsamples, h1, h2)
    raise ValueError('no gather engine for device ' + str(h1.device))


def gather_counts_words_plain(words, nsamples, h1, h2):
    """Plain PyTorch version of ``kt_gather_words``, on any device: per
    table ``torch.take`` of the words at its bucket index, then each
    sample's byte and the minimum over the tables."""
    a = hashing.to_u32(h1)
    b = hashing.to_u32(h2)
    ntables, tablesize = words[0].shape
    idx = [hashing.table_index(a, b, t, tablesize) for t in range(ntables)]
    counts = []
    for w, packed in enumerate(words):
        gathered = torch.stack([torch.take(packed[t], idx[t])
                                for t in range(ntables)])
        for s in range(4 * w, min(4 * w + 4, nsamples)):
            byte = (gathered >> (8 * (s % 4))) & 0xFF
            counts.append(byte.amin(dim=0).to(torch.uint8))
    return torch.stack(counts)


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


def scatter_add_parts(acc, parts, pops):
    """``acc[t, j] += 1`` for every ``j`` in the filled prefix of row t of
    every part: ``parts[k]`` [T, C_k] int32 (its rows at any stride, its
    columns contiguous) holds ``min(pops[k][t], C_k)`` indices in row t,
    ``pops[k]`` [T] int32 at any stride; the rest of a row is never read.
    An index outside ``[0, acc.shape[1])`` is skipped.  These are the bins
    an owner of a routed consume receives, where they lie
    (:func:`kevlar_tpu_torch.parallel.collectives.all_to_all_parts`), with
    their populations (:func:`route`).  ``acc`` [T, span] int32 is updated
    in place and returned.  CUDA tensors launch K3 (``kt_scatter_add``),
    CPU tensors run :func:`scatter_add_parts_plain`."""
    if acc.dtype != torch.int32 or acc.dim() != 2 or \
            not acc.is_contiguous():
        raise ValueError('acc must be a contiguous 2-D int32 tensor')
    if len(parts) != len(pops):
        raise ValueError('{} parts, {} populations'.format(len(parts),
                                                         len(pops)))
    for part, pop in zip(parts, pops):
        if part.dtype != torch.int32 or part.dim() != 2 or \
                part.shape[0] != acc.shape[0] or \
                (part.shape[1] > 1 and part.stride(1) != 1):
            raise ValueError('a part must be a [T, C] int32 tensor with '
                             'contiguous rows')
        if pop.dtype != torch.int32 or tuple(pop.shape) != (acc.shape[0],):
            raise ValueError('a population must be a [T] int32 tensor')
        if part.device != acc.device or pop.device != acc.device:
            raise ValueError('a part or population is on another device '
                             'than acc ({})'.format(acc.device))
    kind = acc.device.type
    if kind == 'cuda':
        return kmer_cuda.scatter_add_parts_cuda(acc, parts, pops)
    if kind == 'cpu':
        return scatter_add_parts_plain(acc, parts, pops)
    raise ValueError('no scatter engine for device ' + str(acc.device))


def scatter_add_parts_plain(acc, parts, pops):
    """Plain PyTorch version of K3 over received bins, on any device: per
    part and table, ``index_add_`` of its filled prefix."""
    C = acc.shape[1]
    for part, pop in zip(parts, pops):
        for t in range(acc.shape[0]):
            j = part[t, :max(0, min(int(pop[t]), part.shape[1]))]
            j = j[(j >= 0) & (j < C)].to(torch.int64)
            acc[t].index_add_(0, j, torch.ones_like(j, dtype=torch.int32))
    return acc


def _check_consume(target, dtype, h1, h2, valid, mcnt, nkept=None,
                   total=None, lo=0):
    """The checks a consume and a mark share: ``target`` [T, span] of
    ``dtype`` (the buckets ``[lo, lo + span)`` of a hash space of
    ``total``), the hashed k-mers' vectors alike in shape, all on its
    device."""
    if target.dtype != dtype or target.dim() != 2 or \
            not target.is_contiguous():
        raise ValueError('the counters must be a contiguous 2-D {} tensor, '
                         'got {} {}'.format(dtype, target.dtype,
                                            tuple(target.shape)))
    if not 1 <= target.shape[1] < (1 << 31):
        raise ValueError('tablesize must be in [1, 2^31)')
    if total is not None and not (1 <= total < (1 << 31) and
                                  0 <= lo < (1 << 31)):
        raise ValueError('a hash space of {} buckets from {}: out of [1, '
                         '2^31)'.format(total, lo))
    for name, x, want in (('h1', h1, torch.int32), ('h2', h2, torch.int32),
                          ('valid', valid, torch.uint8),
                          ('mcnt', mcnt, torch.uint8)):
        if x is None and name == 'mcnt':
            continue
        if x.dtype != want or x.dim() != 1 or not x.is_contiguous():
            raise ValueError('{} must be a contiguous 1-D {} tensor'.format(
                name, want))
        if x.shape != h1.shape or x.device != target.device:
            raise ValueError('{} differs from h1 in shape, or from the '
                             'counters in device'.format(name))
    if nkept is not None and (nkept.dtype != torch.int64 or
                              nkept.numel() != 1 or
                              nkept.device != target.device):
        raise ValueError('nkept must be one int64 on the counters\' device')
    kind = target.device.type
    if kind not in ('cuda', 'cpu'):
        raise ValueError('no consume engine for device ' +
                         str(target.device))
    return kind


def consume_hashes(acc, h1, h2, valid, mcnt=None, mask_threshold=0,
                   consume_masked=False, numbands=None, band=None,
                   nkept=None, total=None, lo=0):
    """Count hashed k-mers into ``acc`` [T, tablesize] int32, in place:
    every k-mer n with ``valid[n] != 0``, inside the band (``h1 &
    (numbands-1) == band``, where ``numbands`` is given) and passing the
    mask (``mcnt[n] <= mask_threshold``, or ``>=`` with ``consume_masked``,
    where ``mcnt`` is given) adds 1 at bucket ``(h1 + t*h2) mod 2^32 mod
    tablesize`` of every table t.  The number of k-mers so counted is added
    to ``nkept``, one int64 on the device, where given.  With ``total``,
    ``acc`` holds the buckets ``[lo, lo + acc.shape[1])`` of a hash space
    of ``total`` (a shard's): the modulus is ``total`` and a bucket outside
    the range is not counted.

    ``h1``/``h2`` [N] int32 holding uint32 bits, ``valid`` and ``mcnt`` [N]
    uint8, all on ``acc``'s device.  CUDA tensors launch K3
    (``kt_consume``), CPU tensors run :func:`consume_hashes_plain`."""
    kind = _check_consume(acc, torch.int32, h1, h2, valid, mcnt, nkept,
                          total, lo)
    engine = kmer_cuda.consume_cuda if kind == 'cuda' else \
        consume_hashes_plain
    return engine(acc, h1, h2, valid, mcnt, mask_threshold, consume_masked,
                  numbands, band, nkept, total, lo)


def mark_hashes(tables, h1, h2, valid, mcnt=None, mask_threshold=0,
                consume_masked=False, numbands=None, band=None):
    """Mark hashed k-mers present in ``tables`` [T, tablesize] uint8 (8-bit
    counters in the persistent layout), in place: the k-mers
    :func:`consume_hashes` would count set their bucket of every table to
    1.  For a presence sketch that is read (by K2) between the batches
    that fill it: nothing to unpack or pack, and it stays 0 or 1 however
    often a k-mer comes.  CUDA tensors launch K3's kernel in mark mode, CPU
    tensors run :func:`mark_hashes_plain`."""
    kind = _check_consume(tables, torch.uint8, h1, h2, valid, mcnt)
    engine = kmer_cuda.mark_cuda if kind == 'cuda' else mark_hashes_plain
    return engine(tables, h1, h2, valid, mcnt, mask_threshold,
                  consume_masked, numbands, band)


def _kept_indices(ntables, tablesize, h1, h2, valid, mcnt, mask_threshold,
                  consume_masked, numbands, band, lo=0):
    """Plain PyTorch: bool [N], the k-mers a consume counts (valid, inside
    the band, passing the mask), and int32 [T, N], their bucket index in
    each table (hash space ``tablesize``) less ``lo``, with -1 at the
    others; int64 tensors hold the uint32 arithmetic."""
    keep = valid != 0
    if numbands:
        keep = keep & ((hashing.to_u32(h1) & (numbands - 1)) == band)
    if mcnt is not None:
        if consume_masked:
            keep = keep & (mcnt >= mask_threshold)
        else:
            keep = keep & (mcnt <= mask_threshold)
    a = hashing.to_u32(h1)
    b = hashing.to_u32(h2)
    idx = torch.stack([hashing.table_index(a, b, t, tablesize) - lo
                       for t in range(ntables)])
    return keep, torch.where(keep, idx, -1).to(torch.int32)


def consume_hashes_plain(acc, h1, h2, valid, mcnt=None, mask_threshold=0,
                         consume_masked=False, numbands=None, band=None,
                         nkept=None, total=None, lo=0):
    """Plain PyTorch version of K3's consume entry, on any device: the
    predicates and the bucket indices, then :func:`scatter_add_plain`
    (which skips the indices outside the range)."""
    keep, idx = _kept_indices(acc.shape[0], total or acc.shape[1], h1, h2,
                              valid, mcnt, mask_threshold, consume_masked,
                              numbands, band, lo)
    if nkept is not None:
        nkept += keep.sum()
    return scatter_add_plain(acc, idx)


def mark_hashes_plain(tables, h1, h2, valid, mcnt=None, mask_threshold=0,
                      consume_masked=False, numbands=None, band=None):
    """Plain PyTorch version of K3's kernel in mark mode, on any device."""
    keep, idx = _kept_indices(tables.shape[0], tables.shape[1], h1, h2,
                              valid, mcnt, mask_threshold, consume_masked,
                              numbands, band)
    for t in range(tables.shape[0]):
        tables[t][idx[t][keep].to(torch.int64)] = 1
    return tables


def route(h1, h2, valid, ntables, nshards, shard_size, total, capacity):
    """Bin hashed k-mers by the shard that owns their buckets: for every
    k-mer with ``valid != 0`` and every table t, bucket ``g = (h1 + t*h2)
    mod 2^32 mod total`` goes to bin ``(t, g // shard_size)`` as ``g %
    shard_size``.  Returns ``send`` [ntables, nshards, capacity] int32, each
    bin's first ``min(population, capacity)`` slots filled with its k-mers
    in k-mer order (``kevlar_tpu``'s block cumsum order: an overflowing bin
    keeps its first ``capacity`` k-mers), and the bins' populations
    [ntables, nshards] int32, slots beyond ``capacity`` included.  The
    other slots are undefined (the kernel does not write them; the plain
    version leaves ``shard_size``): read a bin only up to its population.

    ``h1``/``h2`` [N] int32 holding uint32 bits, ``valid`` [N] uint8, on one
    device.  CUDA tensors launch ``kt_route``, CPU tensors run
    :func:`route_plain`."""
    for name, x, want in (('h1', h1, torch.int32), ('h2', h2, torch.int32),
                          ('valid', valid, torch.uint8)):
        if x.dtype != want or x.dim() != 1 or not x.is_contiguous():
            raise ValueError('{} must be a contiguous 1-D {} tensor'.format(
                name, want))
        if x.shape != h1.shape or x.device != h1.device:
            raise ValueError('{} differs from h1 in shape or device'.format(
                name))
    if not (1 <= total < (1 << 31) and 1 <= shard_size < (1 << 31) and
            total <= nshards * shard_size and capacity >= 1 and
            1 <= ntables <= 16 and ntables * nshards <= 4096):
        raise ValueError('cannot route {} tables of {} buckets to {} shards '
                         'of {} (capacity {})'.format(
                             ntables, total, nshards, shard_size, capacity))
    kind = h1.device.type
    if kind == 'cuda':
        return kmer_cuda.route_cuda(h1, h2, valid, ntables, nshards,
                                    shard_size, total, capacity)
    if kind == 'cpu':
        return route_plain(h1, h2, valid, ntables, nshards, shard_size,
                           total, capacity)
    raise ValueError('no routing engine for device ' + str(h1.device))


def route_plain(h1, h2, valid, ntables, nshards, shard_size, total,
                capacity):
    """Plain PyTorch version of ``kt_route``, on any device: a stable sort
    by owner gives every kept k-mer its rank in its bin, in k-mer order;
    unfilled slots hold ``shard_size``."""
    dev = h1.device
    keep = valid != 0
    a = hashing.to_u32(h1)[keep]
    b = hashing.to_u32(h2)[keep]
    send = torch.full((ntables, nshards, capacity), shard_size,
                      dtype=torch.int32, device=dev)
    pop = torch.zeros((ntables, nshards), dtype=torch.int32, device=dev)
    for t in range(ntables):
        g = hashing.table_index(a, b, t, total)
        owner = g // shard_size
        order = torch.sort(owner, stable=True).indices
        owner = owner[order]
        counts = torch.bincount(owner, minlength=nshards)
        rank = torch.arange(owner.numel(), device=dev) - \
            (torch.cumsum(counts, 0) - counts)[owner]
        slot = rank < capacity
        send[t, owner[slot], rank[slot]] = \
            (g[order][slot] % shard_size).to(torch.int32)
        pop[t] = counts.to(torch.int32)
    return send, pop


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

    def _make_room(self, n):
        """Saturate first if ``n`` more windows could wrap a counter."""
        if self._since_saturation + n > _I32_HEADROOM:
            self.acc.clamp_(max=MAXCOUNT[self.counter_bits])
            self._since_saturation = 0
        self._since_saturation += n

    def add(self, h1, h2, valid, **predicates):
        """:func:`consume_hashes` of N hashed windows into the accumulator
        (``predicates``: its mask and band arguments)."""
        self._make_room(h1.numel())
        consume_hashes(self.acc, h1, h2, valid, **predicates)

    def add_indices(self, idx):
        """:func:`scatter_add` of given bucket indices [T, N] (-1 skips)."""
        self._make_room(idx.shape[1])
        scatter_add(self.acc, idx)

    def tables(self, maxcount=None):
        """Close the consume: saturate at ``maxcount`` (default and at most
        the counter width's maximum) and pack to the persistent layout."""
        top = MAXCOUNT[self.counter_bits]
        if maxcount is not None:
            top = min(top, maxcount)
        sat = self.acc.clamp(max=top).to(torch.uint8)
        return pack_rows(sat, self.counter_bits)


def consume_codes(accumulator, codes, ksize, numbands=None, band=None,
                  mask=None, mask_threshold=0, consume_masked=False,
                  nkept=None):
    """Count every k-mer of a batch of base codes (uint8 [N, L], >= 4
    invalid) into ``accumulator``.

    Banding keeps k-mers whose primary hash falls in the band, ``h1 &
    (numbands-1) == band`` (0-based band).  ``mask`` is ``(tables,
    counter_bits, tablesize)`` of a mask sketch on the same device: k-mers
    whose mask count is ``<= mask_threshold`` are kept, or ``>=`` with
    ``consume_masked``.  ``nkept`` as for :func:`consume_hashes`.
    """
    h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
    h1, h2, valid = h1.reshape(-1), h2.reshape(-1), valid.reshape(-1)
    mcnt = None
    if mask is not None:
        mcnt = gather_counts(mask[0], h1, h2, mask[1], mask[2])
    accumulator.add(h1, h2, valid, mcnt=mcnt, mask_threshold=mask_threshold,
                    consume_masked=consume_masked, numbands=numbands,
                    band=band, nkept=nkept)


def consume_batch(accumulator, codes, ksize, **predicates):
    """:func:`consume_codes` of one ``[B, L]`` batch, returning the number
    of k-mers it counted as a 0-d int64 tensor on the batch's device (no
    host sync; ``int()`` it only when needed): the consume itself counts
    them.  Counterpart of ``kevlar_tpu.ops.sketch_ops.consume_batch``, over
    an open :class:`Accumulator` instead of donated tables."""
    nkept = torch.zeros(1, dtype=torch.int64, device=codes.device)
    consume_codes(accumulator, codes, ksize, nkept=nkept, **predicates)
    return nkept[0]


def consume_batch_stack(accumulator, codes_stack, ksize, **predicates):
    """Count a ``[NB, B, L]`` stack of batches (counterpart of
    ``kevlar_tpu.ops.sketch_ops.consume_batch_stack``, whose scan over the
    leading axis is a loop of :func:`consume_codes` here)."""
    for codes in codes_stack:
        consume_codes(accumulator, codes, ksize, **predicates)


def query_batch(tables, codes, ksize, counter_bits, tablesize):
    """Counts for every k-mer of a ``[B, L]`` batch of base codes: uint8
    ``[B, P]`` counts (0 where the window is invalid) and uint8 validity.
    K1, then K2 (counterpart of ``kevlar_tpu.ops.sketch_ops.query_batch``).
    """
    h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
    counts = gather_counts(tables, h1.reshape(-1), h2.reshape(-1),
                           counter_bits, tablesize).reshape(valid.shape)
    return counts * valid, valid


def occupancy(tables, counter_bits, tablesize):
    """Occupied buckets in table 0 (khmer-style ``n_occupied``), counting
    only the ``tablesize`` real buckets of a packed row."""
    row = unpack_rows(tables[:1], counter_bits, tablesize)
    return int(torch.count_nonzero(row))
