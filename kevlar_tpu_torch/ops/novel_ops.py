"""The novel-k-mer screen over device tensors.

Counterparts of ``kevlar_tpu/ops/novel_ops.py``'s screens (B5).
:func:`novel_screen_compact` is ``novel_screen_compact(..., packed=...)``
(``:111``): a read batch's K1 hashes screened against every sample's
8-bit tables packed four to a word (:func:`sketch_ops.pack_sample_tables`)
and its hits compacted, ascending, to a fixed capacity.  On a card that is
two kernels of ``csrc/kmer.cu``: ``kt_screen_words`` gathers the words and
tests the predicates where it gathers, each block storing its hits in flat
order into its own segment of a scratch, and ``kt_compact_hits`` copies
the segments' hits to their global ranks.  The novel stage takes it where
every sample is an 8-bit device sketch of one shape (as JAX's
``_pack_or_none`` packs), and re-screens a batch of more hits than the
capacity through :func:`novel_screen`, uncapped.

:func:`novel_screen` hashes a batch's base codes (K1), gathers every
sample's min-of-tables count (K2 on the sketches as they lie, or the word
gather on packed words), evaluates the casemin/ctrlmax predicate and
compacts the hits with ``torch.nonzero``, ascending like ``jnp.nonzero``,
with no cap; the predicates and compactions are plain torch, shared by
both devices.

:func:`count_and_screen_stack_packed` is the whole count and screen of
``kevlar_tpu`` as one program (B.1): every sample's 2-bit packed read stack
counted (K1, ``kt_consume``), the tables packed four samples to a word, the
case stack screened and compacted (K1, :func:`novel_screen_compact`), with
no host synchronisation from the first batch to the last.
"""

import torch

from kevlar_tpu_torch.ops import hashing, kmer_cuda, sketch_ops


def novel_screen(samples, ncase, codes, lengths, ksize, casemin, ctrlmax,
                 screen=None, numbands=None, band=None, words=None):
    """Screen a read batch for novel (interesting) k-mers.

    ``samples`` are the case sketches then the control sketches, as
    ``(tables, counter_bits, tablesize)`` on the batch's device (``ncase``
    of them cases); ``codes`` [B, L] uint8 base codes (>= 4 invalid) and
    ``lengths`` [B] int32 (0 for padding rows).

    Returns ``(hits, hit_abunds, discard)``:

    - hits : int64 [H] — flat ``b*P + p`` indices of the interesting
      k-mers, ascending (P = L - ksize + 1): every case count >= casemin,
      every control count <= ctrlmax, the window valid and in the band, and
      the read not skipped (a non-ACGT base within its length, or shorter
      than k);
    - hit_abunds : uint8 [S, H] — each sample's count at each hit;
    - discard : bool [B] — with ``screen``, reads whose first failing case
      abundance (in case order) falls below ``screen`` at some valid
      window, as the reference's short-circuit discards them.

    With ``words`` (:func:`sketch_ops.pack_sample_tables` of the samples'
    tables) the counts come from the word gather, as JAX gathers them from
    its packed words.
    """
    B, L = codes.shape
    h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
    valid = valid != 0
    P = h1.shape[1]
    if numbands:
        valid = valid & ((hashing.to_u32(h1) & (numbands - 1)) == band)
    if words is None:
        counts = sketch_ops.gather_counts_multi(
            list(samples), h1.reshape(-1), h2.reshape(-1))
    else:
        counts = sketch_ops.gather_counts_words(
            words, len(samples), h1.reshape(-1), h2.reshape(-1))
    counts = counts.reshape(len(samples), B, P)
    interesting, discard, _ = screen_predicates(
        counts, ncase, valid, codes, lengths, ksize, casemin, ctrlmax,
        screen)
    hits, hit_abunds = compact_hits(counts, interesting)
    return hits, hit_abunds, discard


def compact_hits(counts, interesting):
    """``(hits, hit_abunds)`` of :func:`novel_screen` from the gathered
    ``counts`` uint8 [S, B, P] and ``interesting`` bool [B, P], on their
    device."""
    hits = torch.nonzero(interesting.reshape(-1)).reshape(-1)
    return hits, counts.reshape(counts.shape[0], -1)[:, hits]


def compact_hits_capped(counts, interesting, max_hits):
    """Fixed-capacity compaction with no host synchronisation (JAX's
    ``jnp.nonzero(..., size=max_hits, fill_value=-1)``): returns
    ``hit_idx`` int32 [max_hits], the first ``max_hits`` flat indices of
    ``interesting`` [B, P] in ascending order padded with -1; ``hit_abunds``
    uint8 [S, max_hits], ``counts`` [S, B, P] at those indices and 0 at the
    padding; and ``n_hits``, the true number of hits (int32, 0-d; it may
    exceed ``max_hits``).  A hit's rank is a cumulative sum over the flat
    mask; the first ``max_hits`` go to their rank's slot, every other
    index to a slot of its own past the capacity, so that every store is
    to a distinct place."""
    flat = interesting.reshape(-1)
    n = flat.numel()
    dev = flat.device
    rank = torch.cumsum(flat, 0, dtype=torch.int32)
    n_hits = rank[-1] if n else torch.zeros((), dtype=torch.int32,
                                            device=dev)
    index = torch.arange(n, dtype=torch.int32, device=dev)
    slot = torch.where(flat & (rank <= max_hits), rank - 1, max_hits + index)
    buf = torch.full((max_hits + n,), -1, dtype=torch.int32, device=dev)
    buf.scatter_(0, slot.to(torch.int64), index)
    hit_idx = buf[:max_hits]
    abunds = counts.reshape(counts.shape[0], -1)[
        :, hit_idx.clamp(min=0).to(torch.int64)]
    hit_abunds = torch.where(hit_idx >= 0, abunds, 0).to(torch.uint8)
    return hit_idx, hit_abunds, n_hits


# k-mers a screen block takes at most (more only when one row holds more):
# a block owns SCREEN_BLOCK_KMERS // P whole rows
SCREEN_BLOCK_KMERS = 1024
# samples one screen launch serves (four word tensors of four samples)
MAX_SCREEN_SAMPLES = 16


def screen_rows(P):
    """Rows a block of ``kt_screen_words`` owns at ``P`` windows a row:
    its hits' segment of the scratch is ``screen_rows(P) * P`` slots."""
    return max(1, SCREEN_BLOCK_KMERS // P)


def novel_screen_compact(words, nsamples, ncase, h1, h2, valid, codes,
                         lengths, ksize, casemin, ctrlmax, screen=None,
                         numbands=None, band=None, max_hits=32768):
    """Screen a read batch over packed sample words and compact its hits
    to a fixed capacity, with no host synchronisation (counterpart of
    ``kevlar_tpu/ops/novel_ops.py::novel_screen_compact(...,
    packed=...)``, ``:111``).

    ``words`` are :func:`sketch_ops.pack_sample_tables` of the
    ``nsamples`` sample tables (8-bit, one shape), the first ``ncase``
    cases; ``h1``, ``h2``, ``valid`` [B, P] the batch's K1 output
    (:func:`hashing.kmer_hashes_codes` of ``codes`` [B, L] uint8 at
    ``ksize``); ``lengths`` [B] int32 (0 for padding rows); all on one
    device.  A k-mer is a hit as :func:`novel_screen` says.

    Returns ``(hit_idx, hit_abunds, n_hits, discard, skip)``: int32
    [max_hits] flat ``b*P + p`` indices, ascending, padded with -1; uint8
    [S, max_hits] counts, 0 at the padding; int32 0-d, the true number of
    hits (more than ``max_hits`` means the caller must screen again
    uncapped); bool [B] each.  CUDA tensors launch ``kt_screen_words``
    then ``kt_compact_hits``; CPU tensors run
    :func:`novel_screen_compact_plain`."""
    if not words or len(words) != -(-nsamples // 4):
        raise ValueError('{} samples need {} word tensors, got {}'.format(
            nsamples, -(-nsamples // 4), len(words)))
    dev = h1.device
    for w in words:
        if w.dtype != torch.int32 or w.dim() != 2 or \
                not w.is_contiguous() or w.shape != words[0].shape or \
                w.device != dev:
            raise ValueError('word tensors must be contiguous int32 [ntables, '
                             'tablesize] tensors of one shape, on h1\'s '
                             'device')
    if not 1 <= words[0].shape[1] < (1 << 31):
        raise ValueError('tablesize must be in [1, 2^31)')
    if not 1 <= ncase <= nsamples:
        raise ValueError('ncase {} outside [1, {}]'.format(ncase, nsamples))
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError('codes must be a 2-D uint8 tensor')
    B, L = codes.shape
    P = L - ksize + 1
    for name, x, dtype, shape in (('h1', h1, torch.int32, (B, P)),
                                  ('h2', h2, torch.int32, (B, P)),
                                  ('valid', valid, torch.uint8, (B, P)),
                                  ('codes', codes, torch.uint8, (B, L)),
                                  ('lengths', lengths, torch.int32, (B,))):
        if x.dtype != dtype or tuple(x.shape) != shape or \
                not x.is_contiguous() or x.device != dev:
            raise ValueError('{} must be a contiguous {} {} tensor on {}'
                             .format(name, dtype, shape, dev))
    if B * P >= 1 << 31:
        raise ValueError('a batch of {} k-mers exceeds 2^31'.format(B * P))
    for name, x in (('casemin', casemin), ('ctrlmax', ctrlmax),
                    ('screen', 0 if screen is None else screen)):
        if not 0 <= x <= 255:
            raise ValueError('{} {} outside [0, 255]'.format(name, x))
    if max_hits < 1:
        raise ValueError('max_hits must be positive')
    kind = dev.type
    if kind == 'cuda':
        if nsamples > MAX_SCREEN_SAMPLES:
            raise ValueError('{} samples exceed the screen kernel\'s {}'
                             .format(nsamples, MAX_SCREEN_SAMPLES))
        rows = screen_rows(P)
        counts, seg_idx, seg_ab, discard, skip = kmer_cuda.screen_words_cuda(
            words, nsamples, ncase, h1, h2, valid, codes, lengths, ksize,
            casemin, ctrlmax, screen, numbands, band, rows)
        return kmer_cuda.compact_hits_cuda(
            counts, seg_idx, seg_ab, rows * P, max_hits) + (discard, skip)
    if kind == 'cpu':
        return novel_screen_compact_plain(
            words, nsamples, ncase, h1, h2, valid, codes, lengths, ksize,
            casemin, ctrlmax, screen, numbands, band, max_hits)
    raise ValueError('no screen engine for device ' + str(dev))


def _screen_counts(words, nsamples, h1, h2, valid, numbands, band):
    """uint8 [S, B, P] counts from the words and the kept-window mask
    (valid and in the band), bool [B, P]."""
    B, P = h1.shape
    counts = sketch_ops.gather_counts_words_plain(
        words, nsamples, h1.reshape(-1), h2.reshape(-1)).reshape(
            nsamples, B, P)
    valid = valid != 0
    if numbands:
        valid = valid & ((hashing.to_u32(h1) & (numbands - 1)) == band)
    return counts, valid


def novel_screen_compact_plain(words, nsamples, ncase, h1, h2, valid, codes,
                               lengths, ksize, casemin, ctrlmax, screen=None,
                               numbands=None, band=None, max_hits=32768):
    """Plain PyTorch version of :func:`novel_screen_compact`, on any
    device: :func:`sketch_ops.gather_counts_words_plain`, then
    :func:`screen_predicates`, then :func:`compact_hits_capped`."""
    counts, valid = _screen_counts(words, nsamples, h1, h2, valid, numbands,
                                   band)
    interesting, discard, skip = screen_predicates(
        counts, ncase, valid, codes, lengths, ksize, casemin, ctrlmax,
        screen)
    return compact_hits_capped(counts, interesting, max_hits) + (discard,
                                                                 skip)


def screen_words_plain(words, nsamples, ncase, h1, h2, valid, codes, lengths,
                       ksize, casemin, ctrlmax, screen, numbands, band,
                       rows_per_block):
    """Plain PyTorch version of ``kt_screen_words``
    (:func:`kmer_cuda.screen_words_cuda`'s arguments and outputs), on any
    device: the counts and predicates of
    :func:`novel_screen_compact_plain`, then each block's hits (a block
    owns ``rows_per_block`` rows) ranked in flat order within the block by
    a cumulative sum and stored from the block's first slot on; the slots
    past a block's count hold -1 and 0."""
    counts, valid = _screen_counts(words, nsamples, h1, h2, valid, numbands,
                                   band)
    interesting, discard, skip = screen_predicates(
        counts, ncase, valid, codes, lengths, ksize, casemin, ctrlmax,
        screen)
    B, P = h1.shape
    n = B * P
    seg_len = rows_per_block * P
    nblocks = -(-B // rows_per_block)
    dev = h1.device
    flat = torch.zeros(nblocks * seg_len, dtype=torch.bool, device=dev)
    flat[:n] = interesting.reshape(-1)
    rank = torch.cumsum(flat.view(nblocks, seg_len), 1).reshape(-1)[:n]
    flat = flat[:n]
    index = torch.arange(n, dtype=torch.int64, device=dev)
    # a hit's slot is its block's first slot plus its rank there, at or
    # before its own index; every other index goes to a slot of its own
    slot = torch.where(flat, index // seg_len * seg_len + rank - 1,
                       n + index)
    seg_idx = torch.full((2 * n,), -1, dtype=torch.int32, device=dev)
    seg_idx.scatter_(0, slot, index.to(torch.int32))
    seg_ab = torch.zeros((nsamples, 2 * n), dtype=torch.uint8, device=dev)
    seg_ab.scatter_(1, slot.expand(nsamples, n),
                    counts.reshape(nsamples, n))
    block_counts = torch.zeros(nblocks, dtype=torch.int32, device=dev)
    block_counts.index_add_(0, index // seg_len, flat.to(torch.int32))
    return (block_counts, seg_idx[:n], seg_ab[:, :n].contiguous(), discard,
            skip)


def compact_hits_plain(counts, seg_idx, seg_ab, seg_len, max_hits):
    """Plain PyTorch version of ``kt_compact_hits``
    (:func:`kmer_cuda.compact_hits_cuda`'s arguments and outputs), on any
    device: each segment's first ``counts[b]`` slots take the global ranks
    after the earlier segments' hits; the first ``max_hits`` go to their
    rank's slot (every other slot to one of its own past the capacity), as
    in :func:`compact_hits_capped`."""
    nsamples, n = seg_ab.shape
    dev = seg_idx.device
    counts = counts.to(torch.int64)
    offs = torch.cumsum(counts, 0) - counts
    index = torch.arange(n, dtype=torch.int64, device=dev)
    block = index // seg_len
    pos = index - block * seg_len
    rank = offs[block] + pos
    keep = (pos < counts[block]) & (rank < max_hits)
    slot = torch.where(keep, rank, max_hits + index)
    hit_idx = torch.full((max_hits + n,), -1, dtype=torch.int32, device=dev)
    hit_idx.scatter_(0, slot, seg_idx)
    hit_abunds = torch.zeros((nsamples, max_hits + n), dtype=torch.uint8,
                             device=dev)
    hit_abunds.scatter_(1, slot.expand(nsamples, n), seg_ab)
    return (hit_idx[:max_hits], hit_abunds[:, :max_hits].contiguous(),
            counts.sum().to(torch.int32))


def count_and_screen_stack_packed(case_packed, case_bad, ctrl_packed,
                                  ctrl_bad, lengths_stack, L, ksize,
                                  tablesize, ntables, maxcount, casemin,
                                  ctrlmax, screen=None, max_hits=32768):
    """The whole count and screen as one program over 2-bit packed read
    stacks (counterpart of
    ``kevlar_tpu/ops/novel_ops.py::count_and_screen_stack_packed``).

    ``case_packed`` [NB, B, ceil(L/4)] and ``case_bad`` [NB, B,
    ceil(L/8)] uint8 are the case reads in ``kevlar_tpu``'s wire format
    (:func:`kevlar_tpu_torch.batch.pack_bases`), ``ctrl_packed`` and
    ``ctrl_bad`` tuples of the controls' (any NB), ``lengths_stack`` [NB,
    B] int32 the case reads' lengths (0 for padding rows), all on one
    device, which the program uses as it is given.

    Every sample's stack is unpacked to base codes in one pass
    (:func:`hashing.unpack_bases`, 4 = not ACGT), and its batches are
    counted in turn into an int32 accumulator of ``[ntables, tablesize]``
    (K1 then ``kt_consume`` on a card: every valid window of every row,
    whatever ``lengths`` says), saturated once at ``maxcount`` into uint8
    tables.  Where there is a control, every
    sample's tables are packed four to a word (:func:`sketch_ops.
    pack_sample_tables`) and each case batch is screened and compacted by
    :func:`novel_screen_compact`; with the case alone, its counts come from
    K2, then :func:`screen_predicates` and :func:`compact_hits_capped`
    (``lengths`` decides ``skip`` either way).

    Returns ``((hit_idx int32 [NB, max_hits], hit_abunds uint8 [NB, S,
    max_hits], n_hits int32 [NB], discard bool [NB, B], skip bool [NB,
    B]), case_tables uint8 [ntables, tablesize], ctrl_tables)``, S the
    case and the controls.  Nothing in it waits on the device."""
    device = case_packed.device

    def consume_stack(packed_stack, bad_stack):
        acc = sketch_ops.Accumulator(
            torch.zeros((ntables, tablesize), dtype=torch.uint8,
                        device=device), 8, tablesize)
        for codes in hashing.unpack_bases(packed_stack, bad_stack, L):
            sketch_ops.consume_codes(acc, codes, ksize)
        return acc.tables(maxcount)

    case_tables = consume_stack(case_packed, case_bad)
    ctrl_tables = tuple(consume_stack(p, b)
                        for p, b in zip(ctrl_packed, ctrl_bad))
    all_tables = (case_tables,) + ctrl_tables
    S = len(all_tables)
    words = sketch_ops.pack_sample_tables(all_tables) if S > 1 else None
    outs = []
    for codes, lengths in zip(hashing.unpack_bases(case_packed, case_bad, L),
                              lengths_stack):
        h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
        if words is not None:
            outs.append(novel_screen_compact(
                words, S, 1, h1, h2, valid, codes, lengths, ksize, casemin,
                ctrlmax, screen, max_hits=max_hits))
            continue
        B, P = h1.shape
        counts = sketch_ops.gather_counts_multi(
            [(case_tables, 8, tablesize)], h1.reshape(-1),
            h2.reshape(-1)).reshape(S, B, P)
        interesting, discard, skip = screen_predicates(
            counts, 1, valid != 0, codes, lengths, ksize, casemin, ctrlmax,
            screen)
        outs.append(compact_hits_capped(counts, interesting, max_hits) +
                    (discard, skip))
    stacked = tuple(torch.stack(x) for x in zip(*outs))
    return stacked, case_tables, ctrl_tables


def screen_predicates(counts, ncase, valid, codes, lengths, ksize, casemin,
                      ctrlmax, screen=None):
    """The screen's predicates on gathered counts: ``counts`` uint8 [S, B,
    P] (the ``ncase`` case samples first), ``valid`` bool [B, P], ``codes``
    [B, L] and ``lengths`` [B] of the batch.  Returns ``(interesting [B,
    P], discard [B], skip [B])``, bool, as described for
    :func:`novel_screen` (skip: a non-ACGT base within the read's length,
    or a read shorter than k)."""
    B, L = codes.shape
    lengths = lengths.to(torch.int64)
    within = torch.arange(L, device=codes.device)[None, :] < lengths[:, None]
    skip = ((codes >= 4) & within).any(dim=1) | (lengths < ksize)

    case_counts = counts[:ncase]
    ctrl_counts = counts[ncase:]
    below = case_counts < casemin                      # [C, B, P]
    any_below = below.any(dim=0)
    if screen is not None:
        first_fail = below.to(torch.uint8).argmax(dim=0)
        fail_abund = case_counts.gather(0, first_fail[None])[0]
        discard_kmer = valid & any_below & (fail_abund < screen)
        discard = discard_kmer.any(dim=1) & ~skip
    else:
        discard = torch.zeros(B, dtype=torch.bool, device=codes.device)

    interesting = valid & ~any_below & ~skip[:, None]
    if ctrl_counts.shape[0]:
        interesting = interesting & (ctrl_counts <= ctrlmax).all(dim=0)
    return interesting, discard, skip
