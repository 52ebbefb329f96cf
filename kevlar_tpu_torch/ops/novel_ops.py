"""The novel-k-mer screen over device tensors.

Counterpart of ``kevlar_tpu/ops/novel_ops.py::novel_screen_compact`` (B5):
hash every window of a read batch's base codes once (K1), gather every
sample's min-of-tables count in one launch (K2), evaluate the casemin/ctrlmax predicate,
and compact the hits.  The predicates and the compaction are plain torch,
shared by both devices; the compaction is ``torch.nonzero``, ascending like
``jnp.nonzero``, with no cap on the number of hits.

:func:`count_and_screen_stack_packed` is the whole count and screen of
``kevlar_tpu`` as one program (B.1): every sample's 2-bit packed read stack
counted (K1, ``kt_consume``), the tables packed four samples to a word, the
case stack screened (K1, the word gather, the predicates) and compacted
with a fixed capacity (:func:`compact_hits_capped`), with no host
synchronisation from the first batch to the last.
"""

import torch

from kevlar_tpu_torch.ops import hashing, sketch_ops


def novel_screen(samples, ncase, codes, lengths, ksize, casemin, ctrlmax,
                 screen=None, numbands=None, band=None):
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
    """
    B, L = codes.shape
    h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
    valid = valid != 0
    P = h1.shape[1]
    if numbands:
        valid = valid & ((hashing.to_u32(h1) & (numbands - 1)) == band)
    counts = sketch_ops.gather_counts_multi(
        list(samples), h1.reshape(-1), h2.reshape(-1)).reshape(
            len(samples), B, P)
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
    pack_sample_tables`) and each case batch's counts come from the word
    gather, else from K2.  Each case batch is then screened
    (:func:`screen_predicates`: ``lengths`` decides ``skip``) and compacted
    (:func:`compact_hits_capped`).

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
        B, P = h1.shape
        h1, h2 = h1.reshape(-1), h2.reshape(-1)
        if words is not None:
            counts = sketch_ops.gather_counts_words(words, S, h1, h2)
        else:
            counts = sketch_ops.gather_counts_multi(
                [(case_tables, 8, tablesize)], h1, h2)
        counts = counts.reshape(S, B, P)
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
