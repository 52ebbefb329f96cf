"""The novel-k-mer screen over device tensors.

Counterpart of ``kevlar_tpu/ops/novel_ops.py::novel_screen_compact`` (B5):
hash every window of a wire-format read batch once (K1), gather each
sample's min-of-tables count (K2), evaluate the casemin/ctrlmax predicate,
and compact the hits.  The predicates and the compaction are plain torch,
shared by both devices; the compaction is ``torch.nonzero``, ascending like
``jnp.nonzero``, with no cap on the number of hits.
"""

import torch

from kevlar_tpu_torch.ops import hashing, sketch_ops


def novel_screen(samples, ncase, packed, badmask, lengths, L, ksize, casemin,
                 ctrlmax, screen=None, numbands=None, band=None):
    """Screen a wire-format read batch for novel (interesting) k-mers.

    ``samples`` are the case sketches then the control sketches, as
    ``(tables, counter_bits, tablesize)`` on the batch's device (``ncase``
    of them cases); ``packed``/``badmask`` [B, ceil(L/4)] / [B, ceil(L/8)]
    uint8 and ``lengths`` [B] int32 (0 for padding rows).

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
    B = packed.shape[0]
    h1, h2, valid = hashing.kmer_hashes_packed(packed, badmask, L, ksize)
    valid = valid != 0
    P = h1.shape[1]
    if numbands:
        valid = valid & ((hashing.to_u32(h1) & (numbands - 1)) == band)

    lengths = lengths.to(torch.int64)
    within = torch.arange(L, device=packed.device)[None, :] < lengths[:, None]
    skip = ((hashing.unpack_badmask(badmask, L) & within).any(dim=1)
            | (lengths < ksize))

    h1f, h2f = h1.reshape(-1), h2.reshape(-1)
    counts = torch.stack([
        sketch_ops.gather_counts(tables, h1f, h2f, bits, tablesize)
        for tables, bits, tablesize in samples]).reshape(len(samples), B, P)
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
        discard = torch.zeros(B, dtype=torch.bool, device=packed.device)

    interesting = valid & ~any_below & ~skip[:, None]
    if ctrl_counts.shape[0]:
        interesting = interesting & (ctrl_counts <= ctrlmax).all(dim=0)
    hits = torch.nonzero(interesting.reshape(-1)).reshape(-1)
    hit_abunds = counts.reshape(len(samples), -1)[:, hits]
    return hits, hit_abunds, discard
