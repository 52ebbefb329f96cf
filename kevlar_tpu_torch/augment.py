"""``augment`` stage: re-annotate naked sequences with interesting k-mers.

Contigs come out of assembly with no annotations; this stage carries the
interesting-k-mer labels from the annotated read stream onto any sequence
that contains the same k-mer (either strand), keyed on the canonical
(strand-min) form. Contract: kevlar/augment.py:13-45 — exact-match transfer
with per-window offsets recomputed on the target sequence.
"""

import kevlar_tpu_torch
from kevlar_tpu_torch.dna import revcommin
from kevlar_tpu_torch.sequence import Record


def _collect_ikmer_index(augseqstream, upint):
    """One pass over the annotated stream -> {canonical kmer: abund}, ksize."""
    index = {}
    ksize = None
    seen = 0
    for record in augseqstream:
        if seen and seen % upint == 0:
            kevlar_tpu_torch.plog(
                '[kevlar::augment] processed', seen, 'input reads')
        seen += 1
        for ikmer in record.annotations:
            index[revcommin(record.ikmerseq(ikmer))] = ikmer.abund
            ksize = ikmer.ksize
    return index, ksize


def augment(augseqstream, nakedseqstream, upint=10000):
    index, ksize = _collect_ikmer_index(augseqstream, upint)
    for record in nakedseqstream:
        fresh = Record(
            name=record.name, sequence=record.sequence,
            quality=getattr(record, 'quality', None))
        if ksize is not None:
            seq = record.sequence
            for offset in range(len(seq) - ksize + 1):
                window = seq[offset:offset + ksize]
                abund = index.get(revcommin(window))
                if abund is not None:
                    fresh.annotate(window, offset, abund)
        yield fresh


def main(args):
    annotated = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(args.augseqs, 'r'))
    naked = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(args.seqs, 'r'))
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    for record in augment(annotated, naked):
        kevlar_tpu_torch.print_augmented_fastx(record, outstream)
