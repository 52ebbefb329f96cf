"""``filter`` stage: re-count annotated k-mers to deflate FPR-inflated counts.

Port of ``kevlar_tpu.filter``.  The novel-read set is tiny compared to the
raw samples, so re-counting its annotated k-mers into a fresh sketch
gives near-exact case abundances; any annotation whose recount falls below ``casemin`` (or whose stored control
abundance exceeds ``ctrlmax``) is dropped, and reads left bare are
discarded. Contract: reference kevlar/filter.py:15-96 (mask k-mers are
excluded from the recount; FPR bailout on the fresh sketch).

Both passes are columnar: annotated k-mers are hashed once per read block
and counted/queried in fixed-size chunks of the host-backend recount
sketch, not per-k-mer point calls.  The mask is any loaded sketch: a
device sketch answers through its host mirror, a khmer-format one through
its own engine.
"""

import numpy as np

import kevlar_tpu_torch
from kevlar_tpu_torch import dna
from kevlar_tpu_torch.sequence import KmerOfInterest
from kevlar_tpu_torch.sketch import (
    Sketch, estimate_fpr, KevlarUnsuitableFPRError,
)
from kevlar_tpu_torch.support import Timer


def _hash_annotations(read):
    """Hash each annotated k-mer of one read -> (h1, h2) uint32 arrays.

    Every window of the read hashes in one vectorised pass and the
    annotated offsets are gathered from it (per-annotation scalar hashing
    dominated the filter stage's profile)."""
    ksize = read.annotations[0].ksize
    h1, h2, _valid = dna.kmer_hashes(dna.encode(read.sequence), ksize)
    offs = np.fromiter((ik.offset for ik in read.annotations),
                       dtype=np.int64, count=len(read.annotations))
    return h1[offs], h2[offs]


class _BlockCounter:
    """Accumulates hash pairs and feeds them to the sketch in fixed-size
    chunks."""

    def __init__(self, counts, mask, chunk):
        self.counts = counts
        self.mask = mask
        self.chunk = chunk
        self._h1, self._h2, self._keep = [], [], []
        self._pending = 0

    def add(self, h1, h2, keep=None):
        self._h1.append(h1)
        self._h2.append(h2)
        self._keep.append(np.ones(h1.shape, dtype=bool)
                          if keep is None else keep)
        self._pending += len(h1)
        if self._pending >= self.chunk:
            self.flush()

    def flush(self):
        if not self._h1:
            return
        h1 = np.concatenate(self._h1)
        h2 = np.concatenate(self._h2)
        keep = np.concatenate(self._keep)
        self._h1, self._h2, self._keep = [], [], []
        self._pending = 0
        if self.mask is not None:
            keep = keep & (self.mask._host_counts(h1, h2) == 0)
        size = self.chunk
        for lo in range(0, len(h1), size):
            s1, s2, sk = h1[lo:lo + size], h2[lo:lo + size], keep[lo:lo + size]
            short = size - len(s1)
            if short:
                s1 = np.concatenate([s1, np.zeros(short, np.uint32)])
                s2 = np.concatenate([s2, np.ones(short, np.uint32)])
                sk = np.concatenate([sk, np.zeros(short, bool)])
            self.counts.consume_hashes(s1, s2, sk)


def first_pass(reads, mask, memory, timer, chunk=1 << 16):
    kevlar_tpu_torch.plog('[kevlar::filter] First pass: re-counting k-mers')
    timer.start('firstpass')
    from kevlar_tpu_torch.oxli import OxliSketch
    # khmer-format masks hash differently (64-bit khmer hash over prime
    # tables): membership is resolved per read from the k-mer strings and
    # fed through as a keep-mask, the native-format path stays hash-based
    oxlimask = mask if isinstance(mask, OxliSketch) else None
    counter = None
    nreads = 0
    for nreads, read in enumerate(reads, 1):
        if not read.annotations:
            continue
        if counter is None:
            ksize = read.annotations[0].ksize
            counter = _BlockCounter(
                Sketch(ksize, int(memory) // 4, 4, counter_bits=8,
                       backend='host'),
                None if oxlimask is not None else mask, chunk)
        keep = None
        if oxlimask is not None:
            keep = np.array([oxlimask.get(read.ikmerseq(ik)) == 0
                             for ik in read.annotations], dtype=bool)
        counter.add(*_hash_annotations(read), keep=keep)
    if counter is not None:
        counter.flush()
    kevlar_tpu_torch.plog(
        '[kevlar::filter]',
        'First pass complete! Processed {:d} reads in {:.2f} '
        'seconds!'.format(nreads, timer.stop('firstpass')))
    return counter.counts if counter else None


def check_fpr(counts, maxfpr):
    fpr = estimate_fpr(counts)
    message = 'FPR for re-computed k-mer counts: {:1.3f}'.format(fpr)
    kevlar_tpu_torch.plog('[kevlar::filter]', message)
    if fpr > maxfpr:
        raise KevlarUnsuitableFPRError(message + ' FPR too high, bailing out!')


def _revalidate(read, recounts, casemin, ctrlmax):
    """Annotations surviving the recount, with refreshed case abundance."""
    survivors = []
    for ikmer, newcount in zip(read.annotations, recounts):
        controls = ikmer.abund[1:]
        if newcount < casemin or any(a > ctrlmax for a in controls):
            continue
        survivors.append(KmerOfInterest(
            ikmer.ksize, ikmer.offset, (int(newcount),) + tuple(controls)))
    return survivors


def second_pass(reads, counts, casemin, ctrlmax, timer):
    kevlar_tpu_torch.plog('[kevlar::filter] Second pass: discarding '
                          'k-mers/reads')
    timer.start('secondpass')
    kept = 0
    for read in reads:
        h1, h2 = _hash_annotations(read)
        recounts = counts._host_counts(h1, h2)
        survivors = _revalidate(read, recounts, casemin, ctrlmax)
        if survivors:
            read.annotations = survivors
            kept += 1
            yield read
    kevlar_tpu_torch.plog(
        '[kevlar::filter]',
        'Second pass complete! Validated {:d} reads in {:.2f} '
        'seconds!'.format(kept, timer.stop('secondpass')))


def _reads(readfile):
    return kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(readfile, 'r'))


def filter(readfile, mask=None, memory=1e6, maxfpr=0.01, casemin=6,
           ctrlmax=1):
    timer = Timer()
    timer.start()
    counts = first_pass(_reads(readfile), mask, memory, timer)
    if counts is None:
        return
    check_fpr(counts, maxfpr)
    yield from second_pass(_reads(readfile), counts, casemin, ctrlmax, timer)
    kevlar_tpu_torch.plog(
        '[kevlar::filter] Total time: {:.2f} seconds'.format(timer.stop()))


def main(args):
    from kevlar_tpu_torch import sketch
    mask = sketch.load(args.mask, device=args.device) if args.mask else None
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    try:
        for record in filter(args.augfastq, mask=mask, memory=args.memory,
                             maxfpr=args.max_fpr, casemin=args.case_min,
                             ctrlmax=args.ctrl_max):
            kevlar_tpu_torch.print_augmented_fastx(record, outstream)
    finally:
        if args.out not in (None, '-'):
            outstream.close()
