"""``localize`` stage: map contigs to reference target cutouts via seeds.

Contigs are decomposed into canonical seeds (default 51 bp) which are
matched exactly against the genome by the host seed index
(:mod:`kevlar_tpu_torch.reference` — the BWA-subprocess replacement); per
partition, match positions cluster into loci (split where adjacent seeds
are further apart than ``maxdiff``, default 3x the longest contig), and
each cluster's span ±delta is excised as a reference cutout with defline
``seqid_start-end``. Contract: reference kevlar/localize.py:24-224,
pinned to ``kevlar_tpu.localize`` by tests/test_torch_host.py.
"""

from collections import defaultdict
import re

import kevlar_tpu_torch
from kevlar_tpu_torch import seqio
from kevlar_tpu_torch.reference import ReferenceCutout, SeedIndex


class KevlarRefrSeqNotFoundError(ValueError):
    pass


def _split_at_gaps(positions, gap):
    """Split sorted positions into runs where adjacent spacing <= gap.

    Quirk kept from the reference (localize.py:168-170): a leading match at
    position 0 never triggers a split against its successor.
    """
    run = []
    prev = None
    for pos in positions:
        if prev and pos - prev > gap:
            yield run
            run = []
        run.append(pos)
        prev = pos
    yield run


class Localizer:
    """Accumulates seed match positions, then excises clustered cutouts."""

    def __init__(self, seedsize, incl=None, excl=None):
        self._hits = defaultdict(list)
        self.seedsize = seedsize
        self.inclpattern = incl
        self.exclpattern = excl

    def add_seed_match(self, seqid, pos):
        self._hits[seqid].append(pos)

    def _admit(self, seqid):
        if self.exclpattern and re.search(self.exclpattern, seqid):
            return False
        if self.inclpattern:
            return re.search(self.inclpattern, seqid) is not None
        return True

    # kept under the reference's name for parity with its API
    def ignore_seqid(self, seqid):
        return not self._admit(seqid)

    def __len__(self):
        return sum(len(hits) for seqid, hits in self._hits.items()
                   if self._admit(seqid))

    def _excise(self, seqid, cluster, refrseqs, delta):
        lo = max(cluster[0] - delta, 0)
        hi = cluster[-1] + self.seedsize + delta
        subseq = None
        if refrseqs:
            hi = min(hi, len(refrseqs[seqid]))
            subseq = refrseqs[seqid][lo:hi]
        return ReferenceCutout('{:s}_{:d}-{:d}'.format(seqid, lo, hi),
                               subseq)

    def get_cutouts(self, refrseqs=None, delta=0, clusterdist=1000):
        for seqid in sorted(self._hits):
            if not self._admit(seqid):
                continue
            if refrseqs and seqid not in refrseqs:
                raise KevlarRefrSeqNotFoundError(seqid)
            positions = sorted(self._hits[seqid])
            if not clusterdist:
                yield self._excise(seqid, positions, refrseqs, delta)
                continue
            for run in _split_at_gaps(positions, clusterdist):
                yield self._excise(seqid, run, refrseqs, delta)


def decompose_seeds(seq, seedsize):
    for i in range(len(seq) - seedsize + 1):
        yield seq[i:i + seedsize]


def unique_seeds(partitions, seedsize=51):
    """Canonical seed set over all contigs of all partitions."""
    return {
        kevlar_tpu_torch.revcommin(seed)
        for contigs in partitions
        for contig in contigs
        for seed in decompose_seeds(contig.sequence, seedsize)
    }


def get_seed_matches(seeds, refrseqs, seedsize=51, refrfile=None,
                     device='cuda'):
    """Exact genomic matches for canonical seeds: {seed: {(seqid, pos)}}.

    With ``refrfile`` the index loads from (or persists to) its on-disk
    cache next to the FASTA — the `bwa index` analog (the reference
    builds its BWA index before the timed workflow, reference.py:35-51).
    ``device`` is where ``KEVLAR_SEED_BACKEND=device`` searches.
    """
    kevlar_tpu_torch.plog('[kevlar::localize] computing seed matches')
    if refrfile:
        from kevlar_tpu_torch.reference import autoindex
        index = autoindex(refrfile, seedsize, refrseqs=refrseqs,
                          device=device)
    else:
        index = SeedIndex(refrseqs, seedsize, device=device)
    matches = index.lookup(seeds)
    kevlar_tpu_torch.plog('[kevlar::localize] found positions for '
                    '{} seeds'.format(len(matches)))
    return matches


def cutout(contigs, refrseqs, seed_matches, seedsize=51, delta=50,
           maxdiff=None, inclpattern=None, exclpattern=None, debug=False):
    """Reference target cutouts for one partition's contigs."""
    loci = Localizer(seedsize, incl=inclpattern, excl=exclpattern)
    for contig in contigs:
        for seed in decompose_seeds(contig.sequence, seedsize):
            for seqid, position in seed_matches.get(
                    kevlar_tpu_torch.revcommin(seed), ()):
                loci.add_seed_match(seqid, position)
    if maxdiff is None:
        maxdiff = 3 * max(len(c.sequence) for c in contigs)
    yield from loci.get_cutouts(refrseqs=refrseqs, delta=delta,
                                clusterdist=maxdiff)


def localize(partstream, refrfile, seedsize=51, delta=50, maxdiff=None,
             inclpattern=None, exclpattern=None, debug=False, device='cuda'):
    """Stream (partid, cutout) pairs for a partitioned contig stream."""
    partdata = list(partstream)
    kevlar_tpu_torch.plog('[kevlar::localize] loaded {} read partitions into '
                    'memory'.format(len(partdata)))

    seeds = unique_seeds((contigs for _, contigs in partdata), seedsize)
    kevlar_tpu_torch.plog('[kevlar::localize] contigs decomposed into '
                    '{} seeds'.format(len(seeds)))

    kevlar_tpu_torch.plog('[kevlar::localize] loading reference sequences')
    refrseqs = seqio.parse_seq_dict(kevlar_tpu_torch.open(refrfile, 'r'))
    seed_matches = get_seed_matches(seeds, refrseqs, seedsize=seedsize,
                                    refrfile=refrfile, device=device)
    if not seed_matches:
        kevlar_tpu_torch.plog(
            '[kevlar::localize] WARNING: no reference matches')
        return

    total = 0
    for partid, contigs in partdata:
        for gdna in cutout(contigs, refrseqs, seed_matches,
                           seedsize=seedsize, delta=delta, maxdiff=maxdiff,
                           inclpattern=inclpattern, exclpattern=exclpattern):
            total += 1
            yield partid, gdna
    if total == 0:
        kevlar_tpu_torch.plog(
            '[kevlar::localize] WARNING: no reference matches')


def main(args):
    from kevlar_tpu_torch.sequence import Record, write_record
    contigstream = seqio.afxstream(args.contigs)
    if args.part_id:
        pstream = seqio.parse_single_partition(contigstream, args.part_id)
    else:
        pstream = seqio.parse_partitioned_reads(contigstream)
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    for part, gdna in localize(pstream, args.refr, seedsize=args.seed_size,
                               delta=args.delta, maxdiff=args.max_diff,
                               inclpattern=args.include,
                               exclpattern=args.exclude, device=args.device):
        seqname = gdna.defline
        if part is not None:
            seqname += ' kvcc={}'.format(part)
        write_record(Record(name=seqname, sequence=gdna.sequence), outstream)
