"""Contig-to-reference-cutout alignments interpreted as variant calls.

An alignment's canonical CIGAR is classified *structurally* from its
tokenized blocks — an optional leading/trailing indel around either a
single M block (substitution shape) or an M/gap/M core (indel shape) —
which is equivalent to the reference's regex patterns
(kevlar/varmap.py:49-54) since the CIGAR string renders 1:1 from the
blocks. Interpretation contract (kevlar/varmap.py:157-330): per-mismatch
SNV calls with terminal trimming, PerfectMatch / NumerousMismatches /
InscrutableCigar no-calls, ±(k-1) ALT/REFR windows, VCF-style
left-anchored indel alleles at the anchor coordinate minus one, passenger
(no spanning novel k-mer) and homopolymer filters.

The call stage hands in precomputed alignments from the batched aligner
(:mod:`kevlar_tpu_torch.ops.align_cuda`); a mapping given no score
aligns itself on the host with the numpy wavefront
(:mod:`kevlar_tpu_torch.ops.align`).
"""

import kevlar_tpu_torch
from kevlar_tpu_torch.ops.align import align_both_strands
from kevlar_tpu_torch.cigar import AlignmentTokenizer
from kevlar_tpu_torch.vcf import Variant
from kevlar_tpu_torch.vcf import VariantFilter as vf


def _classify(blocks):
    """Structural CIGAR classification.

    Returns (vartype, lead, left, gap, right): vartype in {'snv', 'indel',
    'complex', None}; lead is the leading indel block if any; for 'snv'
    ``left`` is the M block; for 'indel' (left, gap, right) are the
    M/indel/M core.  'complex' marks CIGARs beyond the reference's
    callable patterns (kevlar/varmap.py:49-54 regexes) that still contain
    at least one M-flanked interior indel — repeat-context alignments
    accumulate small spurious gap blocks around the true event, and the
    reference no-calls ALL of them (InscrutableCigar); the complex caller
    picks the candidate with novel-k-mer support instead.
    """
    lead = blocks[0] if blocks and blocks[0].type != 'M' else None
    core = blocks[1:] if lead is not None else list(blocks)
    if core and core[-1].type != 'M':
        core = core[:-1]
    shape = ''.join(b.type for b in core)
    if shape == 'M':
        return 'snv', lead, core[0], None, None
    if shape in ('MDM', 'MIM'):
        return 'indel', lead, core[0], core[1], core[2]
    for i in range(1, len(blocks) - 1):
        if blocks[i].type in 'ID' and blocks[i - 1].type == 'M' \
                and blocks[i + 1].type == 'M':
            return 'complex', lead, None, None, None
    return None, lead, None, None, None


def trim_terminal_snvs(mismatches, alnlength, mindist=5):
    """Drop mismatch positions within ``mindist`` of either alignment end;
    returns (number trimmed, surviving positions)."""
    kept = [mm for mm in mismatches
            if mm >= mindist and alnlength - mm >= mindist]
    return len(mismatches) - len(kept), kept


def n_ikmers_present(record, window):
    """Novel k-mers of ``record`` present in ``window`` (either strand)."""
    total = 0
    for ikmer in record.annotations:
        seq = record.ikmerseq(ikmer)
        if seq in window or kevlar_tpu_torch.revcom(seq) in window:
            total += 1
    return total


class VariantMapping:
    """One contig aligned to one reference cutout, and the variants the
    alignment implies."""

    def __init__(self, contig, cutout, score=None, cigar=None, strand=1,
                 match=1, mismatch=2, gapopen=5, gapextend=0,
                 homopolyfilt=True, nocall=False):
        self.contig = contig
        self.cutout = cutout
        self.nocall = nocall
        self.vartype = None
        self.score = 0
        if nocall:
            return
        if score is None:
            score, cigar, strand = align_both_strands(
                cutout.sequence, contig.sequence, match, mismatch, gapopen,
                gapextend)
        self.score = score
        self.strand = strand
        self.do_homopolymer_filter = homopolyfilt
        self.trimmed = 0
        self.tok = AlignmentTokenizer(self.varseq, self.refrseq, cigar)
        self.cigar = self.tok.cigar
        (self.vartype, self._lead, self._left, self._gap,
         self._right) = _classify(self.tok.blocks)

    # -- sequence / coordinate views -----------------------------------------

    @property
    def varseq(self):
        assert self.strand in (-1, 1)
        seq = self.contig.sequence
        return seq if self.strand == 1 else kevlar_tpu_torch.revcom(seq)

    @property
    def refrseq(self):
        return self.cutout.sequence

    @property
    def seqid(self):
        return self.cutout._seqid

    @property
    def pos(self):
        return self.cutout._startpos

    @property
    def interval(self):
        return self.cutout.interval

    @property
    def offset(self):
        """Target positions consumed by the leading block."""
        if self.vartype not in ('snv', 'indel'):
            return None  # complex mappings track offsets per candidate
        return self._lead.length if self._lead else 0

    @property
    def targetshort(self):
        if self.vartype not in ('snv', 'indel'):
            return None
        return self._lead is not None and self._lead.type == 'I'

    @property
    def match(self):
        return self._left if self.vartype == 'snv' else None

    @property
    def leftflank(self):
        return self._left if self.vartype == 'indel' else None

    @property
    def indel(self):
        return self._gap if self.vartype == 'indel' else None

    @property
    def indeltype(self):
        return self._gap.type if self.vartype == 'indel' else None

    @property
    def rightflank(self):
        return self._right if self.vartype == 'indel' else None

    @property
    def ikmers(self):
        for kmer in self.contig.annotations:
            seq = self.contig.ikmerseq(kmer)
            yield seq
            yield kevlar_tpu_torch.revcom(seq)

    def __str__(self):
        tline, qline = '', ''
        for block in self.tok.blocks:
            tline += block.target or '-' * block.length
            qline += block.query or '-' * block.length
        mline = ''.join('|' if t == q else ' '
                        for t, q in zip(tline, qline))
        panels = []
        for lo in range(0, len(tline), 80):
            panels.append('\n'.join((tline[lo:lo + 80], mline[lo:lo + 80],
                                     qline[lo:lo + 80], '')))
        return '\n'.join(panels).strip()

    # -- filters ---------------------------------------------------------------

    def is_passenger(self, call):
        if call.window is None:
            return False
        return not any(k in call.window for k in self.ikmers)

    def homopolymer_filter(self):
        """An indel whose right flank opens with a 5-base run within its
        first 7 bp is most likely a homopolymer artifact."""
        if not self.do_homopolymer_filter:
            return False
        flank = self._right.target if self._right else None
        if flank is None or len(flank) < 5:
            return False
        return flank[0] * 5 in flank[:7]

    # -- variant interpretation --------------------------------------------------

    def call_variants(self, ksize, mindist=6):
        """Yield variant calls (or no-calls) from this alignment."""
        if self.nocall:
            yield Variant('.', '.', '.', '.', CONTIG=self.contig.sequence,
                          IKMERS=str(len(self.contig.annotations)))
        elif self.vartype == 'snv':
            for call in self._substitutions(ksize, mindist):
                yield self._passenger_checked(call)
        elif self.vartype == 'indel':
            yield from self._indel_and_flanks(ksize, mindist)
        elif self.vartype == 'complex':
            yield from self.call_complex(ksize)
        else:
            nocall = Variant(
                self.seqid, self.pos, '.', '.', CONTIG=self.varseq,
                CIGAR=self.cigar, KSW2=str(self.score))
            nocall.filter(vf.InscrutableCigar)
            yield nocall

    def _passenger_checked(self, call):
        if self.is_passenger(call):
            call.filter(vf.PassengerVariant)
        return call

    def _substitutions(self, ksize, mindist):
        lead = 0 if self.targetshort else self.offset
        yield from self.call_snv(self._left.query, self._left.target, lead,
                                 ksize, mindist)

    def _indel_and_flanks(self, ksize, mindist):
        indel = next(self.call_indel(ksize))
        self._passenger_checked(indel)
        if self.homopolymer_filter():
            indel.filter(vf.Homopolymer)
        yield indel

        # flank mismatches become additional SNV calls (never no-calls)
        at = 0 if self.targetshort else self.offset
        for call in self.call_snv(self._left.query, self._left.target, at,
                                  ksize, mindist, donocall=False):
            yield self._passenger_checked(call)
        at += self._left.length
        if self._gap.type == 'D':
            at += self._gap.length
        for call in self.call_snv(self._right.query, self._right.target, at,
                                  ksize, mindist, donocall=False):
            yield self._passenger_checked(call)

    def call_snv(self, qseq, tseq, offset, ksize, mindist=6, donocall=True):
        """Per-mismatch SNV calls from one aligned M block."""
        length = len(qseq)
        assert len(tseq) == length
        if length < ksize:
            return
        diffs = [i for i, (q, t) in enumerate(zip(qseq, tseq)) if q != t]
        if mindist:
            self.trimmed, diffs = trim_terminal_snvs(diffs, length, mindist)
        if not diffs or len(diffs) > 4:
            if donocall:
                nocall = Variant(
                    self.seqid, self.cutout.local_to_global(offset), '.', '.',
                    CONTIG=qseq, CIGAR=self.cigar, KSW2=str(self.score),
                    IKMERS=str(len(self.contig.annotations)))
                nocall.filter(vf.PerfectMatch if not diffs
                              else vf.NumerousMismatches)
                yield nocall
            return
        for at in diffs:
            lo = max(at - ksize + 1, 0)
            hi = min(at + ksize, length)
            altwindow, refrwindow = qseq[lo:hi], tseq[lo:hi]
            yield Variant(
                self.seqid, self.cutout.local_to_global(at + offset),
                tseq[at].upper(), qseq[at].upper(), CONTIG=qseq,
                CIGAR=self.cigar, KSW2=str(self.score),
                IKMERS=str(n_ikmers_present(self.contig, altwindow)),
                ALTWINDOW=altwindow, REFRWINDOW=refrwindow)

    def call_complex(self, ksize):
        """Best-supported interior indel of a complex CIGAR.

        Every M-flanked interior I/D block is a candidate; each scores by
        the number of the contig's novel k-mers present in its would-be
        ALT window — the defining property of the true event (spurious
        repeat-noise gaps have none).  The winner is called exactly like
        the canonical M/gap/M indel; zero support anywhere falls back to
        the reference's InscrutableCigar no-call.  The call still faces
        the passenger/homopolymer screens here and the trio likelihood in
        simlike.  Extension beyond reference kevlar/varmap.py:49-54
        (docs/migrating.md)."""
        wing = ksize - 1
        blocks = self.tok.blocks
        candidates = []
        tconsumed = 0
        for i, block in enumerate(blocks):
            if 0 < i < len(blocks) - 1 and block.type in 'ID' \
                    and blocks[i - 1].type == 'M' \
                    and blocks[i + 1].type == 'M':
                left, right = blocks[i - 1], blocks[i + 1]
                altwindow = (left.query[-wing:] + (block.query or '') +
                             right.query[:wing])
                support = n_ikmers_present(self.contig, altwindow)
                if support > 0:
                    refrwindow = (left.target[-wing:] +
                                  (block.target or '') +
                                  right.target[:wing])
                    refr = left.target[-1] + (block.target or '')
                    alt = left.query[-1] + (block.query or '')
                    candidates.append((support, tconsumed, refr, alt,
                                       altwindow, refrwindow, right))
            tconsumed += len(block.target or '')
        if not candidates:
            nocall = Variant(
                self.seqid, self.pos, '.', '.', CONTIG=self.varseq,
                CIGAR=self.cigar, KSW2=str(self.score))
            nocall.filter(vf.InscrutableCigar)
            yield nocall
            return
        # every supported candidate is emitted (a repeat can hold the same
        # event twice in one alignment): the partition's likelihood
        # ranking and CALLCLASS compaction keep the real one
        for (support, anchor, refr, alt, altwindow, refrwindow,
             right) in candidates:
            call = Variant(
                self.seqid, self.cutout.local_to_global(anchor) - 1, refr,
                alt, CONTIG=self.varseq, CIGAR=self.cigar,
                KSW2=str(self.score), IKMERS=str(support),
                ALTWINDOW=altwindow, REFRWINDOW=refrwindow)
            if self.is_passenger(call):
                call.filter(vf.PassengerVariant)
            if self.do_homopolymer_filter and len(right.target) >= 5 \
                    and right.target[0] * 5 in right.target[:7]:
                call.filter(vf.Homopolymer)
            yield call

    def call_indel(self, ksize):
        """The indel call: alleles anchored on the last left-flank base,
        windows = (k-1) flank context around the gap sequence.

        The gap block carries sequence on exactly one side (target for D,
        query for I), so one symmetric expression covers both: the held-out
        sequence joins the side that has it."""
        left, gap, right = self._left, self._gap, self._right
        wing = ksize - 1
        refrwindow = (left.target[-wing:] + (gap.target or '') +
                      right.target[:wing])
        altwindow = (left.query[-wing:] + (gap.query or '') +
                     right.query[:wing])
        refr = left.target[-1] + (gap.target or '')
        alt = left.query[-1] + (gap.query or '')
        anchor = (0 if self.targetshort else self.offset) + left.length
        yield Variant(
            self.seqid, self.cutout.local_to_global(anchor) - 1, refr, alt,
            CONTIG=self.varseq, CIGAR=self.cigar, KSW2=str(self.score),
            IKMERS=str(n_ikmers_present(self.contig, altwindow)),
            ALTWINDOW=altwindow, REFRWINDOW=refrwindow)
