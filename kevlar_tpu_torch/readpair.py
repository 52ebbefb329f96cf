"""Pairwise read overlap anchored on one shared interesting k-mer.

Given two annotated reads and the sequence of a k-mer they share, decide
their relative orientation, which read extends left (the *tail*) and which
extends right (the *head*), and whether their implied overlap is a perfect
match — in which case the pair merges into one sequence.

Behavioral contract (reference kevlar/readpair.py:15-178, pinned by the
orientation-matrix tests): orientation from k-mer strand equality; tail
chosen by deepest anchor offset across the two strand-consistent layouts,
falling back to read length, then lexicographic name; a pair is
*incompatible* when the anchor occurs more than once in either read (either
strand) or the overlap is not a perfect match. The anchored-view
decomposition here is original.

Used by the greedy assembler (:func:`kevlar_tpu_torch.assemble.greedy_asm`).
"""

from kevlar_tpu_torch.dna import revcom


class AnchoredView:
    """A read projected onto one strand, with its anchor k-mer's offset.

    ``seq``/``offset`` are in view coordinates; ``read`` exposes the
    oriented sequence under the original read name (the surface downstream
    consumers and ``ReadPair.__str__`` use).
    """

    __slots__ = ('seq', 'offset', 'ksize', '_name')

    def __init__(self, seq, offset, ksize, name):
        self.seq = seq
        self.offset = offset
        self.ksize = ksize
        self._name = name

    @property
    def name(self):
        return self._name

    @property
    def read(self):
        return self

    @property
    def sequence(self):
        return self.seq

    @property
    def kmer(self):
        return self

    def __len__(self):
        return len(self.seq)

    def flipped(self):
        return AnchoredView(
            revcom(self.seq), len(self.seq) - self.offset - self.ksize,
            self.ksize, self._name)


def _both_views(record, anchorseq):
    """(forward view, reverse view, anchor-as-written, occurrence count)."""
    ikmer = record.ikmers.get(anchorseq)
    if ikmer is None:
        return None, None, None, 0
    hits = (record.sequence.count(anchorseq) +
            record.sequence.count(revcom(anchorseq)))
    fwd = AnchoredView(record.sequence, ikmer.offset, ikmer.ksize,
                       record.name)
    return fwd, fwd.flipped(), record.ikmerseq(ikmer), hits


class ReadPair:
    """Orient, order, and (when the overlap is perfect) merge two reads."""

    def __init__(self, read1, read2, sharedkmer):
        self.sameorient = None
        self.head = None
        self.tail = None
        self.offset = None
        self.overlap = None
        self._merged = None
        f1, r1, asin1, hits1 = _both_views(read1, sharedkmer)
        f2, r2, asin2, hits2 = _both_views(read2, sharedkmer)
        if hits1 != 1 or hits2 != 1:
            return
        self.sameorient = asin1 == asin2
        self.tail, self.head = self._order(f1, r1, f2, r2)
        if self.tail.offset < self.head.offset:
            self.tail, self.head = self.head, self.tail
        self.offset = self.tail.offset - self.head.offset
        self.overlap = len(self.tail) - self.offset
        self._merged = self._try_merge()

    def _layouts(self, f1, r1, f2, r2):
        """The two (read1-view, read2-view) layouts consistent with the
        pair's relative orientation."""
        if self.sameorient:
            return (f1, f2), (r1, r2)
        return (f1, r2), (r1, f2)

    def _order(self, f1, r1, f2, r2):
        """Pick (tail, head): deepest anchor wins; ties fall to length,
        then name (keeping read1 on its forward strand)."""
        first, second = self._layouts(f1, r1, f2, r2)
        depth_first = max(first[0].offset, first[1].offset)
        depth_second = max(second[0].offset, second[1].offset)
        if depth_first != depth_second:
            a, b = first if depth_first > depth_second else second
            if a.offset >= b.offset:
                return a, b
            return b, a
        if len(f1) != len(f2):
            one_is_tail = len(f1) > len(f2)
        elif f1.name != f2.name:
            one_is_tail = f1.name < f2.name
        else:
            one_is_tail = True
        partner2 = f2 if self.sameorient else r2
        if one_is_tail:
            return f1, partner2
        return partner2, f1

    def _try_merge(self):
        left, right = self.tail.seq, self.head.seq
        if right in left or left in right:
            return left
        reach = len(left) - self.offset
        if left[self.offset:] == right[:reach]:
            return left + right[reach:]
        return None

    @property
    def incompatible(self):
        return self._merged is None

    @property
    def mergedseq(self):
        return self._merged

    def __str__(self):
        return '{}\n{}{}\n{}{}'.format(
            self.tail.seq, ' ' * self.tail.offset,
            '|' * self.tail.ksize, ' ' * self.offset, self.head.seq)
