"""CIGAR tokenization into alignment blocks carrying subsequences.

Each CIGAR operation is materialized as a block holding the target/query
subsequence it consumes, so variant interpretation can read alleles
straight out of the blocks. ksw2 sometimes emits a spurious short trailing
match block after a terminal indel; the tokenizer detects that tie-break
artifact and folds it into the preceding match block (behavioral contract:
reference kevlar/cigar.py:18-71; canonical CIGARs pinned in
tests/test_reference_parity_units.py).
"""

from collections import namedtuple
import re

AlignmentBlock = namedtuple('AlignmentBlock', 'length type target query')

_OPERATION = re.compile(r'(\d+)([DIM])')


def _materialize(cigar, query, target):
    """Cut query/target into per-operation subsequences (cursor-based)."""
    blocks = []
    qpos = tpos = 0
    for hit in _OPERATION.finditer(cigar):
        span, op = int(hit.group(1)), hit.group(2)
        tseq = qseq = None
        if op != 'I':
            tseq = target[tpos:tpos + span]
            tpos += span
        if op != 'D':
            qseq = query[qpos:qpos + span]
            qpos += span
        blocks.append(AlignmentBlock(span, op, tseq, qseq))
    assert tpos == len(target) and qpos == len(query)
    return blocks


def _render(blocks):
    return ''.join('{:d}{:s}'.format(b.length, b.type) for b in blocks)


class AlignmentTokenizer:
    """Blocks of an alignment, with the terminal-indel artifact folded.

    Attributes: ``blocks`` (list of AlignmentBlock), ``cigar`` (canonical
    CIGAR string), ``origcigar`` (as produced by the aligner).
    """

    def __init__(self, queryseq, targetseq, cigar):
        self._query = queryseq
        self._target = targetseq
        self.origcigar = cigar
        self.blocks = _materialize(cigar, queryseq, targetseq)
        self.cigar = cigar
        if self._fold_terminal_match():
            self.cigar = _render(self.blocks)

    def _fold_terminal_match(self):
        """If the final M block's sequence is explained by sliding it
        across the preceding terminal indel, merge it into the earlier M
        block (the aligner split it only by tie-break accident)."""
        if len(self.blocks) < 3:
            return False
        anchor, gap, tail = self.blocks[-3:]
        if tail.type != 'M' or anchor.type != 'M':
            return False
        if gap.type == 'D':
            slid, stub = gap.target + tail.target, tail.query
        else:
            slid, stub = gap.query + tail.query, tail.target
        if not slid.startswith(stub):
            return False
        merged = AlignmentBlock(
            anchor.length + tail.length, 'M',
            anchor.target + tail.target, anchor.query + tail.query)
        self.blocks[-3:] = [merged, gap]
        return True
