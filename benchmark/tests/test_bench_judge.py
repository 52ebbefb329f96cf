"""The screen's text is read back and held to the expected hits."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import judge  # noqa: E402

K = 5
SEQ = 'ACGTACGGTTCA'


def text(counts='7 0 1', offset=2, name='r000000004'):
    kmer = SEQ[offset:offset + K]
    return '@{}\n{}\n+\n{}\n{}{}          {}#\n'.format(
        name, SEQ, 'I' * len(SEQ), ' ' * offset, kmer, counts)


def compare(out, expected):
    return judge.compare(out, expected, lambda i: SEQ if i == 3 else 'A',
                         lambda name: int(name[1:]) - 1, K)


def test_parse():
    assert judge.parse(text(), K) == [('r000000004', SEQ,
                                       [(2, 'GTACG', (7, 0, 1))])]


def test_right_text():
    assert compare(text(), {(3, 2): (7, 0, 1)}) == (0, 0, 0)


def test_wrong_missing_extra():
    assert compare(text(counts='7 0 2'), {(3, 2): (7, 0, 1)}) == (0, 0, 1)
    assert compare('', {(3, 2): (7, 0, 1)}) == (1, 0, 0)
    assert compare(text(), {}) == (0, 1, 0)
    assert compare(text(name='r000000001'), {(3, 2): (7, 0, 1)})[0] == 1


def test_unreadable_text_holds_no_hit():
    assert compare('not fastq\n', {(3, 2): (7, 0, 1)}) == (1, 1, 0)
