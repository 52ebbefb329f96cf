"""Sequencing reads drawn on the device from a seeded generator.

As ``kevlar_tpu_torch.bench.sim_trio.simulate_reads`` draws them: each
haplotype of a sample gets ``len * coverage // (2 * readlen)`` reads of
``readlen`` bases from uniform start positions, the first haplotype's
reads before the second's, and each base is changed at ``error`` to one of
the other three.  The reads are rows of base codes (0-3) padded with the
code 4 to ``width`` columns, as the system's reader leaves a FASTQ file's
reads in memory.
"""

import numpy as np
import torch

from benchmark.traffic.genome import diverge, randint

CHUNK = 1 << 20


def count(hap_lengths, coverage, readlen):
    """Reads a sample of haplotypes of these lengths gets."""
    return sum(n * coverage // (2 * readlen) for n in hap_lengths)


def draw(gen, haplotypes, coverage, readlen, error, out):
    """Write a sample's reads into the first rows of ``out`` (uint8 [R,
    width] on the device, filled with 4); returns how many there are."""
    row = 0
    span = torch.arange(readlen, device=out.device)
    for hap in haplotypes:
        n = len(hap) * coverage // (2 * readlen)
        for first in range(0, n, CHUNK):
            m = min(CHUNK, n - first)
            starts = randint(gen, 0, len(hap) - readlen, (m,))
            reads = hap[starts[:, None] + span]
            out[row:row + m, :readlen] = diverge(gen, reads, error)
            row += m
    return row


class ReadNames:
    """The names ``r000000001``, ... of a sample's reads from ``first`` on,
    made when asked for (the reader's list of names, without holding one
    string a read)."""

    def __init__(self, first, n):
        self.first = first
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return 'r{:09d}'.format(self.first + i + 1)


def index_of(name):
    """The read row a :class:`ReadNames` name stands for."""
    return int(name[1:]) - 1


def qualities(readlen, width):
    """Quality rows of a FASTQ file whose every base reads ``I``: one row,
    zero past the read as the reader leaves it, seen as ``[any, width]``."""
    row = np.zeros((1, width), dtype=np.uint8)
    row[0, :readlen] = ord('I')
    return row
