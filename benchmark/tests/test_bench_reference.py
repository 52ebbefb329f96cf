"""The plain reference against the system's plain PyTorch versions, on the
CPU at a tiny size: hashing, counting (masked and not, saturating),
reading packed tables, and the novel screen."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.reference import countmin, kmers  # noqa: E402
from kevlar_tpu_torch import sketch  # noqa: E402
from kevlar_tpu_torch.ops import hashing, novel_ops, sketch_ops  # noqa: E402

K = 31


def random_codes(seed, rows, width, readlen, bad=0.01):
    rng = np.random.default_rng(seed)
    codes = np.full((rows, width), 4, dtype=np.uint8)
    codes[:, :readlen] = rng.integers(0, 4, (rows, readlen))
    codes[:, :readlen][rng.random((rows, readlen)) < bad] = 4
    return torch.from_numpy(codes)


def genome_reads(seed, size, rows, readlen, width):
    """Reads from a small genome, so that k-mers repeat and counts grow."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size, dtype=np.uint8)
    starts = rng.integers(0, size - readlen, rows)
    codes = np.full((rows, width), 4, dtype=np.uint8)
    codes[:, :readlen] = genome[starts[:, None] + np.arange(readlen)]
    return genome, torch.from_numpy(codes)


@pytest.mark.parametrize('ksize', [5, 16, 21, 31])
def test_hashes_match(ksize):
    codes = random_codes(ksize, 64, 80, 75, bad=0.03)
    h1, h2, valid = kmers.hashes(codes, ksize)
    p1, p2, pv = hashing.kmer_hashes_plain(codes, ksize)
    assert torch.equal(valid, pv.bool())
    assert torch.equal(h1[valid], hashing.to_u32(p1)[valid])
    assert torch.equal(h2[valid], hashing.to_u32(p2)[valid])


def test_canonical_strands_agree():
    codes = random_codes(3, 8, 40, 40, bad=0)
    rc = (3 - codes.flip(1)).to(torch.uint8)
    a, _ = kmers.canonical(codes, K)
    b, _ = kmers.canonical(rc, K)
    assert torch.equal(a, b.flip(1))


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_unpack_matches(bits):
    rng = np.random.default_rng(bits)
    values = torch.from_numpy(rng.integers(0, 1 << bits, (4, 1001),
                                           dtype=np.uint8))
    packed = sketch_ops.pack_rows(values, bits)
    assert torch.equal(countmin.unpack(packed, bits, 1001), values)
    assert torch.equal(countmin.unpack(packed, bits, 1001),
                       sketch_ops.unpack_rows(packed, bits, 1001))


@pytest.mark.parametrize('bits,masked', [(8, False), (8, True), (4, False),
                                         (1, False)])
def test_count_matches(bits, masked):
    genome, codes = genome_reads(bits, 3000, 2048, 150, 160)
    stack = codes.view(4, 512, 160)
    tablesize = 4099
    mask = ref_mask = None
    if masked:
        mask_rows = torch.from_numpy(np.concatenate(
            [genome[:1500], np.full(10, 4, np.uint8)])[None])
        mask = sketch.Sketch(K, 2003, 4, counter_bits=1, device='cpu')
        mask.consume_batch(mask_rows)
        ref_mask = countmin.count([mask_rows], K, 4, 2003, 1)
        assert torch.equal(countmin.unpack(mask.tables, 1, 2003), ref_mask)
    sk = sketch.Sketch(K, tablesize, 4, counter_bits=bits, device='cpu')
    sk.consume_batch_stack(stack, mask=mask)
    ref = countmin.count(list(stack), K, 4, tablesize, (1 << bits) - 1,
                         mask=ref_mask)
    got = countmin.unpack(sk.tables, bits, tablesize)
    assert torch.equal(got, ref)
    if bits == 8:
        assert int(ref.max()) > 15       # counts grow past a 4-bit counter


def test_count_touched():
    codes = random_codes(9, 16, 40, 40, bad=0)
    touched = []
    countmin.count([codes[:8], codes[8:]], K, 2, 101, 255, touched=touched)
    h1, h2, valid = kmers.hashes(codes[:8], K)
    idx0 = kmers.bucket(h1[valid], h2[valid], 0, 101)
    idx1 = kmers.bucket(h1[valid], h2[valid], 1, 101)
    assert touched[0] == (80, len(set(idx0.tolist())) +
                          len(set(idx1.tolist())))


def test_screen_matches():
    _, case = genome_reads(1, 2500, 1500, 150, 160)
    _, ctrl = genome_reads(2, 2500, 1500, 150, 160)
    tablesize = 20011
    tables = []
    for reads in (case, case, ctrl):
        tables.append(countmin.count([reads], K, 4, tablesize, 255))
    # a third sample that differs from the case: half the control's reads
    tables[1] = countmin.count([ctrl[:750]], K, 4, tablesize, 255)
    read, offset, counts = countmin.screen(case, tables, 1, K, 5, 1, 512)
    lengths = torch.full((case.shape[0],), 150, dtype=torch.int32)
    specs = [(t, 8, tablesize) for t in tables]
    hits, ab, discard = novel_ops.novel_screen(specs, 1, case, lengths, K, 5,
                                               1)
    windows = case.shape[1] - K + 1
    assert len(read) > 0
    assert torch.equal(read * windows + offset, hits.to(torch.int64))
    assert torch.equal(counts, ab)
    assert not discard.any()
