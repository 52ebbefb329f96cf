"""The rooflines' bytes and operations come from the inputs alone, count no
sector, and give the numbers worked out by hand for one batch."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import roofline  # noqa: E402
from benchmark.reference import countmin, kmers  # noqa: E402

K = 31


def hand_batch():
    """Two reads of 40 bases in rows of 48 (10 windows each), the second
    the first's reverse complement: 20 windows, 10 distinct k-mers."""
    g = torch.Generator().manual_seed(7)
    read = torch.randint(0, 4, (40,), generator=g, dtype=torch.uint8)
    codes = torch.full((2, 48), 4, dtype=torch.uint8)
    codes[0, :40] = read
    codes[1, :40] = (3 - read).flip(0)
    return codes


def test_consume_by_hand():
    codes = hand_batch()
    touched = []
    countmin.count([codes], K, 4, 1_000_003, 255, touched=touched)
    kept, distinct = touched[0]
    assert kept == 20
    # 10 distinct k-mers in each of 4 tables of a million buckets: 40
    # buckets, barring a collision of two k-mers in a table
    assert distinct == 40
    launch = {'codes_bytes': codes.numel(), 'kept': kept,
              'distinct': distinct, 'ntables': 4, 'buckets': 4 * 1_000_003}
    nbytes, ops = roofline.consume_launch(launch)
    assert nbytes == 96 + 8 * 40
    assert ops == 4 * 20 * 4


def test_consume_whole_accumulator_bounds():
    launch = {'codes_bytes': 10, 'kept': 100, 'distinct': 400, 'ntables': 4,
              'buckets': 12}
    assert roofline.consume_launch(launch)[0] == 10 + 8 * 12


def test_screen_by_hand():
    codes = hand_batch()
    tables = [torch.zeros((4, 101), dtype=torch.uint8) for _ in range(3)]
    case = countmin.count([codes], K, 4, 101, 255)
    tables[0] = case
    words = []
    read, offset, counts = countmin.screen(codes, tables, 1, K, 2, 1, 2,
                                           words=words)
    # every k-mer is there twice in the case and nowhere else: 20 hits,
    # and each of the 10 distinct k-mers needs its word in all 4 tables
    assert len(read) == 20
    h1, h2, valid = kmers.hashes(codes, K)
    keys = {(t, int(kmers.bucket(a, b, t, 101)))
            for a, b in zip(h1[valid], h2[valid]) for t in range(4)}
    assert words == [len(keys)]
    launch = {'codes_bytes': 96, 'lengths_bytes': 8, 'words': words[0],
              'hits': 20, 'rows': 2, 'samples': 3, 'windows': 20}
    nbytes, ops = roofline.screen_launch(launch)
    assert nbytes == 96 + 8 + 4 * len(keys) + 20 * 7 + 4 + 2
    assert ops == 400


def test_screen_words_one_table_where_case_fails():
    codes = hand_batch()
    zero = torch.zeros((4, 101), dtype=torch.uint8)
    words = []
    countmin.screen(codes, [zero, zero], 1, K, 5, 1, 2, words=words)
    h1, h2, valid = kmers.hashes(codes, K)
    keys = {int(kmers.bucket(a, b, 0, 101))
            for a, b in zip(h1[valid], h2[valid])}
    assert words == [len(keys)]


@pytest.mark.parametrize('fn,launch', [
    (roofline.consume_launch, {'codes_bytes': 7, 'kept': 1, 'distinct': 1,
                               'ntables': 1, 'buckets': 99}),
    (roofline.screen_launch, {'codes_bytes': 7, 'lengths_bytes': 4,
                              'words': 1, 'hits': 0, 'rows': 1,
                              'samples': 3, 'windows': 1}),
])
def test_no_sectors(fn, launch):
    """One random access counts the 4 bytes it needs, not 32."""
    nbytes, _ = fn(launch)
    more = dict(launch)
    key = 'distinct' if 'distinct' in launch else 'words'
    more[key] += 1
    step = fn(more)[0] - nbytes
    assert step in (4, 8)
    assert nbytes % 32 != 0


def test_inputs_alone():
    """Equal inputs give equal counts, whatever else is around."""
    launch = {'codes_bytes': 5, 'kept': 3, 'distinct': 9, 'ntables': 4,
              'buckets': 100}
    first = roofline.consume_launch(dict(launch))
    second = roofline.consume_launch(dict(launch, unrelated=1))
    assert first == second


def test_share_reads_nothing_without_launches():
    ctx = {'trace': {'ops': {}}, 'launch_stats': {'count': [{}]},
           'device_kind': 'NVIDIA H100 80GB HBM3', 'steps': 1}
    assert roofline.share(ctx, 'kt_consume') is None
    ctx['device_kind'] = 'some other card'
    assert roofline.share(ctx, 'kt_consume') is None


def test_share_arithmetic():
    launch = {'codes_bytes': 3.35e6, 'kept': 0, 'distinct': 0,
              'ntables': 4, 'buckets': 10}
    ctx = {'trace': {'ops': {'consume_kernel<4, true, 0>': [2, 4e-6]}},
           'launch_stats': {'count': [launch]},
           'device_kind': 'NVIDIA H100 80GB HBM3', 'steps': 2}
    # two launches of 1 us of bytes each, in 4 us of kernel time
    assert roofline.share(ctx, 'kt_consume') == pytest.approx(50.0)
