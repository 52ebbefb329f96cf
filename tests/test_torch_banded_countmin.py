"""The port's hash bands against the benchmark's plain reference
(``benchmark/reference/countmin.py``, plain torch importing nothing of the
port): on a seeded trio of the tiny banded configuration's shape, each
band's counts (``Sketch.consume_batch_stack(..., numbands=N, band=b)``)
equal the reference's band tables bucket for bucket, each band's novel
screen gives the reference's band hits, and ``unband.unband`` over the
bands' records gives the reference's merge.  And the count's close, which
saturates the int32 accumulator in place: the same packed tables as a
close into a copy, and an accumulator that cannot be read after it; its
pack of sub-byte counters, the reference's.

Tolerance: none.  All on the CPU, the kernels' plain versions."""

import io
import json
import os

import numpy as np
import pytest
import torch

import kevlar_tpu_torch
from benchmark.reference import countmin
from benchmark.traffic import reads as reads_mod
from benchmark.traffic.trio import Trio
from kevlar_tpu_torch import novel, sketch, unband
from kevlar_tpu_torch.ops import sketch_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, 'benchmark', 'tests', 'data', 'configs',
                      'tiny-banded.json')
SEED = 2 ** 31 + 101
K = 31
COUNT_ROWS = 2048
SCREEN_ROWS = 512
SAMPLES = ('proband', 'mother', 'father')
# khmer's sizing of the configuration's 100,000-byte sketch: 4 tables of
# 25,000 8-bit buckets, made odd
TABLESIZE = 24999


@pytest.fixture(autouse=True)
def _quiet():
    kevlar_tpu_torch.logstream = io.StringIO()
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def trio():
    """The tiny banded configuration's trio, a quarter of its genome: 7.5
    kb at 30x, three de novo variants, 4 x 100,000-byte band sketches."""
    with open(CONFIG) as fh:
        config = json.load(fh)
    config['genome'] = dict(config['genome'], size=7500)
    config['variants'] = dict(config['variants'],
                              inherited=dict(config['variants']['inherited'],
                                             count=1))
    return config, Trio(config, SEED, 'cpu', COUNT_ROWS)


def _band_run(config, trio, numbands, band):
    """The port's band ``band``: the trio's sketches, the screen's records
    and the reference's tables and hits of that band."""
    spec = config['sketch']
    ports, refs = {}, {}
    for name in SAMPLES:
        stack = trio.stack(name, COUNT_ROWS)
        sk = sketch.allocate_from_memory(
            K, int(spec['memory']), int(spec['ntables']),
            counter_bits=int(spec['counter_bits']), device='cpu')
        assert sk.tablesize == TABLESIZE
        sk.consume_batch_stack(stack, numbands=numbands, band=band)
        ports[name] = sk
        refs[name] = countmin.count(list(stack), K, int(spec['ntables']),
                                    TABLESIZE, 255, band=(band, numbands))
    n = trio.nreads['proband']
    codes = trio.reads['proband'][:n].numpy()
    batches = [novel._NativeBatch(
        codes[first:first + SCREEN_ROWS],
        np.full(min(SCREEN_ROWS, n - first), trio.readlen, np.int32),
        reads_mod.ReadNames(first, min(SCREEN_ROWS, n - first)),
        np.broadcast_to(reads_mod.qualities(trio.readlen, trio.width),
                        (min(SCREEN_ROWS, n - first), trio.width)),
        SCREEN_ROWS) for first in range(0, n, SCREEN_ROWS)]
    spec_novel = config['novel']
    records = list(novel.novel(
        None, [ports['proband']], [ports['mother'], ports['father']],
        ksize=K, casemin=int(spec_novel['case_min']),
        ctrlmax=int(spec_novel['ctrl_max']), batchstream=batches,
        numbands=numbands, band=band))
    hits = countmin.screen(
        trio.reads['proband'][:n], [refs[s] for s in SAMPLES], 1, K,
        int(spec_novel['case_min']), int(spec_novel['ctrl_max']),
        SCREEN_ROWS, band=(band, numbands))
    return ports, refs, records, hits


def _sequence(trio, read):
    letters = np.frombuffer(b'ACGTN', dtype=np.uint8)
    row = trio.reads['proband'][read, :trio.readlen].numpy()
    return letters[np.minimum(row, 4)].tobytes().decode()


@pytest.mark.parametrize('numbands', [4, 2])
def test_bands_count_screen_and_unband_as_the_reference(trio, numbands):
    config, trio = trio
    spec = config['sketch']
    band_records, band_hits = [], []
    for band in range(numbands):
        ports, refs, records, hits = _band_run(config, trio, numbands, band)
        for name in SAMPLES:
            got = countmin.unpack(ports[name].tables, ports[name].counter_bits,
                                  ports[name].tablesize)
            assert torch.equal(got, refs[name]), (band, name)
            assert torch.equal(ports[name].tables,
                               countmin.pack(refs[name],
                                             int(spec['counter_bits'])))
        read, offset, counts = hits
        want = dict(zip(zip(read.tolist(), offset.tolist()),
                        map(tuple, counts.t().tolist())))
        got = {}
        for record in records:
            i = reads_mod.index_of(record.name)
            assert record.sequence == _sequence(trio, i)
            for kmer in record.annotations:
                assert kmer.ksize == K
                got[i, kmer.offset] = tuple(kmer.abund)
        assert got == want, band
        band_records.append(records)
        band_hits.append(hits)
    # a band keeps about 1/N of the hits, and some read has hits in two
    assert all(len(h[0]) > 0 for h in band_hits)
    merged = list(unband.unband(
        (r for records in band_records for r in records), 16))
    expected = countmin.unband(band_hits)
    assert len(expected) < sum(len(r) for r in band_records)
    got = {reads_mod.index_of(r.name): tuple(
        (k.offset, tuple(k.abund)) for k in r.annotations) for r in merged}
    assert len(got) == len(merged)
    assert got == expected


@pytest.mark.parametrize('counter_bits', [1, 4, 8])
@pytest.mark.parametrize('maxcount', [None, 3, 200])
def test_close_in_place_is_the_copy_close(counter_bits, maxcount):
    """``tables()`` saturates the accumulator in place and packs what it
    left, the same bytes as a close that clamps a copy; then the
    accumulator is closed."""
    tablesize = 1001
    gen = torch.Generator().manual_seed(counter_bits * 1000 + (maxcount or 0))
    start = torch.randint(0, 1 << counter_bits, (4, tablesize),
                          generator=gen, dtype=torch.uint8)
    acc = sketch_ops.Accumulator(
        sketch_ops.pack_rows(start, counter_bits), counter_bits, tablesize)
    idx = torch.randint(0, tablesize, (4, 5000), generator=gen,
                        dtype=torch.int32)
    acc.add_indices(idx)
    assert int(acc.acc.max()) > sketch_ops.MAXCOUNT[counter_bits]
    top = sketch_ops.MAXCOUNT[counter_bits]
    if maxcount is not None:
        top = min(top, maxcount)
    want = sketch_ops.pack_rows(acc.acc.clamp(max=top).to(torch.uint8),
                                counter_bits)
    got = acc.tables(maxcount)
    assert torch.equal(got, want)
    assert acc.acc is None
    with pytest.raises(RuntimeError, match='closed'):
        acc.tables()
    with pytest.raises(RuntimeError, match='closed'):
        acc.add_indices(idx)


def test_sketch_close_leaves_no_accumulator():
    """A device sketch's consume ends with its packed tables and no int32
    accumulator; a second consume opens a new one."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 4, (2, 16, 100),
                                          dtype=np.uint8))
    sk = sketch.Sketch(K, 1009, 4, device='cpu')
    sk.consume_batch_stack(codes)
    assert sk._acc is None and sk.tables.dtype == torch.uint8
    once = sk.tables.clone()
    sk.consume_batch_stack(codes)
    assert sk._acc is None
    assert torch.equal(sk.tables, torch.clamp(
        once.to(torch.int32) * 2, max=255).to(torch.uint8))


@pytest.mark.parametrize('counter_bits', [1, 4, 8])
@pytest.mark.parametrize('width', [1000, 1003])
def test_pack_rows_is_the_references_pack(counter_bits, width):
    """The close's pack, byte by byte in place of one int32 word a
    counter, gives the reference's packed rows."""
    gen = torch.Generator().manual_seed(counter_bits + width)
    values = torch.randint(0, 1 << counter_bits, (4, width), generator=gen,
                           dtype=torch.uint8)
    assert torch.equal(sketch_ops.pack_rows(values, counter_bits),
                       countmin.pack(values, counter_bits))
