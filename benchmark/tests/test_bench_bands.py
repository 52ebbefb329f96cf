"""A configuration run in hash bands (``bands`` in its file, an ``unband``
stage in its traffic): the tiny banded cell runs and comes out correct on
the CPU; the reference's band predicate splits the windows; banded hits
add up to the unbanded ones; faults of a banded run come out not correct;
and an unbanded cell runs as it did before bands were added."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, 'data')
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark import harness, judge  # noqa: E402
from benchmark.reference import countmin, kmers  # noqa: E402
from benchmark.traffic.trio import Trio  # noqa: E402
from kevlar_tpu_torch import novel, sketch, unband  # noqa: E402
from kevlar_tpu_torch.ops import novel_ops, sketch_ops  # noqa: E402

BANDED = 'tiny-banded.trio-count-screen-unband'
CELLS = {'workloads': [
    {'name': BANDED, 'config': 'tiny-banded',
     'traffic': 'trio-count-screen-unband', 'chips': 1},
    {'name': 'tiny.trio-count-screen', 'config': 'tiny',
     'traffic': 'trio-count-screen', 'chips': 1},
    {'name': 'tiny.novel-screen', 'config': 'tiny',
     'traffic': 'novel-screen', 'chips': 1}]}
SEED = 2 ** 31 + 23
K = 31


def files(name=BANDED):
    _, config, traffic = harness.cell_files(name, CELLS, here=DATA)
    return config, traffic


def random_codes(seed, rows, width, readlen, bad=0.01):
    rng = np.random.default_rng(seed)
    codes = np.full((rows, width), 4, dtype=np.uint8)
    codes[:, :readlen] = rng.integers(0, 4, (rows, readlen))
    codes[:, :readlen][rng.random((rows, readlen)) < bad] = 4
    return torch.from_numpy(codes)


def run(fault=None, counter_bits=None):
    """``(correct, checks, failed)`` of a one-step banded run;
    ``fault()`` breaks the timed path once set-up is done."""
    config, traffic = files()
    cell = harness.Cell(config, traffic, SEED, 'cpu', counter_bits)
    cell.setup()
    if fault:
        fault()
    cell.window(0.0)
    checks, failed = cell.check()
    correct, _ = harness.verdict(checks, config['limits'], cell.steps)
    return correct, checks, failed


def test_banded_cell_is_correct():
    config, traffic = files()
    cell = harness.Cell(config, traffic, SEED, 'cpu')
    cell.setup()
    cell.window(0.0)
    cell.window(0.0)
    spans = cell.spans       # the last window's
    assert len(spans['count']) == 4 * 3
    assert len(spans['screen']) == 4
    assert len(spans['unband']) == 1
    # each band's output and the merge, the same in both steps
    assert [(key, times) for key, times, _ in cell.outputs] == \
        [(('proband', b), 2) for b in range(4)] + \
        [(('proband', 'unband'), 2)]
    assert cell.reads_per_step() == sum(cell.trio.nreads.values())
    checks, failed = cell.check(launch_stats=True)
    correct, _ = harness.verdict(checks, config['limits'], cell.steps)
    assert correct and failed == 0, checks
    assert list(checks) == list(config['limits'])
    assert set(checks.values()) == {0}
    # the rooflines' statistics cover every band's launches of a step
    stats = cell.launch_stats
    nbatches = cell.trio.stack('proband', 2048).shape[0]
    assert len(stats['count']) == 4 * 3 * nbatches
    assert len(stats['screen']) == 4 * -(-cell.trio.nreads['proband'] //
                                         512)


def test_each_band_drops_the_last_bands_trio(monkeypatch):
    """A band's counts start with no sketch of another band alive, and
    the window leaves the last band's trio."""
    config, traffic = files()
    cell = harness.Cell(config, traffic, SEED, 'cpu')
    cell.setup()
    seen = []
    whole = harness.Cell._count

    def count(self, name, rows, warm=None):
        seen.append((self.band, sorted(self.sketches)))
        return whole(self, name, rows, warm)
    monkeypatch.setattr(harness.Cell, '_count', count)
    cell.window(0.0)
    for band, alive in seen:
        assert all(b == band for _, b in alive), (band, alive)
    assert [band for band, _ in seen] == [0, 0, 0, 1, 1, 1, 2, 2, 2,
                                          3, 3, 3]
    assert sorted(cell.sketches) == [('father', 3), ('mother', 3),
                                     ('proband', 3)]


@pytest.mark.parametrize('numbands', [2, 4, 8])
def test_every_valid_window_lies_in_one_band(numbands):
    codes = random_codes(5, 64, 160, 150)
    h1 = kmers.hashes(codes, K)[0]
    inside = torch.stack([countmin.in_band(h1, (b, numbands))
                          for b in range(numbands)])
    assert torch.equal(inside.sum(0), torch.ones_like(h1))
    # so the bands' counts add up to the unbanded count
    tablesize = 100003
    whole = countmin.count([codes], K, 4, tablesize, 255)
    parts = sum(countmin.count([codes], K, 4, tablesize, 255,
                               band=(b, numbands)).to(torch.int32)
                for b in range(numbands))
    assert int(whole.max()) < 255
    assert torch.equal(parts, whole.to(torch.int32))


def test_reference_band_is_the_ports():
    """The reference's band of a window is the one the port's count keeps
    (its plain version on the CPU)."""
    codes = random_codes(6, 32, 160, 150)
    tablesize = 20011
    for b in range(4):
        ref = countmin.count([codes], K, 4, tablesize, 255, band=(b, 4))
        sk = sketch.Sketch(K, tablesize, 4, device='cpu')
        sk.consume_batch_stack(codes[None], numbands=4, band=b)
        assert torch.equal(countmin.unpack(sk.tables, 8, tablesize), ref)


def test_union_of_banded_hits_is_the_unbanded_hits():
    """With tables so large that no two k-mers share all their buckets,
    the hits of the four bands' screens, merged, are the unbanded
    screen's hits with the same counts."""
    config, _ = files()
    trio = Trio(config, SEED, 'cpu', 2048)
    tablesize = 4000037

    def screen(band):
        tables = [countmin.count(list(trio.stack(n, 2048)), K, 4,
                                 tablesize, 255, band=band)
                  for n in ('proband', 'mother', 'father')]
        n = trio.nreads['proband']
        return countmin.screen(trio.reads['proband'][:n], tables, 1, K, 5, 1,
                               4096, band=band)
    read, offset, counts = screen(None)
    assert read.numel() > 100
    whole = countmin.unband([(read, offset, counts)])
    assert countmin.unband([screen((b, 4)) for b in range(4)]) == whole


@pytest.mark.parametrize('band', [None, (1, 4)])
def test_launch_statistics_are_each_batchs_own(band):
    """The words of each screen batch, counted 16 batches to a hashing
    pass, and the buckets each count batch touches, counted over its
    tables at once, are what each batch alone gives, one table at a
    time."""
    codes = random_codes(7, 70, 160, 150)
    tables = [countmin.count([codes[:40]], K, 4, 1009, 255),
              countmin.count([codes[30:]], K, 4, 1009, 255),
              countmin.count([codes[60:]], K, 4, 1009, 255)]
    words = []
    got = countmin.screen(codes, tables, 1, K, 1, 1, 4, words=words,
                          band=band)
    alone = []
    for start in range(0, 70, 4):
        countmin.screen(codes[start:start + 4], tables, 1, K, 1, 1, 4,
                        words=alone, band=band)
    assert words == alone and len(words) == 18 and max(words) > 0
    assert len(got[0]) > 0
    touched = []
    countmin.count([codes[:35], codes[35:]], K, 4, 1009, 255,
                   touched=touched, band=band)
    for batch, (kept, distinct) in zip((codes[:35], codes[35:]), touched):
        h1, h2, valid = kmers.hashes(batch, K)
        keep = valid if band is None else \
            valid & countmin.in_band(h1, band)
        h1, h2 = h1[keep], h2[keep]
        assert kept == h1.numel()
        assert distinct == sum(
            torch.unique(kmers.bucket(h1, h2, t, 1009)).numel()
            for t in range(4))


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_pack_is_unpacks_inverse(bits):
    values = torch.randint(0, 1 << bits, (4, 1001), dtype=torch.uint8)
    packed = countmin.pack(values, bits)
    assert torch.equal(countmin.unpack(packed, bits, 1001), values)
    assert torch.equal(packed, sketch_ops.pack_rows(values, bits))


def test_merged_text_is_judged_read_by_read():
    seq = 'ACGTACGGTTCA'

    def record(name, hits):
        lines = ['@' + name, seq, '+', 'I' * len(seq)]
        lines += ['{}{}          {}#'.format(' ' * o, seq[o:o + 5],
                                            ' '.join(map(str, c)))
                  for o, c in hits]
        return '\n'.join(lines) + '\n'

    def off(text, expected):
        return judge.compare_merged(text, expected, lambda i: seq,
                                    lambda name: int(name[1:]), 5)
    want = {1: ((2, (7, 0)), (4, (6, 1))), 2: ((0, (5, 0)),)}
    right = record('r1', want[1]) + record('r2', want[2])
    assert off(right, want) == 0
    assert off(record('r1', want[1]), want) == 1
    assert off(right + record('r3', want[2]), want) == 1
    assert off(right + record('r2', want[2]), want) == 1
    assert off(record('r1', want[1][:1]) + record('r2', want[2]), want) == 1
    assert off(record('r1', want[1][::-1]) + record('r2', want[2]),
               want) == 1
    assert off('not fastq\n', want) == 3


def band_counted_unbanded(monkeypatch):
    whole = sketch.Sketch.consume_batch_stack

    def count(self, stack, numbands=None, band=None, **kw):
        if band == 2:
            return whole(self, stack, **kw)
        return whole(self, stack, numbands=numbands, band=band, **kw)
    monkeypatch.setattr(sketch.Sketch, 'consume_batch_stack', count)


def two_bands_swapped(monkeypatch):
    whole = sketch.Sketch.consume_batch_stack

    def count(self, stack, numbands=None, band=None, **kw):
        band = {0: 1, 1: 0}.get(band, band)
        return whole(self, stack, numbands=numbands, band=band, **kw)
    monkeypatch.setattr(sketch.Sketch, 'consume_batch_stack', count)


def band_screen_dropped(monkeypatch):
    whole = novel.novel

    def screen(*a, **k):
        if k.get('band') == 1:
            return iter(())
        return whole(*a, **k)
    monkeypatch.setattr(novel, 'novel', screen)


def merge_drops_an_annotation(monkeypatch):
    whole = unband._NameBuckets._merge_one
    dropped = []

    def merge(records):
        for record in whole(records):
            if not dropped and len(record.annotations) > 1:
                dropped.append(record.annotations.pop())
            yield record
    monkeypatch.setattr(unband._NameBuckets, '_merge_one',
                        staticmethod(merge))


@pytest.mark.parametrize('fault, fails', [
    (band_counted_unbanded, ['table_digests_off']),
    (two_bands_swapped, ['table_digests_off', 'hits_missing']),
    (band_screen_dropped, ['hits_missing', 'merged_off']),
    (merge_drops_an_annotation, ['merged_off']),
], ids=lambda f: getattr(f, '__name__', ''))
def test_banded_fault_fails(monkeypatch, fault, fails):
    correct, checks, failed = run(fault=lambda: fault(monkeypatch))
    assert not correct and failed >= 1, checks
    for name in fails:
        assert checks[name] > 0, (name, checks)
    if fault is merge_drops_an_annotation:
        assert checks['merged_off'] == 1
        assert all(v == 0 for n, v in checks.items() if n != 'merged_off')


def test_banded_control_fails():
    correct, checks, _ = run(counter_bits=4)
    assert not correct and checks['table_buckets_off'] > 0


@pytest.mark.parametrize('change, message', [
    (lambda c, t: c.update(bands=3), 'power of two'),
    (lambda c, t: c.update(bands=1), 'power of two'),
    (lambda c, t: c.pop('bands'), 'needs a configuration with bands'),
    (lambda c, t: t.update(setup=t['step'][:1]), 'in its step'),
])
def test_bands_that_cannot_run_are_refused(change, message):
    config, traffic = files()
    config, traffic = dict(config), dict(traffic)
    change(config, traffic)
    with pytest.raises(ValueError, match=message):
        harness.Cell(config, traffic, SEED, 'cpu')


@pytest.mark.parametrize('name', ['tiny.trio-count-screen',
                                  'tiny.novel-screen'])
def test_unbanded_cells_run_as_before(monkeypatch, name):
    """An unbanded cell calls the port as before bands came: counts and
    screens without a band, one consume a count batch and one screen a
    screen batch, the same host spans, and the same numbers compared."""
    config, traffic = files(name)
    cell = harness.Cell(config, traffic, SEED, 'cpu')
    cell.setup()
    calls = {'consume': [], 'screen': []}
    consume, screen = sketch_ops.consume_codes, novel_ops.novel_screen_compact

    def counted_consume(acc, codes, ksize, **kw):
        calls['consume'].append((kw.get('numbands'), kw.get('band')))
        return consume(acc, codes, ksize, **kw)

    def counted_screen(*a, **kw):
        calls['screen'].append((kw.get('numbands'), kw.get('band')))
        return screen(*a, **kw)
    monkeypatch.setattr(sketch_ops, 'consume_codes', counted_consume)
    monkeypatch.setattr(novel_ops, 'novel_screen_compact', counted_screen)
    cell.window(0.0)
    counts = [s for s in traffic['step'] if s['stage'] == 'count']
    batches = sum(cell.trio.stack(s['sample'], s['rows']).shape[0]
                  for s in counts)
    screens = [s for s in traffic['step'] if s['stage'] == 'screen']
    nscreen = sum(-(-cell.trio.nreads[s['case'][0]] // s['rows'])
                  for s in screens)
    assert calls['consume'] == [(None, None)] * batches
    assert calls['screen'] == [(None, None)] * nscreen
    assert sorted({n for _, _, n in cell.host_spans}) == sorted(
        {'bench::count.' + s['sample'] for s in counts} |
        ({'bench::screen'} if screens else set()))
    assert cell.spans['unband'] == []
    checks, failed = cell.check()
    assert list(checks) == [
        'mask_buckets_off', 'table_buckets_off', 'table_digests_off',
        'hits_missing', 'hits_extra', 'hits_wrong', 'screens_unseen']
    assert set(checks.values()) == {0} and failed == 0
