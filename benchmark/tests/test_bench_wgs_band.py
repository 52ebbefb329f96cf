"""The human WGS trio in 8 hash bands (``wgs-30x-8band``): its
configuration and cell load through the harness's own loader at the
deployment's band sketch; and the cell's per-layer metrics read a value
from a tiny banded window recorded on the CPU, the made-up spans' values,
and None from a program that recorded no unband span."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, 'data')
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import harness, program, unband_program  # noqa: E402
from kevlar_tpu_torch import support  # noqa: E402

with open(os.path.join(ROOT, 'BENCHMARK.json')) as _fh:
    SPEC = json.load(_fh)
CELL = 'wgs-30x-8band.trio-count-screen-unband'
NEW = [m['name'] for m in SPEC['per_layer']
       if m.get('workloads') == [CELL]]
UNBAND = ['unband_spill_s', 'unband_merge_s',
          'unband_spill_bytes_per_record']
# the unbanded cells' metrics that the banded cell reads as ``<name>.band``
WHOLE = ['count_s', 'count_pack_s', 'screen_s', 'trio_reads_per_s',
         'device_idle_pct', 'kt_consume_roofline', 'kt_screen_reads_roofline',
         'screen_wait_s', 'screen_stage_s', 'screen_launch_s',
         'screen_sync_s', 'screen_readback_s', 'screen_text_s',
         'screen_self_s', 'screen_syncs_per_batch',
         'screen_h2d_bytes_per_read', 'screen_rescreens']
# the new metrics that read what the program recorded inside itself
OWN = [m['name'] for m in SPEC['per_layer'] if m['name'] in NEW and
       m['source'] in ('program_span', 'program_counter')]
MS = 10 ** 6


def test_configuration_and_cell_load_through_the_harness():
    entry, config, traffic = harness.cell_files(CELL, SPEC)
    assert entry['chips'] == 1 and entry['config'] == 'wgs-30x-8band'
    spec = [c for c in SPEC['configs'] if c['name'] == 'wgs-30x-8band'][0]
    assert (spec['source'], spec['reduced']) == (config['source'],
                                                 config['reduced'])
    # one band of a 53.2 GB sketch a sample: 4 x 1,662,499,999 buckets
    assert config['bands'] == 8
    assert harness._tablesize(config['sketch']) == 1662499999
    assert config['sketch']['memory'] * 8 == 53.2e9
    assert 'mask' not in config
    # every number of the check is held to 0, the merge's too
    assert set(config['limits'].values()) == {0}
    assert 'merged_off' in config['limits']
    assert [(s['stage'], s.get('rows')) for s in traffic['step']] == \
        [('count', 32768)] * 3 + [('screen', 4096), ('unband', None)]
    assert traffic['step'][-1]['batches'] == 16
    assert not traffic['setup']
    # chr17's genome, variants and reads, unmasked, as the cell shares
    # chr17's count and screen: 16.65M reads a sample
    _, chr17, _ = harness.cell_files('chr17-30x.trio-count-screen', SPEC)
    for key in ('ksize', 'genome', 'variants', 'reads', 'novel'):
        assert config[key] == chr17[key], key
    assert config['genome']['size'] == 83257441
    cell = harness.Cell(config, traffic, 2 ** 31 + 5, 'cpu')
    assert cell.bands == 8 and cell.unbands == ['proband']


def test_new_metrics_are_the_cells_alone():
    assert sorted(NEW) == sorted(UNBAND + ['unband_s'] + [
        name + '.band' for name in WHOLE])
    for metric in SPEC['per_layer']:
        if metric['name'] in NEW:
            assert metric['moves'] == 'peak_device_gb'


def _span(i, name, start, end, parent=None, counts=None):
    return support.Span(i, name, start * MS, end * MS, parent, 1, None,
                        counts)


def _unband_passes():
    """Two unband passes: 0-100 ms with two spills and two merges, 200-260
    ms with one of each; a novel pass between them."""
    return [
        _span(0, 'unband::pass', 0, 100, counts={
            'records_in': 30, 'records_out': 12, 'spilled_bytes': 900}),
        _span(1, 'unband::spill', 0, 20, parent=0),
        _span(2, 'unband::spill', 25, 30, parent=0),
        _span(3, 'unband::merge', 30, 60, parent=0),
        _span(4, 'unband::merge', 65, 95, parent=0),
        _span(5, 'novel::pass', 120, 150),
        _span(6, 'unband::pass', 200, 260, counts={
            'records_in': 10, 'records_out': 5, 'spilled_bytes': 300}),
        _span(7, 'unband::spill', 200, 210, parent=6),
        _span(8, 'unband::merge', 215, 255, parent=6),
    ]


@pytest.mark.parametrize('metric, value', [
    ('unband_spill_s', (25 + 10) / 2e3),
    ('unband_merge_s', (60 + 40) / 2e3),
    ('unband_spill_bytes_per_record', 1200 / 40),
])
def test_unband_reader_on_made_up_spans(metric, value, monkeypatch):
    monkeypatch.setattr(program, 'spans', _unband_passes)
    assert harness.reader(metric)({}) == pytest.approx(value)


@pytest.mark.parametrize('metric', UNBAND)
def test_unband_reader_finds_nothing_without_an_unband_pass(metric,
                                                            monkeypatch):
    monkeypatch.setattr(program, 'spans', lambda: [
        _span(0, 'novel::pass', 0, 1), _span(1, 'count::open', 1, 2)])
    assert harness.reader(metric)({}) is None


@pytest.mark.parametrize('metric', OWN)
def test_reader_of_a_program_without_the_recorder(metric, monkeypatch):
    monkeypatch.delattr(support, 'recorded')
    assert harness.reader(metric)({}) is None


@pytest.mark.parametrize('whole', WHOLE)
def test_band_reader_is_the_cells_own(whole):
    """Each ``.band`` metric reads its quantity as the unbanded cells'
    does, and is entered as theirs is but for its cell."""
    got, want = harness.reader(whole + '.band'), harness.reader(whole)
    assert got.__code__.co_filename == want.__code__.co_filename
    entries = {m['name']: m for m in SPEC['per_layer']}
    band, unbanded = entries[whole + '.band'], entries[whole]
    for key in ('unit', 'better', 'source', 'layer'):
        assert band[key] == unbanded[key], key


@pytest.fixture(scope='module')
def banded_window():
    """A one-step window of the tiny banded cell with the program's spans
    recorded, and the harness's context of the result line."""
    bench = {'workloads': [{'name': 'tiny-banded.trio-count-screen-unband',
                            'config': 'tiny-banded',
                            'traffic': 'trio-count-screen-unband',
                            'chips': 1}]}
    _, config, traffic = harness.cell_files(
        'tiny-banded.trio-count-screen-unband', bench, here=DATA)
    cell = harness.Cell(config, traffic, 2 ** 31 + 29, 'cpu')
    cell.setup()
    with support.recording():
        cell.window(0.0)
    ctx = {'window_s': cell.window_s, 'steps': cell.steps,
           'reads_per_step': cell.reads_per_step(), 'spans': cell.spans,
           'trace': None, 'launch_stats': None}
    return cell, config, ctx


def test_tiny_banded_window_gives_the_cells_metrics(banded_window):
    cell, config, ctx = banded_window
    values = {m: harness.reader(m)(ctx) for m in NEW}
    # the device trace's metrics have nothing to read on the CPU
    for m in ('device_idle_pct.band', 'kt_consume_roofline.band',
              'kt_screen_reads_roofline.band'):
        assert values.pop(m) is None
    # the CPU's screen never re-screens a batch
    assert values.pop('screen_rescreens.band') == 0
    assert all(v is not None and v > 0 for v in values.values()), values
    # the spill and the merge lie inside the stage, with the parse of the
    # band texts and the merged output's write around them
    assert values['unband_spill_s'] + values['unband_merge_s'] < \
        values['unband_s']
    (rec, seconds), = unband_program.passes()
    assert rec.counts['records_out'] <= rec.counts['records_in']
    assert set(seconds) == {'unband::spill', 'unband::merge'}
    checks, failed = cell.check()
    assert harness.verdict(checks, config['limits'], cell.steps)[0], checks


def test_tiny_banded_window_without_spans_gives_none(banded_window,
                                                     monkeypatch):
    """The program of a parent without the unband spans: the unband
    readers leave their metrics out of the line."""
    _, _, ctx = banded_window
    monkeypatch.setattr(program, 'spans', lambda: [
        s for s in support.recorded() if not s.name.startswith('unband::')])
    for metric in UNBAND:
        assert harness.reader(metric)(ctx) is None, metric
    assert harness.reader('unband_s')(dict(ctx, spans={'unband': []})) \
        is None
