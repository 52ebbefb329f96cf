"""The harness finds a configuration, a cell and a metric by name, as data
files; and ``BENCHMARK.json``'s metrics have their readers and move
end-to-end metrics that their cells report."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(HERE, 'data')
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

with open(os.path.join(ROOT, 'BENCHMARK.json')) as _fh:
    SPEC = json.load(_fh)

TINY = {'workloads': [{'name': 'tiny.trio-count-screen', 'config': 'tiny',
                       'traffic': 'trio-count-screen', 'chips': 1},
                      {'name': 'tiny.novel-screen', 'config': 'tiny',
                       'traffic': 'novel-screen', 'chips': 1}],
        'end_to_end': [{'name': 'tiny_reads', 'unit': 'reads'}],
        'per_layer': []}


def test_tiny_cell_found_by_name():
    entry, config, traffic = harness.cell_files('tiny.trio-count-screen',
                                                TINY, here=DATA)
    assert entry['config'] == config['name'] == 'tiny'
    assert traffic['traffic'] == 'trio-count-screen'
    assert [s['stage'] for s in traffic['step']] == ['count'] * 3 + \
        ['screen']
    cell = harness.Cell(config, traffic, 1, 'cpu')
    assert cell.ksize == 31 and cell.steps == 0


def test_tiny_metric_found_by_name():
    metrics = harness.cell_metrics('tiny.trio-count-screen', TINY,
                                   'end_to_end')
    assert [m['name'] for m in metrics] == ['tiny_reads']
    read = harness.reader('tiny_reads', here=DATA)
    assert read({'reads_per_step': 12}) == 12


def test_setup_stages_run_once_and_the_step_repeats():
    """A traffic mix that counts the trio in set-up and screens the proband
    each step: the window calls the screen alone, and the check holds the
    set-up's sketches and every screen to the reference."""
    entry, config, traffic = harness.cell_files('tiny.novel-screen', TINY,
                                                here=DATA)
    assert [s['stage'] for s in traffic['setup']] == ['count'] * 3
    cell = harness.Cell(config, traffic, 2 ** 31 + 17, 'cpu')
    cell.setup()
    cell.window(0.0)
    cell.window(0.0)
    assert cell.steps == 2
    assert cell.spans['count'] == [] and len(cell.spans['screen']) == 1
    assert cell.reads_per_step() == cell.trio.nreads['proband']
    # the two screens' texts are equal, so the cell holds one
    assert [(key, times) for key, times, _ in cell.outputs] == \
        [(('proband', None), 2)]
    checks, failed = cell.check()
    correct, _ = harness.verdict(checks, config['limits'], cell.steps)
    assert correct and failed == 0, checks
    assert checks['screens_unseen'] == 0


def test_traffic_must_match_the_cell():
    bench = json.loads(json.dumps(TINY))
    bench['workloads'][0]['traffic'] = 'another-mix'
    with pytest.raises(ValueError):
        harness.cell_files('tiny.trio-count-screen', bench, here=DATA)


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_files_exist(cell):
    entry, config, traffic = harness.cell_files(cell, SPEC)
    assert config['name'] == entry['config']
    for name in config['limits']:
        assert name.replace('_', '').isalnum()
    files = {c['name']: c['file'] for c in SPEC['configs']}
    assert os.path.join(ROOT, files[entry['config']]) == os.path.join(
        BENCH, 'configs', entry['config'] + '.json')


@pytest.mark.parametrize('metric', SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_has_reader(metric):
    assert callable(harness.reader(metric['name']))


@pytest.mark.parametrize('metric', SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_per_layer_moves_a_reported_metric(metric):
    cells = metric.get('workloads',
                       [w['name'] for w in SPEC['workloads']])
    for cell in cells:
        reported = [m['name'] for m in
                    harness.cell_metrics(cell, SPEC, 'end_to_end')]
        assert metric['moves'] in reported


def test_every_cell_reports_enough():
    for w in SPEC['workloads']:
        e2e = [m['name'] for m in
               harness.cell_metrics(w['name'], SPEC, 'end_to_end')]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert harness.cell_metrics(w['name'], SPEC, 'per_layer')
