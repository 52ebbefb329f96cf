"""The per-layer metrics that read the spans and counters the system under
test records inside itself (``benchmark/program.py``): each reader on spans
made up here; None from a program without the recorder; and a value for
every one from the tiny cell's window recorded on the CPU."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, 'data')
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import harness, program  # noqa: E402
from kevlar_tpu_torch import support  # noqa: E402

with open(os.path.join(ROOT, 'BENCHMARK.json')) as _fh:
    SPEC = json.load(_fh)
PROGRAM = [m['name'] for m in SPEC['per_layer']
           if m['source'] in ('program_span', 'program_counter')]
MS = 10 ** 6


def _span(i, name, start, end, parent=None, device_s=None, counts=None):
    return support.Span(i, name, start * MS, end * MS, parent, 1, device_s,
                        counts)


def _passes():
    """Two novel passes (0-100 ms, two batches, the second re-screened;
    200-250 ms, one batch), a producer's read, and two counts."""
    out = [_span(0, 'novel::pass', 0, 100, counts={
        'batches': 2, 'reads': 8, 'rescreens': 1,
        'h2d_bytes': 800, 'syncs': 12})]
    i = 1
    for batch, waits, parts in (
            ((10, 60), (0, 10), [('stage', 10, 15), ('screen', 15, 20),
                                 ('sync', 20, 30), ('readback', 30, 35),
                                 ('text', 35, 55)]),
            ((65, 95), (60, 65), [('stage', 65, 70), ('screen', 70, 72),
                                  ('sync', 72, 74), ('rescreen', 74, 80),
                                  ('readback', 80, 82), ('text', 82, 92)])):
        out.append(_span(i, 'novel::wait', *waits, parent=0))
        out.append(_span(i + 1, 'novel::batch', *batch, parent=0))
        out += [_span(i + 2 + j, 'novel::' + name, a, b, parent=i + 1)
                for j, (name, a, b) in enumerate(parts)]
        i += 2 + len(parts)
    out.append(_span(i, 'novel::pass', 200, 250, counts={
        'batches': 1, 'reads': 4, 'rescreens': 0,
        'h2d_bytes': 400, 'syncs': 6}))
    out.append(_span(i + 1, 'novel::wait', 200, 210, parent=i))
    out.append(_span(i + 2, 'novel::batch', 210, 240, parent=i))
    out += [_span(i + 3 + j, 'novel::' + name, a, b, parent=i + 2)
            for j, (name, a, b) in enumerate([
                ('stage', 210, 212), ('screen', 212, 214),
                ('sync', 214, 216), ('readback', 216, 218),
                ('text', 218, 238)])]
    i += 8
    out.append(_span(i, 'novel::read', 5, 30))
    out.append(_span(i + 1, 'count::open', 300, 301, device_s=0.5))
    out.append(_span(i + 2, 'count::consume', 301, 305, device_s=3.0))
    out.append(_span(i + 3, 'count::close', 305, 307, device_s=1.5))
    out.append(_span(i + 4, 'count::open', 310, 311, device_s=0.7))
    out.append(_span(i + 5, 'count::close', 315, 317, device_s=1.3))
    return out


EXPECTED = {
    'screen_wait_s': (15 + 10) / 2e3,
    'screen_stage_s': (10 + 2) / 2e3,
    'screen_launch_s': (7 + 2) / 2e3,
    'screen_sync_s': (18 + 2) / 2e3,
    'screen_readback_s': (7 + 2) / 2e3,
    'screen_text_s': (30 + 20) / 2e3,
    # 100 ms less the 87 its parts cover; 50 less 38
    'screen_self_s': (13 + 12) / 2e3,
    'screen_syncs_per_batch': 18 / 3,
    'screen_h2d_bytes_per_read': 1200 / 12,
    'screen_rescreens': 1 / 2,
    'count_pack_s': 2.0,
    'count_pack_s.count': 2.0,
}


def test_every_program_metric_is_tested_here():
    assert sorted(PROGRAM) == sorted(EXPECTED)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_reader_on_made_up_spans(metric, monkeypatch):
    monkeypatch.setattr(program, 'spans', _passes)
    assert harness.reader(metric)({}) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_reader_of_a_program_without_the_recorder(metric, monkeypatch):
    monkeypatch.delattr(support, 'recorded')
    assert harness.reader(metric)({}) is None


def test_readers_find_nothing_without_a_pass_or_a_count(monkeypatch):
    monkeypatch.setattr(program, 'spans', lambda: [
        _span(0, 'novel::read', 0, 1)])
    for metric in PROGRAM:
        assert harness.reader(metric)({}) is None, metric


def test_tiny_window_recorded_gives_every_program_metric():
    bench = {'workloads': [{'name': 'tiny.trio-count-screen',
                            'config': 'tiny', 'traffic': 'trio-count-screen',
                            'chips': 1}]}
    _, config, traffic = harness.cell_files('tiny.trio-count-screen', bench,
                                            here=DATA)
    cell = harness.Cell(config, traffic, 2 ** 31 + 23, 'cpu')
    cell.setup()
    with support.recording():
        cell.window(0.0, trace=True)
    values = {m: harness.reader(m)({}) for m in PROGRAM}
    assert all(v is not None and v >= 0 for v in values.values()), values
    # the CPU's ring never waits: the lengths, the hit count, three copies
    assert values['screen_syncs_per_batch'] == 5
    assert values['screen_rescreens'] == 0
    (pass_, _, _), = program.screen_passes()
    parts = sum(values['screen_{}_s'.format(p)] for p in (
        'wait', 'stage', 'launch', 'sync', 'readback', 'text', 'self'))
    assert parts == pytest.approx((pass_.end_ns - pass_.start_ns) / 1e9)
    checks, failed = cell.check()
    assert harness.verdict(checks, config['limits'], cell.steps)[0]
