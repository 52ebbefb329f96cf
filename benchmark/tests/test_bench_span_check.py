"""``benchmark/span_check.py`` on made-up traces: the gaps are those of
``trace.reduce``, each goes to the innermost span over its midpoint, and
the clock check pairs kernels with batches and bounds the device clock's
offset."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import span_check, trace  # noqa: E402
from kevlar_tpu_torch import support  # noqa: E402

US = 1000


class _Event:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def name(self):
        return 'k'

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start


def test_gaps_are_those_of_reduce():
    device = [(10, 20), (15, 30), (50, 60), (95, 120)]
    window = (0, 100)
    got = span_check.idle_gaps(device, window)
    assert got == [(0, 10), (30, 50), (60, 95)]
    reduced = trace.reduce([_Event(*d) for d in device], lambda e: True,
                           window, [])
    assert reduced['gaps'] == len(got)
    assert abs(reduced['idle']['outside the stages'] -
               sum(b - a for a, b in got) / 1e9) < 1e-15


def test_each_gap_goes_to_the_innermost_span():
    spans = [(0, 100, 'bench::screen'), (5, 95, 'novel::pass'),
             (10, 40, 'novel::batch'), (12, 20, 'novel::stage'),
             (30, 40, 'novel::text'), (60, 70, 'novel::wait')]
    gaps = [(12, 18), (20, 30), (32, 38), (41, 59), (62, 68), (96, 99),
            (101, 103)]
    got = span_check.innermost(gaps, spans)
    assert got == {'novel::stage': 6e-9, 'novel::batch': 10e-9,
                   'novel::text': 6e-9, 'novel::pass': 18e-9,
                   'novel::wait': 6e-9, 'bench::screen': 3e-9,
                   'outside the stages': 2e-9}


def _batch(i, screen, sync):
    """A ``novel::batch`` span of id ``3 * i`` with its screen and sync."""
    return [support.Span(3 * i, 'novel::batch', screen[0], sync[1], None,
                         1, None, None),
            support.Span(3 * i + 1, 'novel::screen', screen[0], screen[1],
                         3 * i, 1, None, None),
            support.Span(3 * i + 2, 'novel::sync', sync[0], sync[1], 3 * i,
                         1, None, None)]


def test_clock_check_pairs_and_bounds_the_offset():
    records = []
    for i in range(20):
        t = i * 1000 * US
        records += _batch(i, (t, t + 10 * US), (t + 20 * US, t + 200 * US))
    batches = span_check.screen_windows(records)
    assert batches[0] == (0, 200 * US) and len(batches) == 20
    # kernels 30-130 us into each batch: inside, offset in [-70, 30] us
    kernels = [(b0 + 30 * US, b0 + 130 * US) for b0, _ in batches]
    got = span_check.clock_check(kernels, batches)
    assert got['share'] == 1.0 and got['fits_one_offset']
    assert got['offset_by_tenth'][0] == {'lo_us': -70.0, 'hi_us': 30.0}
    # a device clock drifting 10 us a batch: the last ones fall outside
    drifted = [(k0 + 10 * US * i, k1 + 10 * US * i)
               for i, (k0, k1) in enumerate(kernels)]
    got = span_check.clock_check(drifted, batches)
    assert got['inside'] == 8 and not got['fits_one_offset']
    assert got['offset_by_tenth'][-1] == {'lo_us': 120.0, 'hi_us': 210.0}


def test_clock_check_without_kernels_or_batches():
    assert span_check.clock_check([], [(0, 1)]) is None
    assert span_check.clock_check([(0, 1)], []) is None
