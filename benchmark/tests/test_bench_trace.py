"""The trace's reduction: busy time as the union of device operations
inside the window, idle gaps put down to the host span around them."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import trace  # noqa: E402


class Event:
    def __init__(self, name, start, end, device=True):
        self._name, self._start, self._end = name, start, end
        self.device = device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


def test_reduce():
    events = [Event('void (anonymous namespace)::consume_kernel<4, true, 0>'
                    '((anonymous namespace)::ConsumeArgs)', 10, 40),
              Event('Memcpy HtoD (Pinned -> Device)', 30, 50),
              Event('screen_reads_kernel<false, 1, 4>(Args)', 70, 80),
              Event('screen_reads_kernel<false, 1, 4>(Args)', 95, 110),
              Event('a host op', 0, 100, device=False)]
    spans = [(0, 60, 'bench::count.mother'), (60, 100, 'bench::screen')]
    out = trace.reduce(events, lambda e: e.device, (0, 100), spans)
    assert out['busy_s'] == pytest.approx((40 + 10 + 5) / 1e9)
    assert out['window_s'] == pytest.approx(100 / 1e9)
    assert out['ops']['consume_kernel<4, true, 0>'] == [1, 30 / 1e9]
    assert out['ops']['screen_reads_kernel<false, 1, 4>'][0] == 2
    assert out['outside'] == 1
    # gaps 0-10, 50-70 (its middle, 60, in the screen) and 80-95
    assert out['idle']['bench::count.mother'] == pytest.approx(10 / 1e9)
    assert out['idle']['bench::screen'] == pytest.approx(35 / 1e9)
    assert out['gaps'] == 3
    top = trace.breakdown(out, top=1)
    assert top['device_ops'][0][0] == 'consume_kernel<4, true, 0>'
    assert top['idle_gaps'][0][0] == 'bench::screen'
