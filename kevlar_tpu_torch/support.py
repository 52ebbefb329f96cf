"""Host-side observability helpers (a copy of ``kevlar_tpu.support``'s
:class:`Timer` and :class:`ProgressIndicator`).

- :class:`Timer` — named wall-clock phase spans (behavioral contract:
  reference kevlar/timer.py:13-39).
- :class:`ProgressIndicator` — throttled progress logging whose update
  stride widens as the counter grows (contract: kevlar/progress.py:13-42).
"""

import time

import kevlar_tpu_torch


class Timer:
    """Wall-clock spans keyed by phase name; ``None``/'' is the anonymous
    phase. ``start`` twice on one name or ``stop``/``probe`` before
    ``start`` raise ``ValueError``."""

    def __init__(self):
        self._spans = {}  # phase name -> [t_begin, t_end_or_None]

    def start(self, key=None):
        name = key or ''
        if name in self._spans:
            raise ValueError('Timer already started for "{}"'.format(name))
        self._spans[name] = [time.perf_counter(), None]

    def _lookup(self, key):
        name = key or ''
        span = self._spans.get(name)
        if span is None:
            raise ValueError('No timer started for "{}"'.format(name))
        return span

    def stop(self, key=None):
        span = self._lookup(key)
        span[1] = time.perf_counter()
        return span[1] - span[0]

    def probe(self, key=None):
        return time.perf_counter() - self._lookup(key)[0]


class ProgressIndicator:
    """Log a templated message at geometrically decreasing frequency.

    The stride between log lines starts at ``interval`` and widens to each
    value in ``breaks`` as the counter reaches it, so early progress is
    chatty and steady-state logging is cheap. ``message`` is a format
    template with a ``{counter}`` field.
    """

    def __init__(self, message, interval=10, breaks=(100, 1000, 10000),
                 usetimer=False):
        self.counter = 0
        self._template = message
        self._stride = interval
        self._due = interval
        self._widen_points = frozenset(breaks)
        self._clock = None
        if usetimer:
            self._clock = Timer()
            self._clock.start()

    def update(self, n=1):
        if self.counter in self._widen_points:
            self._stride = self.counter
        if self.counter >= self._due:
            self._due += self._stride
            self._emit()
        self.counter += n

    def _emit(self):
        text = self._template.format(counter=self.counter)
        if self._clock is not None:
            text += ' ({:.2f} seconds elapsed)'.format(self._clock.probe())
        kevlar_tpu_torch.plog(text)
