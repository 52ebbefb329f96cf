"""Host-side observability and simulation helpers (a copy of
``kevlar_tpu.support``): :class:`Timer`, :class:`ProgressIndicator` and
:class:`MutableString`, the editable character buffer of the genome
simulators (``gentrio``, ``mutate``).

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


class MutableString:
    """An editable ASCII character buffer with string-like indexing.

    Backed by a ``bytearray`` so genome-scale point edits, insertions, and
    deletions (gentrio/mutate) are O(1)/O(n) on bytes rather than on a list
    of one-character Python strings.
    """

    __slots__ = ('_buf',)

    def __init__(self, data=''):
        if isinstance(data, MutableString):
            self._buf = bytearray(data._buf)
        else:
            self._buf = bytearray(str(data), 'ascii')

    def __str__(self):
        return self._buf.decode('ascii')

    __repr__ = __str__

    def __len__(self):
        return len(self._buf)

    def __eq__(self, other):
        return str(self) == str(other)

    def __contains__(self, sub):
        return str(sub).encode('ascii') in self._buf

    def __getitem__(self, index):
        piece = self._buf[index]
        if isinstance(piece, int):
            return chr(piece)
        return piece.decode('ascii')

    def __setitem__(self, index, value):
        if isinstance(index, slice):
            self._buf[index] = str(value).encode('ascii')
        else:
            self._buf[index] = ord(str(value))

    def __delitem__(self, index):
        del self._buf[index]

    def __add__(self, tail):
        joined = MutableString()
        joined._buf = self._buf + str(tail).encode('ascii')
        return joined

    def __iadd__(self, tail):
        self._buf += str(tail).encode('ascii')
        return self
