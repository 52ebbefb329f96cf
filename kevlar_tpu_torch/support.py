"""Host-side observability and simulation helpers (a copy of
``kevlar_tpu.support``): :class:`Timer`, :class:`ProgressIndicator` and
:class:`MutableString`, the editable character buffer of the genome
simulators (``gentrio``, ``mutate``); and the span recorder of the port's
stages.

- :class:`Timer` — named wall-clock phase spans (behavioral contract:
  reference kevlar/timer.py:13-39).
- :class:`ProgressIndicator` — throttled progress logging whose update
  stride widens as the counter grows (contract: kevlar/progress.py:13-42).
- :func:`span`, :func:`mark` and :func:`record` — named spans inside the
  stages (``novel::batch``, ``count::close``, ...), each with its start and
  end on ``time.time_ns()`` (the clock of ``torch.profiler``'s
  timestamps), its parent and its thread; with a device, also the
  device's interval.  They are recorded inside :func:`recording` and while
  a ``torch.profiler`` trace runs (each trace drops the spans of the one
  before), and are otherwise free: :func:`span` then returns one shared
  no-op context manager, reading no clock.  :func:`recorded` hands them
  out.  :func:`start_profile` starts the
  operator's trace (``--profile``, the workflow's ``profile`` key), in
  which every span is also a ``record_function`` range.
"""

import collections
import contextlib
import itertools
import os
import sys
import threading
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


# -- spans ------------------------------------------------------------------
Span = collections.namedtuple(
    'Span', 'id name start_ns end_ns parent thread device_s counts')
Span.__doc__ = """A recorded span: ``parent`` is the ``id`` of the span it
ran inside (None at the top of its thread), ``thread`` the recording
thread's ident, ``device_s`` the seconds between the device's marks at its
start and end (None for a host span), ``counts`` the counter differences a
:func:`record` call gave it."""

Mark = collections.namedtuple('Mark', 'id name parent start_ns')

_NOOP = contextlib.nullcontext()
# append-only while recording: plain tuples of Span's fields.  The collector
# stops tracking a tuple of numbers and strings, where a namedtuple a span
# would stay tracked and make every full collection walk all of them.
_records = []
_ids = itertools.count()
_local = threading.local()
_explicit = 0               # depth of recording() blocks
_bridge = False             # spans are record_function ranges too
_traced = False             # a profiler trace ran when last looked at


def _tracing():
    """Whether a ``torch.profiler`` trace runs (torch's own flag; none runs
    before torch is imported)."""
    profiler = sys.modules.get('torch.autograd.profiler')
    return profiler is not None and profiler._is_profiler_enabled


def _on():
    global _traced
    if _explicit:
        return True
    traced = _tracing()
    if traced != _traced:
        # a trace not seen running at the last span or reading starts
        # anew: the spans of the traces before it are dropped
        _traced = traced
        if traced:
            del _records[:]
    return traced


def _stack():
    """The ids of the current thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ('name', 'device', 'parent', 'id', 'start', 'marks',
                 'range', 'stack')

    def __init__(self, name, device, parent):
        self.name = name
        self.device = device
        self.parent = parent

    def __enter__(self):
        stack = self.stack = _stack()
        self.id = next(_ids)
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self.id)
        self.range = None
        if _bridge:
            from torch.autograd.profiler import record_function
            self.range = record_function(self.name)
            self.range.__enter__()
        self.marks = None
        if self.device is not None and self.device.type == 'cuda':
            import torch
            self.marks = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            self.marks[0].record(torch.cuda.current_stream(self.device))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        device_s = None
        if self.marks is not None:
            import torch
            self.marks[1].record(torch.cuda.current_stream(self.device))
            device_s = self.marks      # resolved by recorded()
        elif self.device is not None:
            device_s = (end - self.start) / 1e9    # the host is the device
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        _records.append((self.id, self.name, self.start, end, self.parent,
                         threading.get_ident(), device_s, None))
        return False


def span(name, device=None, parent=None):
    """A context manager recording span ``name`` while recording is on.

    ``device``, a ``torch.device``, also times the span on that device: two
    CUDA events on its current stream (no synchronise), resolved by
    :func:`recorded`; on the CPU the host interval.  ``parent`` is the
    :class:`Mark` of a span that encloses this one without being open on
    the stack (see :func:`mark`); by default the parent is the innermost
    span open on this thread.  A span must not stay open across a
    ``yield``: the caller's code would run inside it."""
    if not _on():
        return _NOOP
    return _Span(name, device, None if parent is None else parent.id)


def mark(name):
    """The start of span ``name`` that cannot stay open, such as a
    generator's, which yields inside it: pass it to :func:`record` when the
    span ends, and as ``parent`` to the spans inside it.  None while not
    recording."""
    if not _on():
        return None
    stack = _stack()
    return Mark(next(_ids), name, stack[-1] if stack else None,
                time.time_ns())


def record(started, counts=None):
    """Record the span :func:`mark` started, ending now, with ``counts``
    (a dict of counter differences over the span)."""
    if started is not None:
        _records.append((started.id, started.name, started.start_ns,
                         time.time_ns(), started.parent,
                         threading.get_ident(), None, counts))


def recorded():
    """The spans of the last :func:`recording` block, :func:`start_profile`
    trace or other ``torch.profiler`` trace, in the order they opened,
    their device intervals resolved (the device's work up to their end is
    waited for: call it after the timed region)."""
    global _traced
    _traced = _traced and _tracing()    # ended: the next trace starts anew
    out = []
    for i, rec in enumerate(_records):
        rec = Span._make(rec)
        if isinstance(rec.device_s, tuple):
            start, end = rec.device_s
            end.synchronize()
            rec = rec._replace(device_s=start.elapsed_time(end) / 1e3)
            _records[i] = tuple(rec)
        out.append(rec)
    return sorted(out, key=lambda rec: rec.id)


@contextlib.contextmanager
def recording():
    """Record spans inside the block (on every thread), dropping those of
    an earlier recording; yields the list that holds them as it ends."""
    global _explicit
    del _records[:]
    _explicit += 1
    out = []
    try:
        yield out
    finally:
        _explicit -= 1
        out.extend(recorded())


def start_profile(tracedir, cuda):
    """Start a ``torch.profiler`` trace of the host and, with ``cuda``, the
    card, for :func:`stop_profile` to write into ``tracedir``.  While it
    runs every span is also a ``record_function`` range in it."""
    global _bridge
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(tracedir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    try:
        # the producer threads' spans too
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:       # a torch that traces the starting thread alone
        config = None
    tracer = profile(activities=activities, experimental_config=config)
    del _records[:]
    tracer.__enter__()
    _bridge = True
    return tracer


def stop_profile(tracer, path):
    """Stop a :func:`start_profile` trace and write it to ``path`` as a
    chrome trace."""
    global _bridge
    _bridge = False
    tracer.__exit__(None, None, None)
    tracer.export_chrome_trace(path)
