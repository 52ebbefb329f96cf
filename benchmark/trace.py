"""The profiler's record of a traced window, reduced to what the metrics
read: device time by operation, the device's busy time and its idle gaps,
each gap put down to the host span it fell in.

The profiler records the card's activity alone (kernels, copies, fills),
which costs the host little; the harness records its own spans on the
host's clock (``time.time_ns``, the clock the profiler's timestamps are
on): the window, and each call into a layer, ``bench::count.<sample>`` and
``bench::screen``.
"""

import bisect
import re


def short_name(name):
    """A kernel's name without its return type, namespaces and arguments:
    ``consume_kernel<4, true, 0>`` for ``void (anonymous namespace)::
    consume_kernel<4, true, 0>((anonymous namespace)::ConsumeArgs)``."""
    name = re.sub(r'^void ', '', name)
    name = name.replace('(anonymous namespace)::', '')
    depth = 0
    for i, ch in enumerate(name):
        if ch == '<':
            depth += 1
        elif ch == '>':
            depth -= 1
        elif ch == '(' and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160]


def reduce(events, is_device, window, spans):
    """Reduce profiler events (``torch.profiler``'s kineto events: ``name()``,
    ``start_ns()``, ``duration_ns()``) to a dict: ``window_s``, ``busy_s``,
    ``ops`` (short name -> [launches, seconds]), ``idle`` (host span ->
    seconds of device idle inside it), ``gaps``, the number of idle gaps,
    and ``outside``, the operations that ran in part outside the window.
    ``is_device(event)`` says whether an event ran on the card; ``window``
    is the window's ``(start_ns, end_ns)`` and ``spans`` the layer spans'
    ``(start_ns, end_ns, name)``, on the same clock."""
    device = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in events if is_device(e)]
    spans = list(spans)
    w0, w1 = window
    ops = {}
    intervals = []
    outside = 0
    for start, end, name in device:
        if start < w0 or end > w1:
            outside += 1
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        entry = ops.setdefault(short_name(name), [0, 0.0])
        entry[0] += 1
        entry[1] += (end - start) / 1e9
        intervals.append((start, end))
    intervals.sort()
    busy = 0
    gaps = []
    cursor = w0
    for start, end in intervals:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if cursor < w1:
        gaps.append((cursor, w1))
    # the harness's layer spans follow one another without nesting
    spans.sort()
    starts = [s[0] for s in spans]
    idle = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        at = bisect.bisect_right(starts, mid) - 1
        where = spans[at][2] if at >= 0 and mid < spans[at][1] else \
            'outside the stages'
        idle[where] = idle.get(where, 0.0) + (g1 - g0) / 1e9
    return {'window_s': (w1 - w0) / 1e9, 'busy_s': busy / 1e9, 'ops': ops,
            'idle': idle, 'gaps': len(gaps), 'outside': outside}


def breakdown(reduced, top=10):
    """The result line's ``breakdown``: the device operations that took
    most time and the host spans the device was idle in for longest."""
    ops = sorted(reduced['ops'].items(), key=lambda kv: -kv[1][1])[:top]
    idle = sorted(reduced['idle'].items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[name, sec] for name, (_, sec) in ops],
            'idle_gaps': [[name, sec] for name, sec in idle]}
