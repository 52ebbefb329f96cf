"""The program's spans held against the card's trace, in traced windows of
one cell: where the card's idle gaps fall among the spans, and whether the
profiler's device timeline agrees with the host's clock.  One JSON line a
window on standard output.

    python3 benchmark/span_check.py --workload chr17-30x.trio-count-screen \\
        --seed <n> --seconds 51 --windows 3

From the root of a checkout, on a card.  Each window is the harness's
traced window (``Cell.window(trace=True)``), in which the program records
its spans (``kevlar_tpu_torch.support``).  A line gives:

- ``idle``: seconds of device idle under the innermost span (the
  program's, else the harness's ``bench::`` span) covering each gap's
  midpoint, and ``screen_self_idle``, the share of the idle inside
  ``bench::screen`` that no program span covers;
- ``clock``: each ``screen_reads_kernel`` paired with its batch (in order,
  where the counts agree), the share that start after the batch's
  ``novel::screen`` opens and end before its ``novel::sync`` closes, and
  by tenths of the window the bounds that this puts on the device clock's
  offset from the host's (``lo_us`` <= offset <= ``hi_us``): a kernel
  starts no earlier than its launch, and ends before the host's wait on it
  returns.  A constant offset fits every tenth; bounds that move apart
  from tenth to tenth are drift.
"""

import argparse
import bisect
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCREEN_KERNEL = 'screen_reads_kernel'


def idle_gaps(intervals, window):
    """The ``(start, end)`` gaps between device ``intervals`` (``(start,
    end)``, any order) inside ``window``, as ``trace.reduce`` finds them."""
    w0, w1 = window
    gaps = []
    cursor = w0
    for start, end in sorted(intervals):
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < w1:
        gaps.append((cursor, w1))
    return gaps


def innermost(gaps, spans):
    """Seconds of ``gaps`` by the name of the innermost of ``spans``
    (``(start, end, name)``, nested as one thread's are) covering each
    gap's midpoint; ``outside the stages`` where none does."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = {}
    stack = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else 'outside the stages'
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out


def screen_windows(records):
    """Each ``novel::batch`` as ``(screen_start_ns, sync_end_ns)``, in
    order, from the program's spans."""
    parts = {}
    for rec in records:
        if rec.name in ('novel::screen', 'novel::sync'):
            parts.setdefault(rec.parent, {})[rec.name] = rec
    out = []
    for rec in records:
        part = parts.get(rec.id, {})
        if rec.name == 'novel::batch' and len(part) == 2:
            out.append((part['novel::screen'].start_ns,
                        part['novel::sync'].end_ns))
    return sorted(out)


def clock_check(kernels, batches, tenths=10):
    """``kernels`` (``(start, end)`` on the device timeline) against
    ``batches`` (:func:`screen_windows`): the share inside their batch's
    window, and by tenths of the batches the bounds on the device clock's
    offset, in microseconds."""
    kernels = sorted(kernels)
    if not kernels or not batches:
        return None
    if len(kernels) == len(batches):
        pairs = list(zip(kernels, batches))
    else:
        starts = [b[0] for b in batches]
        pairs = [(k, batches[max(bisect.bisect_right(starts, k[0]) - 1, 0)])
                 for k in kernels]
    inside = sum(b0 <= k0 and k1 <= b1 for (k0, k1), (b0, b1) in pairs)
    bounds = []
    size = -(-len(pairs) // tenths)
    for at in range(0, len(pairs), size):
        part = pairs[at:at + size]
        bounds.append({
            'lo_us': round(max(k1 - b1 for (_, k1), (_, b1) in part) / 1e3,
                           1),
            'hi_us': round(min(k0 - b0 for (k0, _), (b0, _) in part) / 1e3,
                           1)})
    return {'kernels': len(kernels), 'batches': len(batches),
            'paired_in_order': len(kernels) == len(batches),
            'inside': inside, 'share': inside / len(pairs),
            'offset_by_tenth': bounds,
            'fits_one_offset': max(b['lo_us'] for b in bounds) <=
            min(b['hi_us'] for b in bounds)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--windows', type=int, default=3)
    args = ap.parse_args(argv)
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    from kevlar_tpu_torch import support

    made = []

    def keep(*a, **kw):
        made.append(torch.profiler.profile(*a, **kw))
        return made[-1]

    harness.profile = keep      # the window's profiler, for its events
    bench = harness.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    _, config, traffic = harness.cell_files(args.workload, bench)
    cell = harness.Cell(config, traffic, args.seed, 'cuda')
    cell.setup()
    me = threading.get_ident()
    cuda = torch.autograd.DeviceType.CUDA
    for window in range(args.windows):
        clock = time.perf_counter()
        cell.window(args.seconds, trace=True)
        events = [e for e in made[-1].profiler.kineto_results.events()
                  if e.device_type() == cuda]
        records = support.recorded()
        device = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events]
        host = [(s, e, n) for s, e, n in cell.host_spans]
        window_ns = (min(s for s, _, _ in host), max(e for _, e, _ in host))
        spans = host + [(r.start_ns, r.end_ns, r.name) for r in records
                        if r.thread == me]
        idle = innermost(idle_gaps([d[:2] for d in device], window_ns),
                         spans)
        screen_idle = innermost(
            idle_gaps([d[:2] for d in device], window_ns),
            [s for s in spans if s[2] == 'bench::screen'])
        screen_total = screen_idle.get('bench::screen', 0.0)
        kernels = [d[:2] for d in device if SCREEN_KERNEL in d[2]]
        print(json.dumps({
            'workload': args.workload, 'seed': args.seed, 'window': window,
            'seconds': time.perf_counter() - clock,
            'card': torch.cuda.get_device_name(0), 'spans': len(records),
            'idle': dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            'screen_self_idle': idle.get('bench::screen', 0.0) /
            screen_total if screen_total else None,
            'clock': clock_check(kernels, screen_windows(records))}),
            flush=True)


if __name__ == '__main__':
    main()
