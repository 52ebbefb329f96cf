"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell's inputs are made on the card from
``--seed``; the window runs the cell's steps back to back for at least
``--seconds``; what it produced is then checked against the plain
reference under ``benchmark/reference/``.  The last line of standard
output is one JSON object: ``correct``, ``attempted`` and ``failed``
(trios), ``metrics`` (the cell's ``end_to_end`` metrics, or with ``--trace
1`` its ``per_layer`` metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit.
The same numbers close standard error.  The run exits non-zero, printing
no result, where the card is missing, where the system under test cannot
be imported from this checkout, or where JAX or the JAX package is loaded.
"""

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'kevlar_tpu')


def fail(code, message):
    print('benchmark: ' + message, file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split('.')[0] for name in sys.modules
                   if name.split('.')[0] in FORBIDDEN})


def power_limit():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or
    None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits', '-i', '0'],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches inside the checkout, at fixed paths
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_ext')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')

    sys.path.insert(0, ROOT)
    from benchmark import harness
    from benchmark import trace as trace_mod
    bench = harness.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    entry, config, traffic = harness.cell_files(args.workload, bench)

    import torch
    if not torch.cuda.is_available():
        fail(3, 'no CUDA device')
    if torch.cuda.device_count() < int(entry['chips']):
        fail(3, 'the cell needs {} cards, {} found'.format(
            entry['chips'], torch.cuda.device_count()))
    try:
        import kevlar_tpu_torch
    except ImportError as exc:
        fail(4, 'the system under test is not in this checkout: {}'.format(
            exc))
    where = os.path.dirname(os.path.abspath(kevlar_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        fail(4, 'kevlar_tpu_torch was loaded from {}, not this checkout'
             .format(where))

    cell = harness.Cell(config, traffic, args.seed, 'cuda')
    started = time.perf_counter() - _START
    cell.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - _START
    cell.window(args.seconds, trace=bool(args.trace))
    memory_peak = torch.cuda.max_memory_allocated()
    found = forbidden_modules()
    if found:
        fail(5, 'loaded after the window: ' + ', '.join(found))
    checked = time.perf_counter()
    checks, failed = cell.check(launch_stats=bool(args.trace))
    checked = time.perf_counter() - checked
    limits = config['limits']
    print('benchmark: set-up {:.3f} s (start {:.3f}, {}); window {:.3f} s, '
          '{} steps; check {:.3f} s{}'.format(
              setup_s, started, ', '.join(
                  '{} {:.3f}'.format(k, v)
                  for k, v in cell.setup_parts.items()),
              cell.window_s, cell.steps, checked,
              '' if cell.trace is None else
              '; {} device operations partly outside the window'.format(
                  cell.trace['outside'])), file=sys.stderr)
    print('benchmark: spans {}; launches {}'.format(
        json.dumps(cell.spans),
        {k: v for k, v in cell.launches.items() if v}), file=sys.stderr)

    ctx = {'setup_s': setup_s, 'window_s': cell.window_s,
           'steps': cell.steps, 'reads_per_step': cell.reads_per_step(),
           'peak_window_bytes': cell.peak_window, 'spans': cell.spans,
           'trace': cell.trace, 'launch_stats': cell.launch_stats,
           'launches': cell.launches,
           'device_kind': torch.cuda.get_device_name(0)}
    kind = 'per_layer' if args.trace else 'end_to_end'
    metrics = {}
    for metric in harness.cell_metrics(args.workload, bench, kind):
        value = harness.reader(metric['name'])(ctx)
        if value is None:
            print('benchmark: {} found nothing to read'.format(
                metric['name']), file=sys.stderr)
            continue
        metrics[metric['name']] = {'value': value, 'unit': metric['unit']}
    device = {'platform': 'gpu', 'kind': ctx['device_kind'], 'count': 1,
              'memory_peak_bytes': memory_peak,
              'power_limit_w': power_limit()}
    correct, compared = harness.verdict(checks, limits, cell.steps)
    result = {'correct': correct, 'attempted': cell.steps, 'failed': failed,
              'metrics': metrics, 'device': device}
    if args.trace and cell.trace:
        device['busy_s'] = cell.trace['busy_s']
        device['window_s'] = cell.trace['window_s']
        result['breakdown'] = trace_mod.breakdown(cell.trace)
    result['checks'] = compared
    found = forbidden_modules()
    if found:
        fail(5, 'loaded: ' + ', '.join(found))
    for name, c in compared.items():
        print('check {} {} limit {}'.format(name, c['value'], c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
