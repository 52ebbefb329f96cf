"""Read the numbers that ``correct`` compares, over many seeds in one
process: of the system as a cell runs it, and of the control, the sample
sketches at a lower counter width (``--counter-bits 4`` for the
configurations' 8).  The limits in ``configs/`` were set from these
readings.  The benchmark's own runs never run this.

The control runs the step's counts alone: its tables already fail, and
the screen over 4-bit tables read as bytes finds some 28M hits a helium
trio, which take minutes to write out and judge.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        [--counter-bits 4]

On the card.  Each seed makes the cell's inputs anew, runs its set-up and
one step (one trio), checks it against the reference and prints one JSON
line: the seed, the counter width, whether it came out correct and the
numbers compared.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--counter-bits', type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    bench = harness.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    _, config, traffic = harness.cell_files(args.workload, bench)
    if args.counter_bits:
        traffic = dict(traffic, step=[s for s in traffic['step']
                                      if s['stage'] == 'count'])
    for seed in (int(s) for s in args.seeds.split(',')):
        start = time.perf_counter()
        cell = harness.Cell(config, traffic, seed, 'cuda',
                            args.counter_bits)
        cell.setup()
        cell.window(0.0)
        checks, failed = cell.check()
        correct, _ = harness.verdict(checks, config['limits'], cell.steps)
        print(json.dumps({'seed': seed, 'counter_bits':
                          args.counter_bits or config['sketch']
                          ['counter_bits'], 'correct': correct,
                          'steps': cell.steps, 'failed': failed,
                          'checks': checks,
                          'seconds': time.perf_counter() - start}),
              flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
