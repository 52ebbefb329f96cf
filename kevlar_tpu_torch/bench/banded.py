"""Banded large-genome mode at scale (BASELINE config 5); the port's
counterpart of ``tools/banded_bench.py``.

The reference's banding use-case (its docs/banding.rst) is counting
memory: N passes at 1/N of the table memory each.  This runs a trio
through the complete banded pipeline at the tool's default size, a 300 Mb
genome at 30x with uncorrected-read-class sizing (6 bytes a distinct
k-mer: 5.15 GB of sketch a sample unbanded, 1.29 GB a band at 4 bands):

  per band:  count case/mother/father   (--num-bands N --band i)
             novel screen               (--num-bands N --band i)
  merge:     unband
  then:      filter -> partition -> alac -> simlike -> evaluate

simlike scores against the per-band tables directly (comma-separated
``--case``/``--controls`` lists -> ``BandedSketchView``; the reference's
simlike has no banded mode).  Every stage that takes ``--device`` runs on
``--device``.  The same seeded genome, trio and reads as the JAX tool, the
same stage arguments, standard output and JSON keys.

Per-band table bytes, peak RSS and, on a card, the device memory in use
after each count pass are recorded (``device_mb_after``); each count
pass's peak device bytes are printed on a ``#`` line of standard error.
Together they show the 1/N memory contract.

Usage:
    python -m kevlar_tpu_torch.bench.banded [--genome-size 300000000]
        [--num-bands 4] [--sample-mem 4G] [--repeats] [--workdir DIR]
        [--skip-sim] [--out PATH] [--device cuda|cpu]

The CUDA context and the libraries' builds come before the first timer.
The result is written only where ``--out`` says, and the working
directory is the caller's again when :func:`main` returns.
"""

import argparse
import json
import os
import random
import resource
import sys
import time

import torch

from kevlar_tpu_torch.bench import add_device_arg, start
from kevlar_tpu_torch.bench.bigsim import (evaluate,
                                           evaluate_reference_protocol,
                                           read_pass_calls, simulate_genome,
                                           simulate_repeat_genome,
                                           timed_stage, truth_rows)


def peak_rss_mb():
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                 1)


def device_mem_mb(device):
    """MB of device memory in use (JAX's ``memory_stats()['bytes_in_use']``);
    None on the CPU, which keeps no such count."""
    if device.type != 'cuda':
        return None
    return round(torch.cuda.memory_allocated(device) / 1e6, 1)


def main(argv=None):
    """Run the benchmark; returns the result record.  The working
    directory is the caller's again on return."""
    ap = argparse.ArgumentParser(
        description='banded trio pipeline: N passes at 1/N table memory')
    ap.add_argument('--genome-size', type=int, default=300_000_000)
    ap.add_argument('--coverage', type=int, default=30)
    ap.add_argument('--error', type=float, default=0.002)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--denovo', type=int, default=500)
    ap.add_argument('--inherited', type=int, default=300)
    ap.add_argument('--num-bands', type=int, default=4)
    ap.add_argument('--sample-mem', default=None,
                    help='UNBANDED per-sample sketch budget; each band '
                         'allocates 1/N of it (default: uncorrected-read '
                         'sizing, 6 bytes a distinct k-mer: ~17 bytes a '
                         'genome base at 30x and 0.2%% errors)')
    ap.add_argument('--seed', type=int, default=20260821)
    ap.add_argument('--repeats', action='store_true')
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--skip-sim', action='store_true',
                    help='workdir already holds genome.fa/truth.vcf/*.fq')
    ap.add_argument('--out', default=None,
                    help='write the result as JSON here (default: nowhere)')
    add_device_arg(ap)
    args = ap.parse_args(argv)

    N = args.num_bands
    if N & (N - 1):
        raise SystemExit('--num-bands must be a power of two')
    device = start(args.device)
    import tempfile
    workdir = args.workdir or tempfile.mkdtemp(prefix='kevlar_banded_')
    os.makedirs(workdir, exist_ok=True)
    out = os.path.abspath(args.out) if args.out else None
    here = os.getcwd()
    os.chdir(workdir)
    try:
        return _run(args, device, workdir, out)
    finally:
        os.chdir(here)


def _run(args, device, workdir, out):
    from kevlar_tpu_torch.bench.sim_trio import simulate_reads, warm_up
    import kevlar_tpu_torch
    import kevlar_tpu_torch.cli as cli
    N = args.num_bands
    # uncorrected-read sizing: distinct k-mers ~= genome + ~2*G*cov*err*k/2
    # error k-mers; 6 bytes/distinct keeps per-table occupancy < ~60%
    # (the reference tutorial's 36-72 GB/sample for human WGS is this
    # same rule)
    distinct = args.genome_size + int(
        2 * args.genome_size * args.coverage * args.error * 31 / 2)
    total_mem = int(cli.memory_setting(args.sample_mem)) \
        if args.sample_mem else int(distinct * 6)
    band_mem = str(int(total_mem // N))

    print('# workdir:', workdir, file=sys.stderr)
    print('# per-sample unbanded budget {:.2f} GB; per-band {:.2f} GB; '
          'trio+refr unbanded would be {:.1f} GB'.format(
              total_mem / 1e9, total_mem / N / 1e9,
              (3 * total_mem + args.genome_size * 3) / 1e9),
          file=sys.stderr)

    # the CUDA context and the builds before the first timer: set-up, not
    # pipeline work
    t_warm = time.time()
    warm_up(device)
    print('# CUDA context and library builds in {:.1f}s (untimed '
          'set-up)'.format(time.time() - t_warm), file=sys.stderr)

    wall = {}
    mem = {'band_table_bytes_per_sample': int(total_mem // N),
           'unbanded_table_bytes_per_sample': int(total_mem)}
    t0 = time.time()
    if not args.skip_sim:
        if args.repeats:
            simulate_repeat_genome('genome.fa', args.genome_size, args.seed)
        else:
            simulate_genome('genome.fa', args.genome_size, args.seed)
        timed_stage(['gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio',
                     '--inherited', args.inherited, '--de-novo',
                     args.denovo, '--seed', args.seed, 'genome.fa'], device)
        rng = random.Random(args.seed)
        for who in ('proband', 'mother', 'father'):
            n = simulate_reads('trio-{}.fasta'.format(who), who + '.fq',
                               args.coverage, args.readlen, args.error,
                               rng.randrange(1 << 30))
            print('#', who, n, 'reads', file=sys.stderr)
        wall['simulate'] = round(time.time() - t0, 1)
        print('# sim wall', wall['simulate'], file=sys.stderr)

    # banded counting: 3 samples x N bands, each pass at 1/N table memory
    for who, fpr in (('proband', 0.6), ('mother', 0.3), ('father', 0.3)):
        for band in range(1, N + 1):
            key = 'count_{}_b{}'.format(who, band)
            if device.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(device)
            wall[key] = round(timed_stage(
                ['count', '-k', 31, '-M', band_mem, '--max-fpr', fpr,
                 '--num-bands', N, '--band', band,
                 '{}.b{}.ct'.format(who, band), who + '.fq'], device), 1)
            mem.setdefault('rss_after_count_mb', {})[key] = peak_rss_mb()
            dm = device_mem_mb(device)
            if dm is not None:
                mem.setdefault('device_mb_after', {})[key] = dm
                print('# {} peak device bytes {} (band table {})'.format(
                    key, torch.cuda.max_memory_allocated(device), band_mem),
                    file=sys.stderr)
            print('#', key, wall[key], 's rss', peak_rss_mb(), 'MB',
                  file=sys.stderr)

    # banded novel screen + unband merge
    for band in range(1, N + 1):
        key = 'novel_b{}'.format(band)
        wall[key] = round(timed_stage(
            ['novel', '-k', 31, '--num-bands', N, '--band', band,
             '--case', 'proband.fq',
             '--case-counts', 'proband.b{}.ct'.format(band),
             '--control-counts', 'mother.b{}.ct'.format(band),
             'father.b{}.ct'.format(band),
             '--ctrl-max', 1, '--case-min', 5,
             '--out', 'novel.b{}.augfastq'.format(band)], device), 1)
        print('#', key, wall[key], 's', file=sys.stderr)
    t = time.time()
    uargs = cli.parse_args(
        ['unband', '--out', 'novel.augfastq'] +
        ['novel.b{}.augfastq'.format(b) for b in range(1, N + 1)])
    kevlar_tpu_torch.unband.main(uargs)
    wall['unband'] = round(time.time() - t, 1)

    wall['filter'] = round(timed_stage(
        ['filter', '-M', '1G', '--max-fpr', 0.05, '--case-min', 5,
         '--out', 'filtered.augfastq', 'novel.augfastq'], device), 1)
    wall['partition'] = round(timed_stage(
        ['partition', '--out', 'partitioned.augfastq',
         'filtered.augfastq'], device), 1)
    wall['alac'] = round(timed_stage(
        ['alac', '-k', 31, '--out', 'calls.vcf', '--delta', 50,
         '--seed-size', 51, 'partitioned.augfastq', 'genome.fa'], device), 1)
    refr_mem = str(int(args.genome_size * 3))
    wall['refr_count'] = round(timed_stage(
        ['count', '-k', 31, '-c', 4, '-M', refr_mem, '--max-fpr', 0.5,
         'refr.sct', 'genome.fa'], device), 1)

    def bandlist(who):
        return ','.join('{}.b{}.ct'.format(who, b) for b in range(1, N + 1))
    wall['simlike'] = round(timed_stage(
        ['simlike', '--case', bandlist('proband'),
         '--controls', bandlist('mother'), bandlist('father'),
         '--refr', 'refr.sct', '--case-min', 5, '--mu', args.coverage,
         '--sigma', args.coverage * 0.3,
         '--out', 'scored.vcf', 'calls.vcf'], device), 1)
    for k in ('unband', 'filter', 'partition', 'alac', 'refr_count',
              'simlike'):
        print('#', k, wall[k], 's', file=sys.stderr)

    truth = truth_rows('truth.vcf')
    ev = evaluate(truth, 'scored.vcf')
    ev_ref = evaluate_reference_protocol(truth,
                                         read_pass_calls('scored.vcf'))
    result = {
        'suite': 'banded large-genome mode (BASELINE config 5)',
        'backend': device.type,
        'genome_size': args.genome_size, 'coverage': args.coverage,
        'num_bands': N, 'per_band_memory': band_mem,
        'unbanded_memory_per_sample': int(total_mem),
        'memory': dict(mem, peak_rss_mb=peak_rss_mb()),
        'repeat_genome': bool(args.repeats),
        'wall_s': wall, 'total_wall_s': round(sum(wall.values()), 1),
        'evaluation': ev,
        'evaluation_reference_protocol': ev_ref,
        'note': ('each counting pass holds one 1/N-size band table '
                 'resident; simlike scores through BandedSketchView over '
                 'the N band files (reference analog: docs/banding.rst, '
                 'which covers count+novel only)'),
    }
    if out:
        with open(out, 'w') as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({'metric': 'banded_recall', 'value': ev['recall'],
                      'unit': 'fraction', 'fdr': ev['fdr'],
                      'num_bands': N,
                      'total_wall_s': result['total_wall_s']}), flush=True)
    if out:
        print('# wrote', out, file=sys.stderr)
    return result


if __name__ == '__main__':
    main()
