"""The mark-I workflow alone on an existing helium work directory; the
port's counterpart of ``tools/helium_workflow_only.py``.

Separates the workflow's own wall and peak RSS from the simulator's (the
simulation and the seed index are the reference quick start's untimed
preamble).  The work directory is the one that ``python -m
kevlar_tpu_torch.bench.sim_trio --preset helium --workdir DIR`` leaves:
``genome.fa`` (with its seed index) and ``{proband,mother,father}.fq``.
Runs ``kevlar_tpu_torch.workflow.run_mark1`` there on ``--device`` with
the helium configuration and prints one JSON line: the wall, the
process's peak RSS, the PASS calls of the final VCF and each stage's
wall.

Usage:  python -m kevlar_tpu_torch.bench.helium_workflow_only WORKDIR
        [COVERAGE] [--device cuda|cpu]

The CUDA context and the libraries' builds come before the timer, as the
JAX entry's device ping does.  The workflow writes into ``WORKDIR/out``.
"""

import argparse
import gzip
import json
import os
import resource
import sys
import time

from kevlar_tpu_torch.bench import add_device_arg, start


def helium_config(coverage, device):
    """The JAX entry's configuration, key for key, and the port's
    ``device``."""
    sketchmem = '500M'
    return {
        'ksize': 31,
        'outdir': 'out',
        'reference': {'fasta': 'genome.fa'},
        'case': {'fastx': ['proband.fq'], 'label': 'Proband',
                 'memory': sketchmem, 'max_fpr': 0.6},
        'controls': [
            {'fastx': ['mother.fq'], 'label': 'Mother',
             'memory': sketchmem, 'max_fpr': 0.2},
            {'fastx': ['father.fq'], 'label': 'Father',
             'memory': sketchmem, 'max_fpr': 0.2},
        ],
        'mask': {'memory': '50M', 'max_fpr': 0.01},
        'novel': {'case_min': 5, 'ctrl_max': 1},
        'localize': {'seed_size': 51, 'delta': 50},
        'simlike': {'mu': coverage, 'sigma': coverage * 0.3,
                    'epsilon': 0.001},
        'threads': 1,
        'device': str(device),
    }


def count_pass(vcf_gz):
    """PASS records of a gzipped VCF."""
    npass = 0
    with gzip.open(vcf_gz, 'rt') as fh:
        for line in fh:
            if not line.startswith('#') and '\tPASS\t' in line:
                npass += 1
    return npass


def main(argv=None):
    """Run the workflow; returns the printed record.  The working
    directory is the caller's again on return."""
    ap = argparse.ArgumentParser(
        description='the mark-I workflow alone on a helium work directory')
    ap.add_argument('workdir')
    ap.add_argument('coverage', type=float, nargs='?', default=30)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)

    here = os.getcwd()
    os.chdir(args.workdir)
    try:
        return _run(helium_config(args.coverage, device), device)
    finally:
        os.chdir(here)


def _run(config, device):
    from kevlar_tpu_torch import workflow
    from kevlar_tpu_torch.bench.sim_trio import warm_up
    t_ping = time.time()
    warm_up(device)
    print('# CUDA context and library builds in {:.1f}s (untimed '
          'set-up)'.format(time.time() - t_ping), file=sys.stderr)
    t0 = time.time()
    final = workflow.run_mark1(config)
    wall = round(time.time() - t0, 1)
    rss = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                1)
    stages = dict(getattr(workflow.run_mark1, 'last_stage_times', []))
    record = {'metric': 'helium_workflow_only', 'wall_s': wall,
              'peak_rss_mb': rss, 'pass_calls': count_pass(final),
              'stage_wall_s': stages}
    print(json.dumps(record), flush=True)
    return record


if __name__ == '__main__':
    main()
