"""End-to-end verification drive through the port's command line; the
port's counterpart of ``tools/verify_e2e.py``.

Simulates a 20 kb genome and a trio (3 inherited and 3 de novo SNVs),
tiles ~14x of 100 bp reads a haplotype, runs count -> novel -> filter ->
partition -> alac -> simlike as ``python -m kevlar_tpu_torch`` processes,
each stage that takes ``--device`` on ``--device``, and checks the success
criterion: the PASS calls are exactly the de novo truth rows (position,
REF, ALT), each with LIKESCORE > 0.  Prints VERIFY_PASS or VERIFY_FAIL and
exits non-zero on failure.

Usage:  python -m kevlar_tpu_torch.bench.verify_e2e [--device cuda|cpu]

The work directory is a new temporary directory outside the repository,
printed on the first line and left in place.
"""

import argparse
import os
import random
import subprocess
import sys
import tempfile

from kevlar_tpu_torch.bench import DEVICE_STAGES, add_device_arg, start

PY = [sys.executable, '-m', 'kevlar_tpu_torch']
# where ``kevlar_tpu_torch`` lies, for the stages run from the work
# directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(args, device):
    """One stage as ``python -m kevlar_tpu_torch ARGS``; a failed stage
    prints its standard error and stops the drive."""
    args = list(args)
    if args[0] in DEVICE_STAGES:
        args[1:1] = ['--device', str(device)]
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (_ROOT, env.get('PYTHONPATH')) if p)
    proc = subprocess.run(PY + args, stderr=subprocess.PIPE, env=env)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr.decode())
        raise SystemExit('stage failed: ' + ' '.join(args))


def tile_reads(fasta, fastq, readlen=100, step=7):
    """Every ``readlen`` window at ``step`` of each sequence of ``fasta``
    as a FASTQ record."""
    seqs = {}
    name = None
    with open(fasta) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith('>'):
                name = line[1:]
                seqs[name] = []
            else:
                seqs[name].append(line)
    with open(fastq, 'w') as out:
        n = 0
        for name, chunks in seqs.items():
            seq = ''.join(chunks)
            for start in range(0, len(seq) - readlen + 1, step):
                read = seq[start:start + readlen]
                out.write('@r{}\n{}\n+\n{}\n'.format(n, read, 'I' * readlen))
                n += 1


def vcf_rows(path, passonly=False):
    """(CHROM, POS, REF, ALT, INFO) of each record of ``path``."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            fields = line.rstrip('\n').split('\t')
            if passonly and fields[6] != 'PASS':
                continue
            rows.append((fields[0], int(fields[1]), fields[3], fields[4],
                         fields[7]))
    return rows


def main(argv=None):
    """Run the drive; returns whether it passed, the de novo truth rows,
    the PASS calls and the work directory.  The working directory is the
    caller's again on return."""
    ap = argparse.ArgumentParser(
        description='the verify recipe through the port\'s command line')
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)

    workdir = tempfile.mkdtemp(prefix='kevlar-verify-')
    here = os.getcwd()
    os.chdir(workdir)
    try:
        return _drive(workdir, device)
    finally:
        os.chdir(here)


def _drive(workdir, device):
    print('verify workdir:', workdir, flush=True)
    rng = random.Random(4242)
    with open('genome.fa', 'w') as fh:
        fh.write('>chr1\n' +
                 ''.join(rng.choice('ACGT') for _ in range(20000)) + '\n')
    run(['gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio', '-i', '3',
         '-d', '3', '--weights', 'snv=1.0', '--seed', '11', 'genome.fa'],
        device)
    for person in ('proband', 'mother', 'father'):
        tile_reads('trio-{}.fasta'.format(person), person + '.fq')
        run(['count', '-k', '31', '-M', '8M', person + '.ct', person + '.fq'],
            device)
    run(['novel', '-k', '31', '--case', 'proband.fq', '--case-counts',
         'proband.ct', '--control-counts', 'mother.ct', 'father.ct',
         '--ctrl-max', '1', '--case-min', '6', '-o', 'novel.augfastq'],
        device)
    run(['filter', 'novel.augfastq', '-o', 'filtered.augfastq'], device)
    run(['partition', 'filtered.augfastq', '-o', 'partitioned.augfastq'],
        device)
    run(['alac', '-k', '31', 'partitioned.augfastq', 'genome.fa', '-o',
         'calls.vcf'], device)
    run(['count', '-k', '31', '-c', '4', '-M', '4M', 'refr.sct', 'genome.fa'],
        device)
    run(['simlike', '--case', 'proband.ct', '--controls', 'mother.ct',
         'father.ct', '--refr', 'refr.sct', '--mu', '28', '--sigma', '8',
         '-o', 'scored.vcf', 'calls.vcf'], device)

    truth_denovo = {(c, p, r, a) for c, p, r, a, info in vcf_rows('truth.vcf')
                    if 'GT=0/1,0/0,0/0' in info or 'GT=1/0,0/0,0/0' in info}
    passing = vcf_rows('scored.vcf', passonly=True)
    passset = {(c, p, r, a) for c, p, r, a, _ in passing}
    ok = passset == truth_denovo
    for _, _, _, _, info in passing:
        like = [kv for kv in info.split(';') if kv.startswith('LIKESCORE=')]
        if not like or float(like[0].split('=')[1]) <= 0:
            ok = False
    print('truth de novo:', sorted(truth_denovo))
    print('PASS calls:   ', sorted(passset))
    print('VERIFY_PASS' if ok else 'VERIFY_FAIL', flush=True)
    return dict(ok=ok, truth_denovo=truth_denovo, passing=passset,
                workdir=workdir)


if __name__ == '__main__':
    raise SystemExit(0 if main()['ok'] else 1)
