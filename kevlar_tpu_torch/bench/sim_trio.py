"""Large simulated-trio workflow benchmark + accuracy check; the port's
counterpart of ``tools/sim_trio_bench.py``.

Simulates a genome, a trio with inherited and de novo variants, and
error-bearing reads at the requested coverage (all numpy-vectorized, the
same draws from the same seeds as ``tools/sim_trio_bench.py``), then runs
the full mark-I workflow driver (``kevlar_tpu_torch.workflow.run_mark1``
on ``--device``) and scores the PASS calls against the truth VCF.
Prints ``tools/sim_trio_bench.py``'s JSON summary line
(``"metric": "trio_workflow"``).

Presets:
  --preset helium   mirrors the reference's quick-start scenario
                    (docs/quick-start.rst: 25 Mb genome, the expected
                    output is "5 variant calls: a 300 bp insertion and
                    4 SNVs"): 25 Mb genome, 30x trio, de novo = exactly
                    4 SNVs + one 300 bp insertion.

Usage:
    python -m kevlar_tpu_torch.bench.sim_trio [--preset helium]
        [--genome-size N] [--coverage N] [--error F]
        [--threads N] [--workdir DIR] [--device cuda|cpu]

The seed index is built before the timer, as the reference's quick start
runs ``bwa index`` before its workflow, and so are the CUDA context and
the kernels' and the C++ libraries' builds.  The JAX entry raises the
batch to 16,384 reads through ``KEVLAR_BATCH_READS``; the port has no
such switch and batches 4,096 reads.  ``--device cpu`` needs small
sketches: the workflow's mask alone is 50M (a 1-bit table counted through
a 1.6 GB int32 accumulator).
"""

import argparse
import json
import os
import random
import resource
import sys
import time

import numpy as np

from kevlar_tpu_torch.bench import add_device_arg, start

_ACGT = np.frombuffer(b'ACGT', dtype=np.uint8)
_CODE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b'ACGT'):
    _CODE[_b] = _i


def write_genome(path, size, seed, width=80):
    """Random uniform genome as wrapped FASTA; returns the sequence."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=size, dtype=np.uint8)
    letters = _ACGT[codes]
    pad = (-size) % width
    rows = np.concatenate([letters, np.zeros(pad, np.uint8)])
    rows = rows.reshape(-1, width)
    out = np.full((rows.shape[0], width + 1), ord('\n'), np.uint8)
    out[:, :width] = rows
    body = out.tobytes().replace(b'\x00', b'')
    with open(path, 'wb') as fh:
        fh.write(b'>chr1\n')
        fh.write(body)
    return letters.tobytes().decode('ascii')


def _fasta_haplotypes(path):
    seqs = []
    with open(path) as fh:
        chunks = []
        for line in fh:
            if line.startswith('>'):
                if chunks:
                    seqs.append(''.join(chunks))
                chunks = []
            else:
                chunks.append(line.strip())
        if chunks:
            seqs.append(''.join(chunks))
    return seqs


def simulate_reads(fasta, out_fq, coverage, readlen, error, seed):
    """Vectorized whole-sample read simulation.

    Uniform start positions per haplotype, per-base substitution errors
    at rate ``error`` (uniform over the three other bases), fixed-width
    FASTQ records assembled as one byte matrix per chunk.
    """
    rng = np.random.default_rng(seed)
    total = 0
    chunk = 250_000
    with open(out_fq, 'wb') as out:
        for seq in _fasta_haplotypes(fasta):
            arr = _CODE[np.frombuffer(seq.encode('ascii'), np.uint8)]
            nreads = len(seq) * coverage // (2 * readlen)
            for off in range(0, nreads, chunk):
                m = min(chunk, nreads - off)
                starts = rng.integers(0, len(seq) - readlen, size=m)
                reads = arr[starts[:, None] + np.arange(readlen)]
                errs = rng.random((m, readlen)) < error
                nerr = int(errs.sum())
                if nerr:
                    rot = rng.integers(1, 4, size=nerr).astype(np.uint8)
                    reads[errs] = (reads[errs] + rot) & 3
                # fixed-width record: '@r' + 9 digits + '\n' SEQ '\n+\n'
                # QUAL '\n'
                rl = readlen
                rec = np.empty((m, 15 + 2 * rl + 1), np.uint8)
                rec[:, 0] = ord('@')
                rec[:, 1] = ord('r')
                nums = np.arange(total + 1, total + m + 1, dtype=np.int64)
                for j in range(9):
                    rec[:, 2 + j] = (nums // 10 ** (8 - j)) % 10 + ord('0')
                rec[:, 11] = ord('\n')
                rec[:, 12:12 + rl] = _ACGT[reads]
                rec[:, 12 + rl] = ord('\n')
                rec[:, 13 + rl] = ord('+')
                rec[:, 14 + rl] = ord('\n')
                rec[:, 15 + rl:15 + 2 * rl] = ord('I')
                rec[:, 15 + 2 * rl] = ord('\n')
                out.write(rec.tobytes())
                total += m
    return total


def helium_trio(genome, ninh, seed, ksize=31):
    """The quick-start scenario's exact de novo composition: 4 SNVs and
    one 300 bp insertion (heterozygous in the proband, absent in both
    parents), on top of ``ninh`` random inherited variants."""
    from kevlar_tpu_torch import gentrio as g
    from kevlar_tpu_torch.vcf import Variant

    rng = random.Random(seed)
    seqs = {'chr1': genome}
    variants = list(g.simulate_variant_genotypes(
        seqs, ninh=ninh, ndenovo=0, rng=rng))
    glen = len(genome)
    spots = sorted(rng.sample(range(glen // 20, glen - glen // 20), 5))
    for idx, pos in enumerate(spots):
        if idx < 4:
            alleles = g.mutate_snv(genome, pos, rng.randint(1, 3), ksize)
        else:
            src = rng.randint(0, glen - 400)
            alleles = g.mutate_insertion(genome, pos, 300, src, rng, ksize)
        refr, alt, refrwin, altwin = alleles
        var = Variant('chr1', pos, refr, alt, ALTWINDOW=altwin,
                      REFRWINDOW=refrwin)
        var.annotate('GT', '{},0/0,0/0'.format(rng.choice(['0/1', '1/0'])))
        variants.append(var)
    return variants


def write_trio(genome, variants, prefix, truthvcf):
    """Haplotype FASTAs for proband/mother/father + the truth VCF."""
    import kevlar_tpu_torch
    from kevlar_tpu_torch import gentrio as g

    ordered = sorted(variants, key=lambda v: v.position, reverse=True)
    for person, who in enumerate(('proband', 'mother', 'father')):
        with open('{}-{}.fasta'.format(prefix, who), 'w') as fh:
            haplos = g._haplotype_pair(genome, 'chr1', ordered, person)
            for hapnum, hap in enumerate(haplos, 1):
                print('>chr1_haplo', hapnum, '\n', hap, sep='', file=fh)
    with kevlar_tpu_torch.open(truthvcf, 'w') as fh:
        kevlar_tpu_torch.vcf_header(fh, source='kevlar::gentrio',
                                    infoheader=True)
        for var in sorted(variants, key=lambda v: (v.seqid, v.position)):
            print(var.vcf, file=fh)


def denovo_truth(truthvcf):
    """(pos, refr, alt) of rows with de novo genotypes (child het,
    parents hom-ref)."""
    rows = []
    with open(truthvcf) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.split('\t')
            if 'GT=' not in f[7]:
                continue
            gtfield = [x for x in f[7].split(';')
                       if x.startswith('GT=')][0][3:]
            gts = gtfield.replace('|', '/').split(',')
            child, parents = gts[0], gts[1:]
            if sorted(child.split('/')) != ['0', '1']:
                continue
            if any(p != '0/0' for p in parents):
                continue
            rows.append((int(f[1]) - 1, f[3], f[4]))
    return rows


def score_calls(truthvcf, finalvcf):
    """Score the PASS calls of ``finalvcf`` against the de novo rows of
    ``truthvcf``: a truth row is found, and a call is true, when a call
    and the row lie within 10 bp and change the length by the same
    amount.  Returns (found, false positives, PASS calls)."""
    import kevlar_tpu_torch
    truth = denovo_truth(truthvcf)
    calls = []
    with kevlar_tpu_torch.open(finalvcf, 'r') as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.split('\t')
            if f[6] != 'PASS':
                continue
            calls.append((int(f[1]) - 1, f[3], f[4]))
    found = 0
    for pos, ref, alt in truth:
        hit = any(abs(cp - pos) <= 10 and
                  (len(cr) - len(ca)) == (len(ref) - len(alt))
                  for cp, cr, ca in calls)
        found += bool(hit)
    fps = 0
    for cp, cr, ca in calls:
        hit = any(abs(cp - pos) <= 10 and
                  (len(cr) - len(ca)) == (len(ref) - len(alt))
                  for pos, ref, alt in truth)
        fps += not hit
    return found, fps, calls


def warm_up(device):
    """The CUDA context and every library's build, before the timer (the
    JAX entry's device ping): the three kernel sources with nvcc and the
    assembler, the reader and the aligner with g++, all at once.  On the
    CPU only the C++ libraries."""
    from concurrent.futures import ThreadPoolExecutor
    from kevlar_tpu_torch import native
    builds = [native.build, native.build_fastx, native.build_align]
    if device.type == 'cuda':
        import torch
        from kevlar_tpu_torch.ops import align_cuda, cc_cuda, kmer_cuda
        torch.zeros(1, device=device)
        builds += [align_cuda.build, kmer_cuda.build, cc_cuda.build]
    with ThreadPoolExecutor(len(builds)) as pool:
        for future in [pool.submit(fn) for fn in builds]:
            future.result()


def main(argv=None):
    """Run the benchmark; returns the printed summary."""
    ap = argparse.ArgumentParser(
        description='simulated-trio workflow wall and de novo accuracy')
    ap.add_argument('--preset', choices=('helium',), default=None)
    ap.add_argument('--genome-size', type=int, default=None)
    ap.add_argument('--coverage', type=int, default=None)
    ap.add_argument('--error', type=float, default=0.005)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--inherited', type=int, default=None)
    ap.add_argument('--denovo', type=int, default=11)
    ap.add_argument('--seed', type=int, default=20260818)
    ap.add_argument('--threads', type=int, default=4)
    ap.add_argument('--sketch-mem', default=None)
    ap.add_argument('--workdir', default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)

    helium = args.preset == 'helium'
    defaults = ((25_000_000, 30, 20) if helium else (1_000_000, 25, 10))
    if args.genome_size is None:
        args.genome_size = defaults[0]
    if args.coverage is None:
        args.coverage = defaults[1]
    if args.inherited is None:
        args.inherited = defaults[2]
    sketchmem = args.sketch_mem or (
        '500M' if args.genome_size > 4_000_000 else '100M')

    import tempfile
    workdir = args.workdir or tempfile.mkdtemp(prefix='kevlar_trio_')
    os.makedirs(workdir, exist_ok=True)
    here = os.getcwd()
    os.chdir(workdir)
    try:
        return _run(args, device, helium, sketchmem, workdir)
    finally:
        os.chdir(here)


def _run(args, device, helium, sketchmem, workdir):
    print('# workdir:', workdir, file=sys.stderr)
    t_all = time.time()

    # 1. genome + trio haplotypes + truth VCF
    genome = write_genome('genome.fa', args.genome_size, args.seed)
    if helium:
        variants = helium_trio(genome, args.inherited, args.seed)
        write_trio(genome, variants, 'trio', 'truth.vcf')
    else:
        import kevlar_tpu_torch.cli as cli
        import kevlar_tpu_torch.gentrio as gentrio_mod
        gargs = cli.parse_args([
            'gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio',
            '--inherited', str(args.inherited),
            '--de-novo', str(args.denovo),
            '--seed', str(args.seed), 'genome.fa'])
        gentrio_mod.main(gargs)
    del genome
    print('# simulated trio in {:.1f}s'.format(time.time() - t_all),
          file=sys.stderr)

    # 2. reads
    t_rd = time.time()
    for i, who in enumerate(('proband', 'mother', 'father')):
        nr = simulate_reads('trio-{}.fasta'.format(who), who + '.fq',
                            args.coverage, args.readlen, args.error,
                            args.seed + 7 * i)
        print('# {}: {} reads'.format(who, nr), file=sys.stderr)
    print('# simulated reads in {:.1f}s'.format(time.time() - t_rd),
          file=sys.stderr)

    # 3. workflow
    config = {
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
        'simlike': {'mu': args.coverage, 'sigma': args.coverage * 0.3,
                    'epsilon': 0.001},
        'threads': args.threads,
        'device': str(device),
    }
    # the reference's quick start runs `bwa index refr.fa.gz` in its
    # untimed setup block (docs/quick-start.rst) before invoking the timed
    # snakemake workflow; our analog is the persistent seed index
    from kevlar_tpu_torch.reference import autoindex
    t_idx = time.time()
    autoindex('genome.fa', config['localize']['seed_size'], device=device)
    index_wall = time.time() - t_idx
    print('# seed index built in {:.1f}s (untimed setup, as the '
          'reference quick-start does bwa index)'.format(index_wall),
          file=sys.stderr)

    # the CUDA context and the builds before the timer: set-up, not
    # pipeline work (the per-stage walls are unchanged by it)
    t_warm = time.time()
    warm_up(device)
    print('# CUDA context and library builds in {:.1f}s (untimed '
          'set-up)'.format(time.time() - t_warm), file=sys.stderr)

    from kevlar_tpu_torch.workflow import run_mark1
    t0 = time.time()
    finalvcf = run_mark1(config)
    wall = time.time() - t0

    # 4. score against truth
    found, fps, calls = score_calls('truth.vcf', finalvcf)
    stages = dict(getattr(run_mark1, 'last_stage_times', []) or [])
    summary = {
        'metric': 'trio_workflow',
        'preset': args.preset,
        'stage_wall_s': stages,
        'genome_size': args.genome_size,
        'coverage': args.coverage,
        'error_rate': args.error,
        'denovo_found': found,
        'denovo_total': len(denovo_truth('truth.vcf')),
        'pass_calls': len(calls),
        'false_positives': fps,
        'workflow_wall_s': round(wall, 1),
        'seed_index_wall_s': round(index_wall, 1),
        'total_wall_s': round(time.time() - t_all, 1),
        'peak_rss_mb': round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == '__main__':
    main()
