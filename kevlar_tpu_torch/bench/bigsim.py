"""Bigsim-scale accuracy and throughput run (a chr17-class trio); the
port's counterpart of ``tools/bigsim_bench.py``.

The reference's headline accuracy artifacts are VCFs and ROC curves for a
simulated chr17 hg38 trio at 10-50x coverage (truth set
``SimulatedVariants_chr17_hg38.tsv.gz``, ~1.6k de novo SNVs and indels of
5-400 bp).  Its genome and reads are not distributable, so this runs the
analog at the same scale: a simulated trio (80 Mb, 30x, SNVs,
insertions and deletions) through the whole pipeline (count -> novel ->
filter -> partition -> alac -> refr count -> simlike), every stage that
takes ``--device`` on ``--device``, and scores the calls against the
truth with the reference's own protocol (tolerance-10 interval match,
per-type/size classes, ranking by LIKESCORE).  The same seeded genome,
trio and reads as the JAX tool, the same stage arguments, the same
standard output and JSON keys.

Usage:
    python -m kevlar_tpu_torch.bench.bigsim [--genome-size 80000000]
        [--coverage 30] [--repeats] [--class-balanced] [--workdir DIR]
        [--out PATH] [--device cuda|cpu]
    python -m kevlar_tpu_torch.bench.bigsim --rescore WORKDIR [--out PATH]

The CUDA context and the libraries' builds come before the first timer.
The result is written only where ``--out`` says; ``--rescore`` without
``--out`` prints its line and writes nothing.  The reference's published
anchors (``reference_30x_scored``, ``reference_30x_operating_point``)
need the reference's bigsim notebook directory: :func:`score_reference_calls`
and :func:`reference_operating_point` take it as an argument, and the
entry, which has none, records null.  The working directory is the
caller's again when :func:`main` returns.
"""

import argparse
import json
import os
import random
import resource
import sys
import time

import numpy as np

from kevlar_tpu_torch.bench import DEVICE_STAGES, add_device_arg, start


def timed_stage(arglist, device):
    """One subcommand of the port's command line, in this process, with
    ``--device`` after the subcommand's name where it takes one; returns
    its wall seconds."""
    import kevlar_tpu_torch as kt
    import kevlar_tpu_torch.cli as cli
    arglist = [str(a) for a in arglist]
    if arglist[0] in DEVICE_STAGES:
        arglist[1:1] = ['--device', str(device)]
    args = cli.parse_args(arglist)
    mains = {name: getattr(kt, name).main
             for name in ('count', 'novel', 'filter', 'partition', 'alac',
                          'simlike', 'gentrio')}
    t0 = time.time()
    mains[arglist[0]](args)
    return time.time() - t0


# ------------------------------------------------------------ generators

def _write_fasta(path, codes):
    seq = np.frombuffer(b'ACGT', np.uint8)[codes]
    with open(path, 'wb') as fh:
        fh.write(b'>chrS\n')
        row = 1 << 20
        for i in range(0, len(seq), row):
            fh.write(seq[i:i + row].tobytes())
            fh.write(b'\n')


def simulate_genome(path, size, seed):
    """A uniform random genome of ``size`` bases as FASTA."""
    rng = np.random.default_rng(seed)
    _write_fasta(path, rng.integers(0, 4, size=size, dtype=np.uint8))


def _diverged_copies(rng, consensus, n, divergence):
    """[n, len] copies of a consensus with per-copy random substitutions."""
    copies = np.tile(consensus, (n, 1))
    mut = rng.random(copies.shape) < divergence
    rot = rng.integers(1, 4, size=int(mut.sum())).astype(np.uint8)
    copies[mut] = (copies[mut] + rot) & 3
    return copies


def simulate_repeat_genome(path, size, seed, stats=None):
    """hg38-class repeat structure instead of uniform random sequence.

    Modeled on the human genome (the reference's bigsim trio is hg38
    chr17, ~45% repeat-masked): ~10% SINE-class 300 bp elements (~12%
    divergence a copy), ~17% LINE-class elements (a 6 kb consensus,
    5'-truncated copies, ~12% divergence), ~3% simple tandem repeats
    (units of 2-50 bp, low divergence), ~5% segmental duplications (20-50
    kb blocks copied at ~2% divergence), drawn in that order.  Placements
    overlap freely (later writes win), like nested repeats.  ``stats``,
    where given, receives each class's share of the genome.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=size, dtype=np.uint8)
    placed = {}

    def place(copies, positions):
        idx = positions[:, None] + np.arange(copies.shape[1])
        genome[idx.ravel()] = copies.ravel()

    # SINE-class: 300 bp consensus, ~12% divergence per copy
    sine = rng.integers(0, 4, size=300, dtype=np.uint8)
    n_sine = int(0.10 * size / 300)
    if n_sine:
        pos = rng.integers(0, size - 300, size=n_sine)
        place(_diverged_copies(rng, sine, n_sine, 0.12), pos)
        placed['SINE'] = n_sine * 300

    # LINE-class: 6 kb consensus, 5'-truncated copies, ~12% divergence
    line = rng.integers(0, 4, size=6000, dtype=np.uint8)
    budget = int(0.17 * size)
    total = 0
    lens, starts = [], []
    while total < budget:
        ln = int(rng.integers(500, 6001))
        lens.append(ln)
        starts.append(int(rng.integers(0, size - ln)))
        total += ln
    for ln, st in zip(lens, starts):
        frag = line[6000 - ln:]  # 5' truncation keeps the 3' end
        copy = _diverged_copies(rng, frag, 1, 0.12)[0]
        genome[st:st + ln] = copy
    placed['LINE'] = total

    # simple tandem repeats: unit 2-50 bp, 2% per-unit divergence
    budget = int(0.03 * size)
    total = 0
    while total < budget:
        unit_len = int(rng.integers(2, 51))
        ncopies = int(rng.integers(10, max(11, 2000 // unit_len)))
        unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
        arr = _diverged_copies(rng, unit, ncopies, 0.02).ravel()
        st = int(rng.integers(0, size - len(arr)))
        genome[st:st + len(arr)] = arr
        total += len(arr)
    placed['tandem'] = total

    # segmental duplications: 20-50 kb blocks, ~2% divergence
    budget = int(0.05 * size)
    total = 0
    while total < budget:
        ln = int(rng.integers(20_000, 50_001))
        src = int(rng.integers(0, size - ln))
        dst = int(rng.integers(0, size - ln))
        block = _diverged_copies(rng, genome[src:src + ln].copy(), 1,
                                 0.02)[0]
        genome[dst:dst + ln] = block
        total += ln
    placed['segdup'] = total

    if stats is not None:
        stats.update({k: round(v / size, 4) for k, v in placed.items()})
    _write_fasta(path, genome)


# --------------------------------------------------------------- scorers

def truth_rows(vcffile):
    """[(pos0, type, size)] for the de novo rows of a gentrio truth VCF."""
    rows = []
    with open(vcffile) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            gt = [x.split('=', 1)[1] for x in f[7].split(';')
                  if x.startswith('GT=')][0]
            child = gt.split(',')[0]
            parents = gt.split(',')[1:]
            denovo = child in ('0/1', '1/0', '1/1') and \
                all(p == '0/0' for p in parents)
            if not denovo:
                continue
            ref, alt = f[3], f[4]
            if len(ref) == 1 == len(alt):
                rows.append((int(f[1]) - 1, 'SNV', 0))
            elif len(alt) > len(ref):
                rows.append((int(f[1]) - 1, 'INDEL', len(alt) - len(ref)))
            else:
                rows.append((int(f[1]) - 1, 'INDEL', len(ref) - len(alt)))
    return rows


SIZE_CLASSES = [('SNVs', 'SNV', 0, 0), ('INDELs 1-10bp', 'INDEL', 1, 10),
                ('INDELs 11-100bp', 'INDEL', 11, 100),
                ('INDELs 101-200bp', 'INDEL', 101, 200),
                ('INDELs 201-300bp', 'INDEL', 201, 300),
                ('INDELs 301-400bp', 'INDEL', 301, 400)]


def classify(vartype, size):
    for name, t, lo, hi in SIZE_CLASSES:
        if vartype == t and lo <= size <= hi:
            return name
    return None


def evaluate(truth, scored_vcf, tolerance=10):
    """The reference's evaluation (its bigsim notebook's evaluate.py):
    calls ranked by LIKESCORE; a call matches a truth variant when their
    tolerance-extended intervals overlap; the first match wins (later
    calls on the same variant are collisions, not new true positives)."""
    calls = []
    with open(scored_vcf) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            info = dict(kv.split('=', 1) for kv in f[7].split(';')
                        if '=' in kv)
            like = float(info.get('LIKESCORE', '-inf'))
            pos = int(f[1]) - 1
            span = max(len(f[3]), len(f[4]))
            calls.append((like, pos, pos + span, f[6]))
    calls.sort(key=lambda c: -c[0])

    per_class = {name: dict(total=0, tp=0, fp=0) for name, *_ in SIZE_CLASSES}
    for pos, vartype, size in truth:
        cls = classify(vartype, size)
        if cls:
            per_class[cls]['total'] += 1
    matched = set()
    results = []
    for like, lo, hi, filt in calls:
        if filt != 'PASS':
            continue
        hit = None
        for i, (pos, vartype, size) in enumerate(truth):
            span = max(1, size)
            if lo - tolerance < pos + span and pos - tolerance < hi:
                hit = i
                break
        if hit is None:
            # false call: binned as an SNV by its allele length
            cls = 'SNVs' if hi - lo == 1 else None
            results.append(('FP', like, cls))
        elif hit in matched:
            results.append(('collision', like, None))
        else:
            matched.add(hit)
            pos, vartype, size = truth[hit]
            results.append(('TP', like, classify(vartype, size)))
    for kind, like, cls in results:
        if kind == 'TP' and cls:
            per_class[cls]['tp'] += 1
    fps = sum(1 for kind, _, _ in results if kind == 'FP')
    tps = len(matched)
    return dict(
        per_class={k: dict(v, recall=round(v['tp'] / v['total'], 4)
                           if v['total'] else None)
                   for k, v in per_class.items()},
        tp=tps, fp=fps, collisions=sum(1 for k, _, _ in results
                                       if k == 'collision'),
        total_truth=len(truth),
        recall=round(tps / len(truth), 4) if truth else None,
        fdr=round(fps / max(1, tps + fps), 4))


def reference_operating_point(refdir=None):
    """The reference's own 30x/k31 numbers from ``roc-data.json`` in its
    bigsim notebook directory ``refdir``; None without it."""
    if refdir is None:
        return None
    path = os.path.join(refdir, 'roc-data.json')
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        roc = json.load(fh)['kevlar']['30']
    return {cls: dict(n_points=len(arr), max_tp=max(arr))
            for cls, arr in roc.items()}


def load_truth_tsv(path):
    """The reference's bigsim truth set (its
    ``SimulatedVariants_chr17_hg38.tsv.gz``) as [(pos, type, size)].
    Three columns for indels (pos, Ins/Del, size): deletions are listed by
    their last nucleotide and corrected to the first, as the reference's
    evaluation does; four for SNVs (pos, alt, ref, 'SNV')."""
    import gzip
    op = gzip.open if path.endswith('.gz') else open
    rows = []
    with op(path, 'rt') as fh:
        for line in fh:
            v = line.split()
            if not v:
                continue
            pos = int(v[0])
            if v[1] == 'Del':
                rows.append((pos - int(v[2]), 'INDEL', int(v[2])))
            elif v[1] == 'Ins':
                rows.append((pos, 'INDEL', int(v[2])))
            else:
                rows.append((pos, 'SNV', 0))
    return rows


def read_pass_calls(vcfpath):
    """PASS rows of a kevlar-vocabulary VCF as
    [(pos0, likescore, callclass, span)], in file order."""
    import gzip
    op = gzip.open if vcfpath.endswith('.gz') else open
    calls = []
    with op(vcfpath, 'rt') as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            if f[6] != 'PASS' or f[1] == '.':
                continue
            info = dict(kv.split('=', 1) for kv in f[7].split(';')
                        if '=' in kv)
            calls.append((int(f[1]) - 1,
                          float(info.get('LIKESCORE', '-inf')),
                          info.get('CALLCLASS'),
                          max(len(f[3]), len(f[4]))))
    return calls


def evaluate_reference_protocol(truth, calls, delta=10):
    """The reference's exact scoring protocol (its bigsim notebook's
    evalutils.py), so that these calls and the reference's published ones
    are scored by one scorer:

    - truth variants are point intervals at their (Del-corrected)
      positions;
    - PASS calls are compacted by CALLCLASS: within a partition the first
      call that matches the truth is kept, else the first in file order
      (the reference's compaction assumes LIKESCORE-descending order);
      calls with LIKESCORE <= 0 are dropped;
    - a call is correct when a truth point lies in [pos-delta, pos+delta);
    - a truth variant that no call hits is missing.
    """
    def hits(pos):
        return [i for i, (p, _, _) in enumerate(truth)
                if pos - delta <= p < pos + delta]

    # compact by CALLCLASS
    by_class, compacted = {}, []
    for call in calls:
        if call[2] is None:
            compacted.append(call)
        else:
            by_class.setdefault(call[2], []).append(call)
    for calllist in by_class.values():
        match = next((c for c in calllist if hits(c[0])), None)
        compacted.append(match if match is not None else calllist[0])
    compacted.sort(key=lambda c: -c[1])
    compacted = [c for c in compacted if c[1] > 0.0]

    per_class = {name: dict(total=0, tp=0) for name, *_ in SIZE_CLASSES}
    for pos, vartype, size in truth:
        cls = classify(vartype, size)
        if cls:
            per_class[cls]['total'] += 1
    found = set()
    correct = false = collisions = 0
    for pos, like, callclass, span in compacted:
        h = hits(pos)
        if not h:
            false += 1
            continue
        correct += 1
        if all(i in found for i in h):
            collisions += 1
        for i in h:
            if i not in found:
                found.add(i)
                cls = classify(truth[i][1], truth[i][2])
                if cls:
                    per_class[cls]['tp'] += 1
    tp = len(found)
    return dict(
        per_class={k: dict(v, recall=round(v['tp'] / v['total'], 4)
                           if v['total'] else None)
                   for k, v in per_class.items()},
        calls_pass=len(calls), calls_compacted=len(compacted),
        calls_correct=correct, fp=false, collisions=collisions,
        tp=tp, missing=len(truth) - tp, total_truth=len(truth),
        recall=round(tp / len(truth), 4) if truth else None,
        fdr=round(false / max(1, correct + false), 4))


def score_reference_calls(refdir=None, delta=10, k='31'):
    """The reference's own published 30x calls scored against its own
    truth set by the protocol above (the head-to-head anchor), from its
    bigsim notebook directory ``refdir``; None without it."""
    if refdir is None:
        return None
    truth_path = os.path.join(refdir, 'SimulatedVariants_chr17_hg38.tsv.gz')
    calls_path = os.path.join(refdir,
                              '30x_k{}_kevlar_calls_like.vcf.gz'.format(k))
    if not (os.path.exists(truth_path) and os.path.exists(calls_path)):
        return None
    truth = load_truth_tsv(truth_path)
    calls = read_pass_calls(calls_path)
    out = evaluate_reference_protocol(truth, calls, delta=delta)
    out['source'] = calls_path
    return out


# ----------------------------------------------------------------- entry

def main(argv=None):
    """Run the benchmark (or rescore a work directory); returns the
    result record.  The working directory is the caller's again on
    return."""
    ap = argparse.ArgumentParser(
        description='bigsim-scale trio: accuracy and stage walls')
    ap.add_argument('--genome-size', type=int, default=80_000_000)
    ap.add_argument('--coverage', type=int, default=30)
    ap.add_argument('--error', type=float, default=0.002)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--denovo', type=int, default=1500)
    ap.add_argument('--inherited', type=int, default=1000)
    ap.add_argument('--seed', type=int, default=20260820)
    ap.add_argument('--memory', default=None, help='per-sample sketch '
                    'memory (default: scaled to genome size)')
    ap.add_argument('--repeats', action='store_true',
                    help='hg38-class repeat-rich genome (SINE/LINE-class '
                         'interspersed repeats, tandem repeats, segmental '
                         'duplications) instead of uniform-random sequence')
    ap.add_argument('--class-balanced', action='store_true',
                    help="match the reference bigsim truth composition: "
                         "de novo variants ~uniform across the six "
                         "evaluation classes (SNV + indel bands "
                         "1-10/11-100/101-200/201-300/301-400 bp) instead "
                         "of gentrio's SNV-heavy default weights")
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--out', default=None,
                    help='write the result as JSON here (default: nowhere)')
    ap.add_argument('--rescore', metavar='WORKDIR', default=None,
                    help='skip simulation/pipeline; re-evaluate an existing '
                         'workdir (truth.vcf + scored.vcf) and update --out '
                         'in place, preserving its recorded walls')
    add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.rescore:
        return _rescore(args)
    device = start(args.device)
    import tempfile
    workdir = args.workdir or tempfile.mkdtemp(prefix='kevlar_bigsim_')
    os.makedirs(workdir, exist_ok=True)
    out = os.path.abspath(args.out) if args.out else None
    here = os.getcwd()
    os.chdir(workdir)
    try:
        return _run(args, device, workdir, out)
    finally:
        os.chdir(here)


def _rescore(args):
    truth = truth_rows(os.path.join(args.rescore, 'truth.vcf'))
    scored = os.path.join(args.rescore, 'scored.vcf')
    ev = evaluate(truth, scored)
    ev_refproto = evaluate_reference_protocol(truth, read_pass_calls(scored))
    result = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as fh:
            result = json.load(fh)
    result['evaluation'] = ev
    result['evaluation_reference_protocol'] = ev_refproto
    result['reference_30x_scored'] = score_reference_calls()
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({'metric': 'bigsim_recall', 'value': ev['recall'],
                      'unit': 'fraction', 'fdr': ev['fdr'],
                      'recall_reference_protocol': ev_refproto['recall']}),
          flush=True)
    if args.out:
        print('# wrote', args.out, file=sys.stderr)
    return result


def _run(args, device, workdir, out):
    from kevlar_tpu_torch.bench.sim_trio import simulate_reads, warm_up
    print('# workdir:', workdir, file=sys.stderr)

    # sketch sizing: distinct k-mers ~= genome + read errors; FPR <= ~0.05
    mem = args.memory
    if mem is None:
        distinct = args.genome_size + int(
            2 * args.genome_size * args.coverage * args.error * 31 / 2)
        mem = str(int(distinct * 6))
    print('# per-sample sketch memory:', mem, file=sys.stderr)

    # the CUDA context and the builds before the first timer: set-up, not
    # pipeline work
    t_warm = time.time()
    warm_up(device)
    print('# CUDA context and library builds in {:.1f}s (untimed '
          'set-up)'.format(time.time() - t_warm), file=sys.stderr)

    wall = {}
    t0 = time.time()
    repeat_stats = {}
    if args.repeats:
        simulate_repeat_genome('genome.fa', args.genome_size, args.seed,
                               stats=repeat_stats)
        print('# repeat composition:', repeat_stats, file=sys.stderr)
    else:
        simulate_genome('genome.fa', args.genome_size, args.seed)
    gentrio_args = ['gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio',
                    '--inherited', args.inherited, '--de-novo', args.denovo,
                    '--seed', args.seed]
    if args.class_balanced:
        # kind weights 1:2.5:2.5 put 1/6 of variants in each class: SNVs
        # get p=1/6, indels 5/6 spread uniformly over the five bands
        gentrio_args += ['--weights', 'snv=1.0,ins=2.5,del=2.5',
                         '--indel-sizes',
                         '1-10,11-100,101-200,201-300,301-400']
    timed_stage(gentrio_args + ['genome.fa'], device)
    rng = random.Random(args.seed)
    nreads = {}
    for who in ('proband', 'mother', 'father'):
        nreads[who] = simulate_reads('trio-{}.fasta'.format(who),
                                     who + '.fq', args.coverage,
                                     args.readlen, args.error,
                                     rng.randrange(1 << 30))
    wall['simulate'] = round(time.time() - t0, 1)
    print('# reads:', nreads, 'sim wall:', wall['simulate'], file=sys.stderr)

    for who, fpr in (('proband', 0.6), ('mother', 0.3), ('father', 0.3)):
        wall['count_' + who] = round(timed_stage(
            ['count', '-k', 31, '-M', mem, '--max-fpr', fpr,
             who + '.ct', who + '.fq'], device), 1)
        print('# count', who, wall['count_' + who], 's', file=sys.stderr)
    wall['novel'] = round(timed_stage(
        ['novel', '-k', 31, '--case', 'proband.fq',
         '--case-counts', 'proband.ct',
         '--control-counts', 'mother.ct', 'father.ct',
         '--ctrl-max', 1, '--case-min', 5, '--out', 'novel.augfastq'],
        device), 1)
    wall['filter'] = round(timed_stage(
        ['filter', '-M', '1G', '--max-fpr', 0.05, '--case-min', 5,
         '--out', 'filtered.augfastq', 'novel.augfastq'], device), 1)
    wall['partition'] = round(timed_stage(
        ['partition', '--out', 'partitioned.augfastq',
         'filtered.augfastq'], device), 1)
    wall['alac'] = round(timed_stage(
        ['alac', '-k', 31, '--out', 'calls.vcf', '--delta', 50,
         '--seed-size', 51, 'partitioned.augfastq', 'genome.fa'], device),
        1)
    # the 4-bit reference table needs genome-k-mer capacity only (a
    # read-error-sized table would double its bucket count)
    refr_mem = str(int(args.genome_size * 3))
    wall['refr_count'] = round(timed_stage(
        ['count', '-k', 31, '-c', 4, '-M', refr_mem, '--max-fpr', 0.5,
         'refr.sct', 'genome.fa'], device), 1)
    wall['simlike'] = round(timed_stage(
        ['simlike', '--case', 'proband.ct',
         '--controls', 'mother.ct', 'father.ct', '--refr', 'refr.sct',
         '--case-min', 5, '--mu', args.coverage,
         '--sigma', args.coverage * 0.3,
         '--out', 'scored.vcf', 'calls.vcf'], device), 1)
    for name in ('novel', 'filter', 'partition', 'alac', 'refr_count',
                 'simlike'):
        print('#', name, wall[name], 's', file=sys.stderr)

    truth = truth_rows('truth.vcf')
    ev = evaluate(truth, 'scored.vcf')
    total_wall = round(sum(wall.values()), 1)
    result = {
        'suite': 'bigsim-scale accuracy (chr17-class simulated trio)',
        'backend': device.type, 'genome_size': args.genome_size,
        'coverage': args.coverage, 'error_rate': args.error,
        'reads_per_sample': nreads, 'denovo_simulated': args.denovo,
        'denovo_in_truth': len(truth), 'sketch_memory': mem,
        'repeat_genome': bool(args.repeats),
        'repeat_composition': repeat_stats or None,
        'wall_s': wall, 'total_wall_s': total_wall,
        'evaluation': ev,
        'evaluation_reference_protocol': evaluate_reference_protocol(
            truth, read_pass_calls('scored.vcf')),
        'reference_30x_scored': score_reference_calls(),
        'reference_30x_operating_point': reference_operating_point(),
        'note': ('reference bigsim inputs (hg38 chr17 + reads) are not '
                 'distributable; this is the same-scale analog with the '
                 'same evaluation protocol (tolerance-10 interval match, '
                 'LIKESCORE ranking, per-type/size classes)'),
    }
    if out:
        with open(out, 'w') as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({'metric': 'bigsim_recall', 'value': ev['recall'],
                      'unit': 'fraction', 'fdr': ev['fdr'],
                      'total_wall_s': total_wall}), flush=True)
    print('# peak RSS: {:.1f} MB'.format(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024),
        file=sys.stderr)
    if out:
        print('# wrote', out, file=sys.stderr)
    return result


if __name__ == '__main__':
    main()
