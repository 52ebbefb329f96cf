#!/usr/bin/env python3
"""GPU smoke run of kevlar_tpu_torch: build, check and drive its slices.

    python3 chip_smoke.py        # needs one CUDA GPU; about 15 minutes

Phases (any failure raises, and the script exits non-zero):

1. card: a CUDA device must be present; print its name and power limit;
2. build: ``csrc/align.cu``, ``csrc/kmer.cu`` and ``csrc/cc.cu`` with nvcc
   for sm_90a, the C++ assembler and the FASTA/FASTQ reader with g++, all
   five compilers started together, into the package's build directory;
   print the seconds each took;
3. kernel: the ksw_extz kernel against its plain PyTorch version on the
   card, on seeded pairs at the call stage's shapes (targets 100-2,000 bp,
   queries 100-1,000 bp, a few 10,000 bp targets, one pair whose wavefront
   state needs global memory, N bases, tandem-repeat ties) under gap
   penalties (5,0), (5,2) and (3,1): scores, op streams and exit cells must
   be identical (tolerance 0: the DP is integer arithmetic);
4. alac slice: :func:`make_alac_case` writes a bigsim-scale input (80 Mb
   reference, 1,500 de novo loci in the bigsim class mix, 150 bp reads at
   15x from the alt haplotype, one ``kvcc=`` partition per locus); the seed
   index is built apart (timed), then ``kevlar_tpu_torch.cli.main(['alac',
   ..., '--device', 'cuda'])`` runs the slice.  Every pair the run aligned
   is aligned again with the plain version on the card (results must be
   identical, and both are timed), the kernel's launch count over the run
   must be positive, and the VCF is scored against the truth: recall below
   0.90 fails;
5. count kernels: K1 (k-mer hashing) at k = 21, 31, 33 and 51 with N bases
   and row lengths that are not a multiple of 4 or 8, K2 (count gather) at
   1, 4 and 8 bits with odd table sizes, and K3 (scatter-add) with heavy
   duplicates and negative indices, each against its plain PyTorch version
   on the card (tolerance 0: integer arithmetic), then timed against it at
   the helium run's shapes;
6. count -> novel slice: :func:`make_trio_case` writes the helium trio
   (the reference's quick-start: 25 Mb genome, 30x trio of 150 bp reads
   with 0.5% errors, 20 inherited and 5 de novo variants), and the trio
   workflow's first steps run through ``kevlar_tpu_torch.cli.main`` with
   ``--device cuda``: the reference mask (1-bit, 50M), the reference count
   (4-bit, 50M), the masked 8-bit counts of the three samples (500M each)
   and the novel screen (``--case-min 5 --ctrl-max 1``).  Every count
   kernel's launch count over that run must be positive; the mask, refr and
   proband tables and the novel text must equal those of the same commands
   run with the plain versions on the card; and each de novo locus must
   have a novel read whose annotated k-mer spans it.  Stage walls, reads
   per second and the novel output's size are printed;
7. K4 (read-graph label propagation) against its plain PyTorch version on
   the card: seeded random incidences, a chain of 5,000 reads (diameter in
   the thousands), isolated reads, single-read k-mers and duplicate pairs,
   E = 0 and E = 1 (labels identical: tolerance 0), then both timed on
   phase 8's incidence (so phase 7 runs after phase 8);
8. partition at bigsim scale: phase 4's reads with their ``kvcc=`` labels
   stripped go through ``cli.main(['partition', ..., '--device',
   'cuda'])``.  The read-k-mer pair count must reach
   ``HOST_CC_THRESHOLD`` (so K4 runs, as in ``kevlar_tpu`` the device
   program), K4's launch count must be positive, its labels must equal the
   plain version's on the card, and every partition must hold the reads
   of exactly one locus;
9. the trio workflow: ``kevlar_tpu_torch.workflow.run_mark1`` on phase 6's
   helium trio with the helium configuration of
   tools/sim_trio_bench.py (seed index built beforehand, timed apart).  K1,
   K2, K3 and B1 must each launch during the run, every checkpoint must
   exist, the four de novo SNVs must be PASS calls at their positions, and
   no PASS call may lie more than 10 bp from a de novo locus.  Whether the
   300 bp insertion was called, the stage walls, the peak RSS and the read
   and call counts of each stage are printed.

The last two lines of standard output are the kernels record (JSON: B1
and K1-K4, each with its launches on its slice's run, max_abs_err, ms and
plain_ms) and ``{"ok": true, "device": {...}}``.  The generators import
nothing but numpy, so tests import them to build small cases.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_LEN = 80_000_000
NLOCI = 1500
READLEN = 150
COVERAGE = 15          # per haplotype
KSIZE = 31
SEED = 20261016
MIN_RECALL = 0.90

# (class, min size, max size, share of loci): the class mix of the bigsim
# trio (ACCURACY_BIGSIM_CLASSMIX.json: 264 SNVs, ~250 per indel band)
CLASSES = [('SNVs', 0, 0, 264), ('INDELs 1-10bp', 1, 10, 248),
           ('INDELs 11-100bp', 11, 100, 247),
           ('INDELs 101-200bp', 101, 200, 247),
           ('INDELs 201-300bp', 201, 300, 247),
           ('INDELs 301-400bp', 301, 400, 247)]

_BASES = np.frombuffer(b'ACGT', dtype=np.uint8)
_RC = str.maketrans('ACGT', 'TGCA')

# The helium trio: the reference's quick-start scenario (kevlar
# docs/quick-start.rst), as tools/sim_trio_bench.py --preset helium builds
# it: a 25 Mb genome, a trio at 30x of 150 bp reads with 0.5% substitution
# errors, 20 inherited variants, and 5 de novo variants in the proband
# (4 SNVs and one 300 bp insertion, a 5%-mutated copy of another stretch
# of the genome).
HELIUM_GENOME_LEN = 25_000_000
HELIUM_COVERAGE = 30
HELIUM_ERROR = 0.005
HELIUM_INHERITED = 20
HELIUM_INSERTION = 300
SAMPLES = ('proband', 'mother', 'father')


def _revcom(seq):
    return seq.translate(_RC)[::-1]


def _canon(kmer):
    rc = _revcom(kmer)
    return kmer if kmer <= rc else rc


def _class_counts(nloci):
    """Largest-remainder apportionment of ``nloci`` over CLASSES."""
    shares = np.array([c[3] for c in CLASSES], dtype=np.float64)
    exact = nloci * shares / shares.sum()
    counts = np.floor(exact).astype(int)
    for k in np.argsort(-(exact - counts), kind='stable')[:nloci -
                                                          counts.sum()]:
        counts[k] += 1
    return counts


def _write_fasta(path, name, codes):
    seq = _BASES[codes]
    full = len(seq) // 80
    lines = np.concatenate(
        [seq[:full * 80].reshape(full, 80),
         np.full((full, 1), ord('\n'), dtype=np.uint8)], axis=1)
    with open(path, 'wb') as fh:
        fh.write(b'>' + name.encode() + b'\n')
        fh.write(lines.tobytes())
        tail = seq[full * 80:].tobytes()
        if tail:
            fh.write(tail + b'\n')


def make_alac_case(workdir, genome_len=GENOME_LEN, nloci=NLOCI,
                   seed=SEED, readlen=READLEN, coverage=COVERAGE,
                   ksize=KSIZE):
    """Write ``refr.fa`` and ``partitioned.augfastq`` into ``workdir``.

    A uniform random genome ``chr1`` carries ``nloci`` de novo variants,
    one per equal window, in the CLASSES mix (insertions and deletions
    equally likely, sizes uniform in the band).  For each locus, reads of
    ``readlen`` bp are drawn at ``coverage`` x from the alt haplotype around
    it (random starts and strands); a read is kept when it holds one of the
    locus's novel k-mers — alt k-mers spanning the variant that the local
    reference lacks — and those k-mers are annotated with abundance
    ``n 0 0``, n the number of kept reads holding them.  Each locus is one
    ``kvcc=`` partition.  Returns (refr path, reads path, truth) with truth
    a list of (pos0, ref, alt, class name) sorted by position.
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, genome_len, dtype=np.uint8)
    refrpath = os.path.join(workdir, 'refr.fa')
    _write_fasta(refrpath, 'chr1', codes)
    genome = _BASES[codes].tobytes().decode()
    del codes

    classes = np.repeat(np.arange(len(CLASSES)), _class_counts(nloci))
    rng.shuffle(classes)
    flank = readlen + 50
    window = genome_len // nloci
    margin = flank + 500
    if window < 2 * margin + 400 + 1:
        raise ValueError('genome too short for {} loci'.format(nloci))
    truth = []
    readspath = os.path.join(workdir, 'partitioned.augfastq')
    qual = 'I' * readlen
    with open(readspath, 'w') as out:
        for locus, cls in enumerate(classes):
            name, lo, hi, _ = CLASSES[cls]
            pos = locus * window + margin + int(
                rng.integers(0, window - 2 * margin - 400))
            refbase = genome[pos]
            if hi == 0:
                alt = 'ACGT'[('ACGT'.index(refbase) +
                              int(rng.integers(1, 4))) % 4]
                ref, insert = refbase, alt
                var = (pos, refbase, alt)
            else:
                size = int(rng.integers(lo, hi + 1))
                if rng.random() < 0.5:
                    ins = _BASES[rng.integers(0, 4, size)].tobytes().decode()
                    ref, insert = refbase, refbase + ins
                    var = (pos, refbase, refbase + ins)
                else:
                    ref = genome[pos:pos + 1 + size]
                    insert = refbase
                    var = (pos, ref, refbase)
            truth.append(var + (name,))
            # alt haplotype around the locus; the variant occupies
            # [flank, flank + len(insert)) in its coordinates
            left = genome[pos - flank:pos]
            right = genome[pos + len(ref):pos + len(ref) + flank]
            althap = left + insert + right
            refwin = genome[pos - flank - ksize:
                            pos + len(ref) + flank + ksize]
            refkmers = {_canon(refwin[s:s + ksize])
                        for s in range(len(refwin) - ksize + 1)}
            novel = np.zeros(len(althap) - ksize + 1, dtype=bool)
            for s in range(max(0, flank - ksize + 1),
                           min(len(novel), flank + len(insert))):
                novel[s] = _canon(althap[s:s + ksize]) not in refkmers
            nreads = int(round(coverage * len(althap) / readlen))
            starts = rng.integers(0, len(althap) - readlen + 1, nreads)
            strands = rng.random(nreads) < 0.5
            span = readlen - ksize + 1
            kept = [(int(s0), bool(rc)) for s0, rc in zip(starts, strands)
                    if novel[s0:s0 + span].any()]
            abund = np.zeros(len(novel), dtype=np.int64)
            for s0, _ in kept:
                abund[s0:s0 + span] += 1
            for n, (s0, rc) in enumerate(kept):
                seq = althap[s0:s0 + readlen]
                hits = np.flatnonzero(novel[s0:s0 + span])
                if rc:
                    seq = _revcom(seq)
                    hits = hits[::-1]
                lines = ['@read{}_{} kvcc={}'.format(locus, n, locus + 1),
                         seq, '+', qual]
                for h in hits:
                    off = span - 1 - h if rc else h
                    lines.append('{}{}{}{} 0 0#'.format(
                        ' ' * off, seq[off:off + ksize], ' ' * 10,
                        abund[s0 + h]))
                out.write('\n'.join(lines) + '\n')
    truth.sort()
    return refrpath, readspath, truth


def _apply_edits(genome, edits):
    """A haplotype: ``genome`` (codes) with ``edits`` [(pos, reflen,
    alt codes)] applied, positions in genome coordinates."""
    pieces, last = [], 0
    for pos, reflen, alt in sorted(edits, key=lambda e: e[0]):
        pieces += [genome[last:pos], alt]
        last = pos + reflen
    pieces.append(genome[last:])
    return np.concatenate(pieces)


def _write_reads(path, haplotypes, coverage, readlen, error, rng):
    """Uniform 150 bp reads from each haplotype at ``coverage``/2 x, with
    substitution errors at rate ``error``, as fixed-width FASTQ records
    (``@r`` + 9 digits); the read simulation of
    tools/sim_trio_bench.py:82-123.  Returns the read count."""
    total = 0
    chunk = 250_000
    offsets = np.arange(readlen)
    with open(path, 'wb') as out:
        for hap in haplotypes:
            nreads = len(hap) * coverage // (2 * readlen)
            for off in range(0, nreads, chunk):
                m = min(chunk, nreads - off)
                starts = rng.integers(0, len(hap) - readlen, size=m)
                reads = hap[starts[:, None] + offsets]
                flat = reads.reshape(-1)
                nerr = int(rng.binomial(flat.size, error))
                where = rng.integers(0, flat.size, size=nerr)
                rot = rng.integers(1, 4, size=nerr).astype(np.uint8)
                flat[where] = (flat[where] + rot) & 3
                rl = readlen
                rec = np.empty((m, 15 + 2 * rl + 1), np.uint8)
                rec[:, 0] = ord('@')
                rec[:, 1] = ord('r')
                nums = np.arange(total + 1, total + m + 1, dtype=np.int64)
                for j in range(9):
                    rec[:, 2 + j] = (nums // 10 ** (8 - j)) % 10 + ord('0')
                rec[:, 11] = ord('\n')
                rec[:, 12:12 + rl] = _BASES[reads]
                rec[:, 12 + rl] = ord('\n')
                rec[:, 13 + rl] = ord('+')
                rec[:, 14 + rl] = ord('\n')
                rec[:, 15 + rl:15 + 2 * rl] = ord('I')
                rec[:, 15 + 2 * rl] = ord('\n')
                out.write(rec.tobytes())
                total += m
    return total


def make_trio_case(workdir, genome_len=HELIUM_GENOME_LEN,
                   coverage=HELIUM_COVERAGE, error=HELIUM_ERROR,
                   ninherited=HELIUM_INHERITED, readlen=READLEN,
                   insertion=HELIUM_INSERTION, ksize=KSIZE, seed=SEED):
    """Write the helium trio into ``workdir``: ``refr.fa`` and
    ``{proband,mother,father}.fq``.

    A uniform random genome ``chr1``; ``ninherited`` variants (SNVs and
    1-10 bp indels), each heterozygous in one parent and passed to the
    proband when it sits on that parent's transmitted haplotype; and 5 de
    novo variants on one proband haplotype each: 4 SNVs and one insertion
    of ``insertion`` bp.  Variants lie at least 2 kb apart.  Returns
    (refr path, {sample: reads path}, de novo list), each de novo entry
    ``(pos0, kind, alt-window k-mers)``: the canonical k-mers of the alt
    haplotype that overlap the variant.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    refrpath = os.path.join(workdir, 'refr.fa')
    _write_fasta(refrpath, 'chr1', genome)
    nvar = ninherited + 5
    lo, hi = genome_len // 20, genome_len - genome_len // 20
    slots = np.sort(rng.choice((hi - lo) // 2000, nvar, replace=False))
    positions = lo + slots * 2000 + rng.integers(0, 1000, nvar)
    order = rng.permutation(nvar)
    haps = {(who, h): [] for who in SAMPLES for h in (0, 1)}
    denovo = []
    for rank, pos in zip(order, positions.tolist()):
        if rank < 5:                                  # de novo
            ref = genome[pos:pos + 1]
            if rank < 4:
                alt = (ref + rng.integers(1, 4)).astype(np.uint8) & 3
                kind, new, start = 'SNV', alt, pos
            else:
                src = int(rng.integers(0, genome_len - insertion))
                new = genome[src:src + insertion].copy()
                mut = rng.random(insertion) < 0.05
                new[mut] = (new[mut] + rng.integers(
                    1, 4, int(mut.sum()))).astype(np.uint8) & 3
                alt = np.concatenate([ref, new])
                kind, start = 'INS {} bp'.format(insertion), pos + 1
            hap = int(rng.integers(0, 2))
            haps[('proband', hap)].append((pos, 1, alt))
            # the new bases with k-1 reference bases on each side
            window = np.concatenate([genome[start - ksize + 1:start], new,
                                     genome[pos + 1:pos + ksize]])
            seq = _BASES[window].tobytes().decode()
            kmers = {_canon(seq[s:s + ksize])
                     for s in range(len(seq) - ksize + 1)}
            denovo.append((pos, kind, kmers))
            continue
        size = int(rng.integers(1, 11))               # inherited
        kind = int(rng.integers(0, 3))
        ref = genome[pos:pos + 1]
        if kind == 0:
            alt = (ref + rng.integers(1, 4)).astype(np.uint8) & 3
        elif kind == 1:
            alt = np.concatenate([ref, rng.integers(0, 4, size,
                                                    dtype=np.uint8)])
        else:
            ref = genome[pos:pos + 1 + size]
            alt = genome[pos:pos + 1]
        parent = SAMPLES[1 + int(rng.integers(0, 2))]
        hap = int(rng.integers(0, 2))
        edit = (pos, len(ref), alt)
        haps[(parent, hap)].append(edit)
        if hap == 0:       # the proband gets hap 0 of each parent
            haps[('proband', 0 if parent == 'mother' else 1)].append(edit)
    reads = {}
    for i, who in enumerate(SAMPLES):
        path = os.path.join(workdir, who + '.fq')
        hapseqs = [_apply_edits(genome, haps[(who, h)]) for h in (0, 1)]
        _write_reads(path, hapseqs, coverage, readlen, error,
                     np.random.default_rng(seed + 7 * (i + 1)))
        reads[who] = path
    denovo.sort(key=lambda d: d[0])
    return refrpath, reads, denovo


def read_augfastx_kmers(path):
    """[(read name, [(annotated k-mer, abundances), ...])] of an augmented
    FASTQ file."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('@'):
                out.append((line[1:].strip(), []))
                next(fh)
                next(fh)
                next(fh)
            elif line.rstrip('\n').endswith('#'):
                kmer, abund = line.strip()[:-1].split(None, 1)
                out[-1][1].append((kmer, abund))
    return out


def read_vcf_calls(path):
    """[(pos0, ref, alt, filter)] of the VCF's variant rows."""
    calls = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            if f[1] == '.' or f[3] == '.' or f[4] == '.':
                continue
            calls.append((int(f[1]) - 1, f[3], f[4], f[6]))
    return calls


def _same_haplotype(genome, call, var):
    """Whether two (pos0, ref, alt) edits make the same local haplotype —
    allele equality up to the placement of an indel in a repeat."""
    (cp, cref, calt), (tp, tref, talt) = call[:3], var[:3]
    if genome[cp:cp + len(cref)] != cref:
        return False
    lo = min(cp, tp) - 1
    hi = max(cp + len(cref), tp + len(tref)) + 1
    return (genome[lo:cp] + calt + genome[cp + len(cref):hi] ==
            genome[lo:tp] + talt + genome[tp + len(tref):hi])


def score_calls(genome, calls, truth, slack=500):
    """Per-class recall of ``truth`` by ``calls`` (any FILTER, and PASS
    only), matching by position and alleles; plus the PASS calls that
    match no truth variant."""
    import bisect
    calls = sorted(calls)
    cpos = [c[0] for c in calls]
    per_class = {c[0]: dict(total=0, found=0, found_pass=0)
                 for c in CLASSES}
    matched = set()
    for var in truth:
        row = per_class[var[3]]
        row['total'] += 1
        lo = bisect.bisect_left(cpos, var[0] - slack)
        hi = bisect.bisect_right(cpos, var[0] + slack)
        hits = [k for k in range(lo, hi)
                if _same_haplotype(genome, calls[k], var)]
        matched.update(hits)
        row['found'] += bool(hits)
        row['found_pass'] += any(calls[k][3] == 'PASS' for k in hits)
    total = sum(r['total'] for r in per_class.values())
    found = sum(r['found'] for r in per_class.values())
    found_pass = sum(r['found_pass'] for r in per_class.values())
    false_pass = sum(1 for k, c in enumerate(calls)
                     if c[3] == 'PASS' and k not in matched)
    return dict(per_class=per_class, total=total,
                recall=found / total, recall_pass=found_pass / total,
                false_pass=false_pass)


# ---------------------------------------------------------------- GPU run


def _nvidia_smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def _kernel_pairs(rng):
    """Seeded (target, query) pairs at the call stage's shapes."""
    def rand(n):
        return _BASES[rng.integers(0, 4, n)].tobytes().decode()

    def mutate(seq):
        seq = list(seq)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, len(seq)))
            kind = rng.integers(0, 4)
            if kind == 0:
                seq[p] = 'ACGTN'[int(rng.integers(0, 5))]
            elif kind == 1:
                seq[p:p] = rand(int(rng.integers(1, 60)))
            elif kind == 2:
                del seq[p:p + int(rng.integers(1, 60))]
            else:
                seq[p] = 'N'
        return ''.join(seq)

    pairs = []
    for _ in range(48):
        tlen = int(rng.integers(100, 2001))
        qlen = int(rng.integers(100, min(tlen, 1000) + 1))
        t = rand(tlen)
        if rng.random() < 0.25:
            q = rand(qlen)                       # unrelated
        else:
            start = int(rng.integers(0, tlen - qlen + 1))
            q = mutate(t[start:start + qlen])    # contig vs its cutout
        pairs.append((t, q or 'A'))
    # equal-score ties: units dropped from homopolymers and tandem repeats
    for unit, copies, drop in (('A', 20, 3), ('AC', 15, 2), ('ACG', 12, 1),
                               ('T', 9, 1), ('GT', 30, 7)):
        flank1, flank2 = rand(150), rand(150)
        t = flank1 + unit * copies + flank2
        pairs.append((t, flank1 + unit * (copies - drop) + flank2))
        pairs.append((flank1 + unit * (copies - drop) + flank2, t))
    return pairs


def _long_pairs(rng):
    """Targets at the --max-target-length default of 10,000 bp."""
    pairs = []
    for qlen in (800, 1000):
        t = _BASES[rng.integers(0, 4, 10000)].tobytes().decode()
        start = int(rng.integers(0, 10000 - qlen))
        q = t[start:start + qlen // 2] + 'ACGTTGCA' + \
            t[start + qlen // 2 + 40:start + qlen]
        pairs.append((t, q))
    return pairs


def _encode(pairs, device):
    import torch
    from kevlar_tpu_torch import dna
    targets, tlens = dna.encode_batch([p[0] for p in pairs])
    queries, qlens = dna.encode_batch([p[1] for p in pairs])
    return [torch.from_numpy(x).to(device)
            for x in (targets, tlens, queries, qlens)]


def _compare(kernel_out, plain_out, label):
    """Max abs difference over scores, op streams and exit cells; raises
    unless all are identical."""
    err = 0
    for name, k, p in zip(('scores', 'ops_rev', 'exit_i', 'exit_j'),
                          kernel_out, plain_out):
        if k.shape != p.shape:
            raise AssertionError('{}: {} shape {} vs plain {}'.format(
                label, name, tuple(k.shape), tuple(p.shape)))
        diff = int((k.long() - p.long()).abs().max()) if k.numel() else 0
        err = max(err, diff)
        if diff:
            bad = int((k != p).reshape(k.shape[0], -1).any(1).sum())
            raise AssertionError('{}: {} differ from the plain version in '
                                 '{} rows (max abs {})'.format(
                                     label, name, bad, diff))
    return err


def _timed(fn, *args, reps=1, **kw):
    """(result, ms per call) by CUDA events, after one warm-up call."""
    import torch
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def phase_kernel(device):
    """Phase 3: kernel vs plain version and align_scalar on the card."""
    import torch
    from kevlar_tpu_torch.ops import align_cuda
    from kevlar_tpu_torch.ops.align import align_scalar
    rng = np.random.default_rng(SEED + 3)
    err = 0
    pairs = _kernel_pairs(rng)
    batch = _encode(pairs, device)
    for gapopen, gapextend in ((5, 0), (5, 2), (3, 1)):
        kw = dict(gapopen=gapopen, gapextend=gapextend)
        got, ms = _timed(align_cuda.ksw_extz_cuda, *batch, reps=5, **kw)
        t0 = time.time()
        ref = align_cuda.ksw_extz_plain(*batch, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t0)
        err = max(err, _compare(got, ref, 'pairs gap {}'.format(kw)))
        print('[smoke] kernel vs plain: {} pairs (T<={}, Q<={}) gap {}: '
              'identical; kernel {:.3f} ms, plain {:.1f} ms'.format(
                  len(pairs), batch[0].shape[1], batch[2].shape[1], kw, ms,
                  plain_ms), flush=True)
    long_batch = _encode(_long_pairs(rng), device)
    for kw in (dict(gapopen=5, gapextend=0), dict(gapopen=3, gapextend=1)):
        got = align_cuda.ksw_extz_cuda(*long_batch, **kw)
        ref = align_cuda.ksw_extz_plain(*long_batch, **kw)
        err = max(err, _compare(got, ref, 'long pairs gap {}'.format(kw)))
    # wavefront state beyond shared memory: the global-scratch path
    t = _BASES[rng.integers(0, 4, 12000)].tobytes().decode()
    big = _encode([(t, t[500:6000] + t[6100:9600])], device)
    if 4 * (3 * (big[0].shape[1] + big[2].shape[1]) - 1) <= \
            align_cuda.SMEM_LIMIT_BYTES:
        raise AssertionError('global-scratch case fits shared memory')
    got = align_cuda.ksw_extz_cuda(*big, gapopen=5, gapextend=2)
    ref = align_cuda.ksw_extz_plain(*big, gapopen=5, gapextend=2)
    err = max(err, _compare(got, ref, 'global-scratch pair'))
    print('[smoke] kernel vs plain: 10,000 bp targets in shared memory, a '
          '12,000 x 9,000 pair in global memory: identical', flush=True)
    # truncated random pairs, and tie pairs cut around their repeat
    small = [(t[:120], q[:100]) for t, q in pairs[:4]] + \
        [(t[130:200], q[130:195]) for t, q in pairs[-4:]]
    small += [('ACGTACGTTTGACCA', 'ACGTCGTTTGACNCA'),
              ('AAAAAAAAAACCCC', 'AAAAAAACCCC')]
    got = align_cuda.align_batch([p[0] for p in small],
                                 [p[1] for p in small], gapopen=5,
                                 gapextend=2, device=device)
    want = [align_scalar(t, q, gapopen=5, gapextend=2) for t, q in small]
    if got != want:
        raise AssertionError('kernel disagrees with align_scalar: {} vs '
                             '{}'.format(got, want))
    print('[smoke] kernel vs align_scalar: {} small pairs identical'.format(
        len(small)), flush=True)
    return err


def _max_diff(got, want, label):
    """Max abs difference of two integer tensors; raises unless equal."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError('{}: kernel gave {} {}, plain {} {}'.format(
            label, got.dtype, tuple(got.shape), want.dtype,
            tuple(want.shape)))
    diff = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if diff:
        raise AssertionError('{}: {} of {} values differ from the plain '
                             'version (max abs {})'.format(
                                 label, int((got != want).sum()),
                                 got.numel(), diff))
    return diff


def _wire(bases, device):
    import torch
    from kevlar_tpu_torch.batch import pack_bases
    packed, badmask = pack_bases(bases)
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(badmask).to(device))


def _read_bases(rng, nrows, L, readlen, nrate=0.002):
    """[nrows, L] base codes: reads of ``readlen`` with N bases at
    ``nrate``, padded with the invalid code 4 (a count batch)."""
    bases = rng.integers(0, 4, (nrows, L), dtype=np.uint8)
    bases[rng.random((nrows, L)) < nrate] = 4
    bases[:, readlen:] = 4
    return bases


def phase_kmer_kernels(device):
    """Phase 5: K1, K2 and K3 against their plain versions on the card, on
    seeded inputs, then timed at the shapes of the helium run.  Returns
    {kernel: dict(err, ms, plain_ms, shape)}."""
    import torch
    from kevlar_tpu_torch.ops import hashing, kmer_cuda, sketch_ops
    rng = np.random.default_rng(SEED + 5)
    out = {}

    # K1: k = 21, 31, 33, 51; L not a multiple of 4 or 8; N bases
    err = 0
    for k in (21, 31, 33, 51):
        for L, readlen in ((157, 150), (1021, 1021), (253, 61)):
            packed, badmask = _wire(_read_bases(rng, 3001, L, readlen),
                                    device)
            got = kmer_cuda.kmer_hashes_cuda(packed, badmask, L, k)
            want = hashing.kmer_hashes_packed_plain(packed, badmask, L, k)
            for name, g, w in zip(('h1', 'h2', 'valid'), got, want):
                err = max(err, _max_diff(g, w, 'K1 k={} L={} {}'.format(
                    k, L, name)))
    # the proband count's launch: 32,768 reads of 150 bp in a 160 bucket
    packed, badmask = _wire(_read_bases(rng, 32768, 160, 150), device)
    _, ms = _timed(kmer_cuda.kmer_hashes_cuda, packed, badmask, 160, KSIZE,
                   reps=20)
    _, plain_ms = _timed(hashing.kmer_hashes_packed_plain, packed, badmask,
                         160, KSIZE, reps=3)
    out['K1'] = dict(err=err, ms=ms, plain_ms=plain_ms,
                     shape='32,768 x 160 bases, k=31')
    print('[smoke] K1 kmer_hashes: identical to plain at k=21/31/33/51 '
          '(L=157/1021/253, N bases); {} kernel {:.3f} ms, plain {:.3f} ms'
          .format(out['K1']['shape'], ms, plain_ms), flush=True)

    # K2: 1, 4 and 8 bits, tablesizes not a multiple of 8
    err = 0
    for bits, tablesize in ((1, 1_000_003), (4, 999_999), (8, 500_001)):
        width = sketch_ops.packed_width(tablesize, bits)
        tables = torch.from_numpy(rng.integers(
            0, 256, (4, width), dtype=np.uint8)).to(device)
        h = torch.from_numpy(rng.integers(
            -2**31, 2**31, (2, 1_000_000), dtype=np.int64).astype(
                np.int32)).to(device)
        got = kmer_cuda.gather_counts_cuda(tables, h[0], h[1], bits,
                                           tablesize)
        want = sketch_ops.gather_counts_plain(tables, h[0], h[1], bits,
                                              tablesize)
        err = max(err, _max_diff(got, want, 'K2 {} bits'.format(bits)))
    # a novel-screen launch: one 500 MB sample sketch, 4,096 reads
    tablesize = 124_999_999
    tables = torch.randint(0, 256, (4, tablesize), dtype=torch.uint8,
                           device=device)
    h = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 4096 * 130),
                                      dtype=np.int64).astype(np.int32)).to(
        device)
    got, ms = _timed(kmer_cuda.gather_counts_cuda, tables, h[0], h[1], 8,
                     tablesize, reps=20)
    want, plain_ms = _timed(sketch_ops.gather_counts_plain, tables, h[0],
                            h[1], 8, tablesize, reps=5)
    err = max(err, _max_diff(got, want, 'K2 helium shape'))
    out['K2'] = dict(err=err, ms=ms, plain_ms=plain_ms,
                     shape='532,480 k-mers, 4 x 124,999,999 8-bit')
    print('[smoke] K2 gather_counts: identical to plain at 1/4/8 bits; {} '
          'kernel {:.3f} ms, plain {:.3f} ms'.format(out['K2']['shape'], ms,
                                                     plain_ms), flush=True)
    del tables

    # K3: heavy duplicates, negative indices, an odd bucket count
    err = 0
    for C, n, span in ((1001, 131072, 37), (999_999, 2_000_000, 999_999)):
        idx = rng.integers(-5, span, (4, n)).astype(np.int32)
        acc0 = rng.integers(0, 100, (4, C)).astype(np.int32)
        got = kmer_cuda.scatter_add_cuda(
            torch.from_numpy(acc0).to(device),
            torch.from_numpy(idx).to(device))
        want = sketch_ops.scatter_add_plain(
            torch.from_numpy(acc0).to(device),
            torch.from_numpy(idx).to(device))
        err = max(err, _max_diff(got, want, 'K3 C={}'.format(C)))
        ref = acc0 + np.stack([np.bincount(r[r >= 0], minlength=C)
                               for r in idx])
        err = max(err, _max_diff(got.cpu(), torch.from_numpy(ref.astype(
            np.int32)), 'K3 C={} vs bincount'.format(C)))
    # the proband count's launch: 2 GB accumulator, 32,768 reads x 130
    # windows, 15% of them kept by the mask
    C = 124_999_999
    acc = torch.zeros((4, C), dtype=torch.int32, device=device)
    n = 32768 * 130
    idx = rng.integers(0, C, (4, n)).astype(np.int32)
    idx[:, rng.random(n) >= 0.15] = -1
    idx = torch.from_numpy(idx).to(device)
    _, ms = _timed(kmer_cuda.scatter_add_cuda, acc, idx, reps=20)
    _, plain_ms = _timed(sketch_ops.scatter_add_plain, acc, idx, reps=5)
    out['K3'] = dict(err=err, ms=ms, plain_ms=plain_ms,
                     shape='4 x 4,259,840 indices (15% kept), 4 x '
                     '124,999,999 int32')
    print('[smoke] K3 scatter_add: identical to plain and bincount '
          '(duplicates, negative indices); {} kernel {:.3f} ms, plain '
          '{:.3f} ms'.format(out['K3']['shape'], ms, plain_ms), flush=True)
    return out


def phase_slice(device, workdir):
    """Phase 4: the alac slice at bigsim scale through the CLI."""
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import cli, reference
    from kevlar_tpu_torch.ops import align_cuda

    t0 = time.time()
    refr, reads, truth = make_alac_case(workdir)
    print('[smoke] generated {:,} bp reference, {} loci in {:.1f} s'.format(
        GENOME_LEN, len(truth), time.time() - t0), flush=True)
    t0 = time.time()
    reference.autoindex(refr, 51)
    index_s = time.time() - t0
    print('[smoke] seed index (seed 51) built in {:.1f} s'.format(index_s),
          flush=True)

    seen = []
    batch_fn = align_cuda.align_batch

    def recording(targets, queries, **kw):
        out = batch_fn(targets, queries, **kw)
        seen.append((list(targets), list(queries), kw, out))
        return out

    vcfpath = os.path.join(workdir, 'calls.vcf')
    logpath = os.path.join(workdir, 'alac.log')
    align_cuda.align_batch = recording
    align_cuda.launches = 0
    t0 = time.time()
    try:
        cli.main(['-l', logpath, '--tee', 'alac', '-k', str(KSIZE),
                  '--device', device, '-o', vcfpath, reads, refr])
    finally:
        align_cuda.align_batch = batch_fn
        if kevlar_tpu_torch.logstream not in (None, sys.stderr):
            kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    torch.cuda.synchronize()
    alac_s = time.time() - t0
    launches = align_cuda.launches
    if launches <= 0:
        raise AssertionError('the alac run launched no ksw_extz kernel')
    with open(logpath) as fh:
        walls = [line.strip() for line in fh if 'phase walls' in line]
    if not walls:
        raise AssertionError('no phase walls line in the alac log')
    npairs = sum(len(s[0]) for s in seen)
    print('[smoke] alac: {:.1f} s wall; {}; {} alignment rows ({} pairs x '
          '2 strands) in {} kernel launches'.format(
              alac_s, walls[-1], npairs, npairs // 2, launches), flush=True)

    # every pair again: kernel and plain version, chunk by chunk
    err, ms, plain_ms = 0, 0.0, 0.0
    for targets, queries, kw, out in seen:
        tl = np.array([len(s) for s in targets])
        ql = np.array([len(s) for s in queries])
        for idx in align_cuda._chunks(tl, ql,
                                      align_cuda.ZDIAG_BUDGET_BYTES):
            batch = _encode([(targets[k], queries[k]) for k in idx], device)
            args = dict(match=kw['match'], mismatch=kw['mismatch'],
                        gapopen=kw['gapopen'], gapextend=kw['gapextend'])
            got, kms = _timed(align_cuda.ksw_extz_cuda, *batch, reps=3,
                              **args)
            torch.cuda.synchronize()
            t1 = time.time()
            ref = align_cuda.ksw_extz_plain(*batch, **args)
            torch.cuda.synchronize()
            plain_ms += 1e3 * (time.time() - t1)
            ms += kms
            err = max(err, _compare(got, ref, 'alac chunk'))
            scores, ops_rev, exit_i, exit_j = (x.cpu().numpy() for x in ref)
            cigars = align_cuda._cigars_from_ops_batch(ops_rev, exit_i,
                                                       exit_j)
            for k, cigar, score in zip(idx, cigars, scores.tolist()):
                if out[k] != (cigar, score):
                    raise AssertionError(
                        'alac row {}: kernel gave {}, plain version '
                        '{}'.format(k, out[k], (cigar, score)))
    print('[smoke] plain re-alignment of all {} rows: identical; kernel '
          '{:.2f} ms, plain {:.1f} ms ({:.0f} rows/s by the kernel)'.format(
              npairs, ms, plain_ms, npairs / (ms / 1e3)), flush=True)

    from kevlar_tpu_torch import seqio
    genome = seqio.parse_seq_dict(kevlar_tpu_torch.open(refr, 'r'))['chr1']
    score = score_calls(genome, read_vcf_calls(vcfpath), truth)
    for name, row in score['per_class'].items():
        print('[smoke] recall {:<18s} {:4d}/{:4d} = {:.4f} (PASS {:.4f})'
              .format(name, row['found'], row['total'],
                      row['found'] / max(1, row['total']),
                      row['found_pass'] / max(1, row['total'])), flush=True)
    print('[smoke] recall overall {:.4f} (PASS {:.4f}); PASS calls '
          'matching no truth variant: {}'.format(
              score['recall'], score['recall_pass'], score['false_pass']),
          flush=True)
    if score['recall_pass'] < MIN_RECALL:
        raise AssertionError('PASS recall {:.4f} below {}'.format(
            score['recall_pass'], MIN_RECALL))
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                reads=reads)


def _run_cli(argv, logpath):
    """``kevlar_tpu_torch.cli.main(argv)`` with its log in ``logpath``;
    returns the stage's wall seconds (the stage ends synchronised)."""
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import cli
    t0 = time.time()
    try:
        cli.main(['-l', logpath] + argv)
    finally:
        if kevlar_tpu_torch.logstream not in (None, sys.stderr):
            kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    torch.cuda.synchronize()
    return time.time() - t0


def _trio_stages(device, workdir, refr, reads, prefix, samples=SAMPLES,
                 mask=None):
    """The slice's commands, as the trio workflow runs them (workflow.py
    steps 1-3): reference mask, reference count, masked sample counts,
    novel screen.  Outputs are named ``prefix`` + file; with ``mask`` the
    sample counts use that mask.  Returns {stage: wall seconds}."""
    def out(name):
        return os.path.join(workdir, prefix + name)

    def log(name):
        return out(name + '.log')

    walls = {}
    base = ['-k', str(KSIZE), '--device', device]
    walls['count mask'] = _run_cli(
        ['count'] + base + ['-c', '1', '-M', '50M', '--max-fpr', '0.01',
                            out('mask.nt'), refr], log('mask'))
    walls['count refr'] = _run_cli(
        ['count'] + base + ['-c', '4', '-M', '50M', '--max-fpr', '1.0',
                            out('refr.sct'), refr], log('refr'))
    mask = mask or out('mask.nt')
    for who in samples:
        fpr = '0.6' if who == 'proband' else '0.2'
        walls['count ' + who] = _run_cli(
            ['count'] + base + ['-M', '500M', '--max-fpr', fpr, '--mask',
                                mask, out(who + '.ct'), reads[who]],
            log(who))
    return walls


def phase_trio(device, workdir):
    """Phase 6: count and novel on the helium trio through the CLI, with
    the kernels and then with their plain versions on the card."""
    from kevlar_tpu_torch.ops import kmer_cuda, hashing, sketch_ops

    t0 = time.time()
    refr, reads, denovo = make_trio_case(workdir)
    nreads = {}
    for who, path in reads.items():
        nreads[who] = os.path.getsize(path) // (16 + 2 * READLEN)
    print('[smoke] generated the helium trio ({:,} reads per sample, '
          '{:.1f} GB of FASTQ) in {:.1f} s'.format(
              nreads['proband'],
              sum(os.path.getsize(p) for p in reads.values()) / 1e9,
              time.time() - t0), flush=True)

    def novel_stage(prefix):
        """The screen on the kernel run's counts; output ``prefix``ed."""
        path = os.path.join(workdir, prefix + 'novel.augfastq')
        wall = _run_cli(
            ['novel', '-k', str(KSIZE), '--device', device, '--case',
             reads['proband'], '--case-counts',
             os.path.join(workdir, 'proband.ct'), '--control-counts',
             os.path.join(workdir, 'mother.ct'),
             os.path.join(workdir, 'father.ct'), '--case-min', '5',
             '--ctrl-max', '1', '-o', path],
            os.path.join(workdir, prefix + 'novel.log'))
        return path, wall

    # the main path, through the kernels
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    walls = _trio_stages(device, workdir, refr, reads, '')
    novelpath, walls['novel'] = novel_stage('')
    launches = dict(kmer_cuda.launches)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError('the helium run launched no {} kernel'
                                 .format(name))

    # the same commands with the plain versions, on the card
    kernels = (kmer_cuda.kmer_hashes_cuda, kmer_cuda.gather_counts_cuda,
               kmer_cuda.scatter_add_cuda)
    kmer_cuda.kmer_hashes_cuda = hashing.kmer_hashes_packed_plain
    kmer_cuda.gather_counts_cuda = sketch_ops.gather_counts_plain
    kmer_cuda.scatter_add_cuda = sketch_ops.scatter_add_plain
    try:
        plain_walls = _trio_stages(
            device, workdir, refr, reads, 'plain_', samples=('proband',),
            mask=os.path.join(workdir, 'mask.nt'))
        plainpath, plain_walls['novel'] = novel_stage('plain_')
    finally:
        (kmer_cuda.kmer_hashes_cuda, kmer_cuda.gather_counts_cuda,
         kmer_cuda.scatter_add_cuda) = kernels
    if dict(kmer_cuda.launches) != launches:
        raise AssertionError('the plain run launched a kernel')
    for name in ('mask.nt', 'refr.sct', 'proband.ct'):
        with np.load(os.path.join(workdir, name)) as got, \
                np.load(os.path.join(workdir, 'plain_' + name)) as want:
            for member in want.files:
                if not np.array_equal(got[member], want[member]):
                    raise AssertionError('{}: {} differs from the plain '
                                         'run'.format(name, member))
    with open(novelpath) as fh:
        novel_text = fh.read()
    with open(plainpath) as fh:
        if fh.read() != novel_text:
            raise AssertionError('novel output differs from the plain run')
    print('[smoke] kernel run == plain run: mask.nt, refr.sct and '
          'proband.ct tables, and the novel text ({:,} bytes)'.format(
              len(novel_text)), flush=True)

    for stage, wall in walls.items():
        who = 'proband' if stage == 'novel' else stage.split()[-1]
        rate = ' ({:,.0f} reads/s)'.format(nreads[who] / wall) \
            if who in nreads else ''
        plain = plain_walls.get(stage)
        print('[smoke] stage {:<14s} {:7.2f} s{}{}'.format(
            stage, wall, rate, '; plain {:.2f} s'.format(plain)
            if plain is not None else ''), flush=True)

    # the host's share of a sample count: the reader alone, then reader +
    # 2-bit packing, over the proband's FASTQ (no device work)
    from kevlar_tpu_torch.batch import native_base_batches, pack_bases
    from kevlar_tpu_torch.count import COUNT_BATCH_READS
    t0 = time.time()
    for _ in native_base_batches(reads['proband'], COUNT_BATCH_READS,
                                 overlap=KSIZE - 1):
        pass
    parse_s = time.time() - t0
    t0 = time.time()
    for bases, _ in native_base_batches(reads['proband'], COUNT_BATCH_READS,
                                        overlap=KSIZE - 1):
        pack_bases(bases)
    print('[smoke] host share of count proband ({:.2f} s): reader {:.2f} s, '
          'reader + 2-bit packing {:.2f} s'.format(
              walls['count proband'], parse_s, time.time() - t0), flush=True)

    # device busy share of a sample count, from a profiled repeat
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _run_cli(['count', '-k', str(KSIZE), '--device', device, '-M',
                         '500M', '--max-fpr', '0.2', '--mask',
                         os.path.join(workdir, 'mask.nt'),
                         os.path.join(workdir, 'prof_mother.ct'),
                         reads['mother']],
                        os.path.join(workdir, 'prof.log'))
    def device_us(event):
        return (getattr(event, 'self_device_time_total', 0) or
                getattr(event, 'self_cuda_time_total', 0))

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in events)
    print('[smoke] profiled count mother: {:.2f} s wall, device busy {} ; '
          'top device time: {}'.format(
              wall, '{:.3f} s ({:.2%})'.format(busy_us / 1e6,
                                               busy_us / 1e6 / wall)
              if busy_us else 'not measured (no device time in the trace)',
              '; '.join('{} x{} {:.1f} ms'.format(
                  e.key[:48], e.count, device_us(e) / 1e3)
                  for e in events[:8])), flush=True)

    records = read_augfastx_kmers(novelpath)
    inside = set().union(*(d[2] for d in denovo))
    nkmers = sum(len(ks) for _, ks in records)
    outside = [(name, k, a) for name, ks in records for k, a in ks
               if _canon(k) not in inside]
    out_reads = sum(1 for _, ks in records
                    if not any(_canon(k) in inside for k, _ in ks))
    print('[smoke] novel: {} reads, {} k-mers; outside the de novo windows: '
          '{} reads, {} k-mers ({} distinct){}'.format(
              len(records), nkmers, out_reads, len(outside),
              len({_canon(k) for _, k, _ in outside}),
              ''.join('\n[smoke]   outside: {} {} {}'.format(*o)
                      for o in outside[:5])), flush=True)
    found = {_canon(k) for _, ks in records for k, _ in ks}
    missed = []
    for pos, kind, kmers in denovo:
        hit = len(found & kmers)
        print('[smoke] de novo {:<10s} at {:>10,}: {} of its {} k-mers '
              'annotated'.format(kind, pos, hit, len(kmers)), flush=True)
        if not hit:
            missed.append((pos, kind))
    if missed:
        raise AssertionError('de novo loci without a novel read: {}'.format(
            missed))
    return dict(launches=launches, walls=walls, plain_walls=plain_walls,
                refr=refr, reads=reads, denovo=denovo)


def _cc_graphs(rng):
    """Seeded incidences (name, read_ids, kmer_ids, n_reads, n_kmers)."""
    graphs = []
    for n_reads, n_kmers, E in ((1000, 3000, 1500), (200_000, 600_000,
                                                     2_000_000)):
        graphs.append(('random {:,} pairs'.format(E),
                       rng.integers(0, n_reads, E),
                       rng.integers(0, n_kmers, E), n_reads, n_kmers))
    # a chain read - k-mer - read - ..., read indices shuffled so that the
    # minimum sits anywhere: diameter 5,000 reads
    n = 5000
    perm = rng.permutation(n)
    graphs.append(('chain of {:,} reads'.format(n),
                   np.concatenate([perm[:-1], perm[1:]]),
                   np.tile(np.arange(n - 1), 2), n, n - 1))
    # isolated reads, k-mers held by one read, duplicate pairs
    reads = rng.integers(0, 5000, 20000) * 2          # odd reads isolated
    kmers = rng.integers(0, 40000, 20000)             # most k-mers single
    dup = rng.integers(0, 20000, 5000)
    graphs.append(('isolated/single/duplicate',
                   np.concatenate([reads, reads[dup]]),
                   np.concatenate([kmers, kmers[dup]]), 10001, 40000))
    graphs.append(('E = 0', np.zeros(0), np.zeros(0), 17, 1))
    graphs.append(('E = 1', np.array([5]), np.array([0]), 9, 1))
    return [(name, r.astype(np.int32), k.astype(np.int32), nr, nk)
            for name, r, k, nr, nk in graphs]


def phase_cc_kernel(device, incidence):
    """Phase 7: K4 against its plain version on seeded graphs, then both
    timed on ``incidence`` (phase 8's read-k-mer pairs)."""
    import torch
    from kevlar_tpu_torch.ops import cc_cuda, cc_ops
    rng = np.random.default_rng(SEED + 7)
    err = 0
    for name, reads, kmers, n_reads, n_kmers in _cc_graphs(rng):
        r = torch.from_numpy(reads).to(device)
        k = torch.from_numpy(kmers).to(device)
        got = cc_cuda.cc_labels_cuda(r, k, n_reads, n_kmers)
        iters = cc_cuda.last_iterations
        want = cc_ops.connected_components_plain(r, k, n_reads, n_kmers)
        err = max(err, _max_diff(got, want, 'K4 ' + name))
        print('[smoke] K4 vs plain, {}: identical ({} components, {} '
              'iterations)'.format(name, len(torch.unique(got)), iters),
              flush=True)
    r, k, n_reads, n_kmers = incidence
    got, ms = _timed(cc_cuda.cc_labels_cuda, r, k, n_reads, n_kmers,
                     reps=5)
    want, plain_ms = _timed(cc_ops.connected_components_plain, r, k, n_reads,
                            n_kmers, reps=3)
    err = max(err, _max_diff(got, want, 'K4 bigsim partition'))
    shape = '{:,} pairs, {:,} reads, {:,} k-mers'.format(r.numel(), n_reads,
                                                         n_kmers)
    print('[smoke] K4 cc_labels: {} kernel {:.3f} ms ({} iterations), '
          'plain {:.3f} ms'.format(shape, ms, cc_cuda.last_iterations,
                                   plain_ms), flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, shape=shape)


def _locus(readname):
    """Locus of a make_alac_case read name, ``read<locus>_<n>``."""
    return readname.split('_')[0]


def phase_partition(device, workdir, reads):
    """Phase 8: the partition stage at bigsim scale through K4.  Returns
    the launch count, the wall and the incidence (for phase 7's timing)."""
    import torch
    from kevlar_tpu_torch.ops import cc_cuda, cc_ops
    with open(reads, 'rb') as fh:
        data = fh.read()
    unlabelled = os.path.join(workdir, 'novel.augfastq')
    with open(unlabelled, 'wb') as fh:
        fh.write(re.sub(rb' kvcc=\d+\n', b'\n', data))
    del data

    seen = []
    components = cc_ops.connected_components_bipartite

    def recording(read_ids, kmer_ids, n_reads, n_kmers):
        out = components(read_ids, kmer_ids, n_reads, n_kmers)
        seen.append((read_ids, kmer_ids, n_reads, n_kmers, out,
                     cc_cuda.last_iterations))
        return out

    outpath = os.path.join(workdir, 'repartitioned.augfastq')
    cc_ops.connected_components_bipartite = recording
    cc_cuda.launches['cc_labels'] = 0
    try:
        wall = _run_cli(['partition', '--device', device, '-o', outpath,
                         unlabelled], os.path.join(workdir, 'partition.log'))
    finally:
        cc_ops.connected_components_bipartite = components
    launches = cc_cuda.launches['cc_labels']
    if launches <= 0 or len(seen) != 1:
        raise AssertionError('the partition run launched K4 {} times over '
                             '{} graphs'.format(launches, len(seen)))
    r, k, n_reads, n_kmers, labels, iters = seen[0]
    if r.numel() < cc_ops.HOST_CC_THRESHOLD:
        raise AssertionError('{} pairs: below the threshold'.format(
            r.numel()))
    plain = cc_ops.connected_components_plain(r, k, n_reads, n_kmers)
    _max_diff(labels, plain, 'K4 on the partition run')

    members = {}
    with open(outpath) as fh:
        for line in fh:
            if line.startswith('@read'):
                name, label = line[1:].split()
                members.setdefault(label, set()).add(_locus(name))
    mixed = {lab: loci for lab, loci in members.items() if len(loci) != 1}
    if mixed:
        raise AssertionError('{} partitions mix loci, e.g. {}'.format(
            len(mixed), sorted(mixed.items())[:3]))
    loci = set().union(*members.values())
    print('[smoke] partition (bigsim reads, kvcc labels stripped): {:.1f} s '
          'wall; {:,} read-k-mer pairs over {:,} reads and {:,} k-mers; K4 '
          '{} launch, {} iterations; labels == plain; {:,} partitions, each '
          'one locus, covering {} of the loci'.format(
              wall, r.numel(), n_reads, n_kmers, launches, iters,
              len(members), len(loci)), flush=True)
    torch.cuda.synchronize()
    return dict(launches=launches, wall=wall,
                incidence=(r, k, n_reads, n_kmers))


def _count_reads(path):
    import kevlar_tpu_torch
    with kevlar_tpu_torch.open(path, 'r') as fh:
        return sum(1 for line in fh if line.startswith('@'))


def phase_workflow(device, workdir, refr, denovo, reads, memory='500M',
                   maskmemory='50M'):
    """Phase 9: run_mark1 on the helium trio of phase 6 (sample sketches
    of ``memory``, mask and reference count of ``maskmemory``)."""
    import resource
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import reference, workflow
    from kevlar_tpu_torch.ops import align_cuda, cc_cuda, kmer_cuda

    t0 = time.time()
    reference.autoindex(refr, 51)
    print('[smoke] seed index of the helium genome (seed 51) built in '
          '{:.1f} s (set-up)'.format(time.time() - t0), flush=True)
    outdir = os.path.join(workdir, 'workflow')
    config = {
        'ksize': KSIZE, 'outdir': outdir, 'device': device,
        'reference': {'fasta': refr},
        'case': {'fastx': [reads['proband']], 'label': 'Proband',
                 'memory': memory, 'max_fpr': 0.6},
        'controls': [
            {'fastx': [reads['mother']], 'label': 'Mother',
             'memory': memory, 'max_fpr': 0.2},
            {'fastx': [reads['father']], 'label': 'Father',
             'memory': memory, 'max_fpr': 0.2}],
        'mask': {'memory': maskmemory, 'max_fpr': 0.01},
        'novel': {'case_min': 5, 'ctrl_max': 1},
        'localize': {'seed_size': 51, 'delta': 50},
        'simlike': {'mu': HELIUM_COVERAGE, 'sigma': HELIUM_COVERAGE * 0.3,
                    'epsilon': 0.001},
    }
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    cc_cuda.launches['cc_labels'] = 0
    align_cuda.launches = 0
    logpath = os.path.join(workdir, 'workflow.log')
    kevlar_tpu_torch.logstream = open(logpath, 'w')
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    t0 = time.time()
    try:
        final = workflow.run_mark1(config)
    finally:
        kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kmer_cuda.launches, ksw_extz=align_cuda.launches,
                    cc_labels=cc_cuda.launches['cc_labels'])
    missing = [name for name in ('kmer_hashes', 'gather_counts',
                                 'scatter_add', 'ksw_extz')
               if launches[name] <= 0]
    if missing:
        raise AssertionError('the workflow launched no {} kernel'.format(
            missing))
    for artifact in ('mask.nt', 'refr.sct', 'case.ct', 'control0.ct',
                     'control1.ct', 'novel.augfastq.gz',
                     'filtered.augfastq.gz', 'partitioned.augfastq.gz',
                     'calls.prelim.vcf', 'callmask.nt',
                     'calls.scored.sorted.vcf.gz'):
        if not os.path.exists(os.path.join(outdir, artifact)):
            raise AssertionError('the workflow wrote no ' + artifact)

    calls = []
    with kevlar_tpu_torch.open(final, 'r') as fh:
        for line in fh:
            if not line.startswith('#'):
                f = line.split('\t')
                if f[1] != '.':
                    calls.append((int(f[1]) - 1, f[3], f[4], f[6]))
    passing = [c for c in calls if c[3] == 'PASS']
    for pos, kind, _ in denovo:
        if kind == 'SNV':
            hit = [c for c in passing if c[0] == pos and len(c[1]) ==
                   len(c[2]) == 1]
            print('[smoke] de novo SNV at {:,}: {}'.format(
                pos, 'PASS call {} > {}'.format(hit[0][1], hit[0][2])
                if hit else 'NOT CALLED'), flush=True)
            if not hit:
                raise AssertionError('de novo SNV at {} is not a PASS '
                                     'call'.format(pos))
        else:
            hit = [c for c in passing if abs(c[0] - pos) <= 10 and
                   len(c[2]) - len(c[1]) == HELIUM_INSERTION]
            print('[smoke] de novo {} at {:,}: {}'.format(
                kind, pos, 'called (PASS, {} bp longer at {:,})'.format(
                    HELIUM_INSERTION, hit[0][0]) if hit else 'not called'),
                flush=True)
    stray = [c for c in passing
             if all(abs(c[0] - pos) > 10 for pos, _, _ in denovo)]
    if stray:
        raise AssertionError('PASS calls away from every de novo locus: '
                             '{}'.format(stray[:5]))
    counts = {name: _count_reads(os.path.join(outdir, name))
              for name in ('novel.augfastq.gz', 'filtered.augfastq.gz',
                           'partitioned.augfastq.gz')}
    # the process's peak so far; it covers the earlier phases too, so the
    # peak before the run says whether the workflow raised it
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print('[smoke] workflow: {:.1f} s wall; reads novel {:,}, filtered {:,}, '
          'partitioned {:,}; {} calls, {} PASS (none away from a de novo '
          'locus); peak RSS of the process {:.0f} MB after the run, {:.0f} '
          'MB before it; launches {}'.format(
              wall, counts['novel.augfastq.gz'],
              counts['filtered.augfastq.gz'],
              counts['partitioned.augfastq.gz'], len(calls), len(passing),
              rss, rss_before, launches), flush=True)
    print('[smoke] workflow stage walls: {}'.format('; '.join(
        '{} {:.2f} s'.format(stage, sec)
        for stage, sec in workflow.run_mark1.last_stage_times)), flush=True)
    return dict(launches=launches, wall=wall)


def build_all():
    """Phase 2: compile every library from the checkout's sources, all at
    once (one compiler process each); returns {library: seconds}."""
    from concurrent.futures import ThreadPoolExecutor
    from kevlar_tpu_torch import native
    from kevlar_tpu_torch.ops import align_cuda, cc_cuda, kmer_cuda

    def timed_build(fn):
        t0 = time.time()
        fn(force=True)
        return time.time() - t0

    builds = {'csrc/align.cu (nvcc)': align_cuda.build,
              'csrc/kmer.cu (nvcc)': kmer_cuda.build,
              'csrc/cc.cu (nvcc)': cc_cuda.build,
              'asm.cpp (g++)': native.build,
              'fastx.cpp (g++ -lz)': native.build_fastx}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed_build, fn)
                   for name, fn in builds.items()}
        return {name: f.result() for name, f in futures.items()}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    device = 'cuda'
    t_all = time.time()
    smi = _nvidia_smi()
    print(smi, flush=True)

    t0 = time.time()
    builds = build_all()
    print('[smoke] built in parallel in {:.1f} s: {}'.format(
        time.time() - t0, ', '.join('{} {:.1f} s'.format(name, sec)
                                    for name, sec in builds.items())),
        flush=True)

    err = phase_kernel(device)
    with tempfile.TemporaryDirectory() as workdir:
        run = phase_slice(device, workdir)
        part = phase_partition(device, workdir, run['reads'])
        cc = phase_cc_kernel(device, part.pop('incidence'))
    kmer = phase_kmer_kernels(device)
    with tempfile.TemporaryDirectory() as workdir:
        trio = phase_trio(device, workdir)
        phase_workflow(device, workdir, trio['refr'], trio['denovo'],
                       trio['reads'])
    print('[smoke] total wall {:.1f} s'.format(time.time() - t_all),
          flush=True)

    kernels = [{
        'name': 'ksw_extz (wavefront DP + traceback)', 'route': 'cuda',
        'source': 'kevlar_tpu_torch/csrc/align.cu',
        'replaces': 'kevlar_tpu/ops/align_pallas.py:204',
        'launches': run['launches'], 'max_abs_err': max(err, run['err']),
        'ms': run['ms'], 'plain_ms': run['plain_ms']}]
    for key, name, counter, replaces in (
            ('K1', 'kmer_hashes (wire-format k-mer hashing)', 'kmer_hashes',
             'kevlar_tpu/ops/hashing.py:82'),
            ('K2', 'gather_counts (Count-Min min over tables)',
             'gather_counts', 'kevlar_tpu/ops/sketch_ops.py:60'),
            ('K3', 'scatter_add (per-table int32 bincount)', 'scatter_add',
             'tools/scatter_probe.py:76')):
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'kevlar_tpu_torch/csrc/kmer.cu', 'replaces': replaces,
            'launches': trio['launches'][counter],
            'max_abs_err': kmer[key]['err'], 'ms': kmer[key]['ms'],
            'plain_ms': kmer[key]['plain_ms']})
    kernels.append({
        'name': 'cc_labels (read-graph min-label propagation)',
        'route': 'cuda', 'source': 'kevlar_tpu_torch/csrc/cc.cu',
        'replaces': 'kevlar_tpu/ops/cc_ops.py:16',
        'launches': part['launches'], 'max_abs_err': cc['err'],
        'ms': cc['ms'], 'plain_ms': cc['plain_ms']})
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
