#!/usr/bin/env python3
"""GPU smoke run of kevlar_tpu_torch: build, check and drive the alac slice.

    python3 chip_smoke.py        # needs one CUDA GPU; a few minutes

Phases (any failure raises, and the script exits non-zero):

1. card: a CUDA device must be present; print its name and power limit;
2. build: ``csrc/align.cu`` with nvcc for sm_90a and the C++ assembler with
   g++, into the package's build directory; print the seconds each took;
3. kernel: the ksw_extz kernel against its plain PyTorch version on the
   card, on seeded pairs at the call stage's shapes (targets 100-2,000 bp,
   queries 100-1,000 bp, a few 10,000 bp targets, one pair whose wavefront
   state needs global memory, N bases, tandem-repeat ties) under gap
   penalties (5,0), (5,2) and (3,1): scores, op streams and exit cells must
   be identical (tolerance 0: the DP is integer arithmetic);
4. slice: :func:`make_alac_case` writes a bigsim-scale input (80 Mb
   reference, 1,500 de novo loci in the bigsim class mix, 150 bp reads at
   15x from the alt haplotype, one ``kvcc=`` partition per locus); the seed
   index is built apart (timed), then ``kevlar_tpu_torch.cli.main(['alac',
   ..., '--device', 'cuda'])`` runs the slice.  Every pair the run aligned
   is aligned again with the plain version on the card (results must be
   identical, and both are timed), the kernel's launch count over the run
   must be positive, and the VCF is scored against the truth: recall below
   0.90 fails.

The last two lines of standard output are the kernels record (JSON) and
``{"ok": true, "device": {...}}``.  The generator imports nothing but
numpy, so tests import it to build small cases.
"""

import json
import os
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
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    device = 'cuda'
    smi = _nvidia_smi()
    print(smi, flush=True)

    from kevlar_tpu_torch import native
    from kevlar_tpu_torch.ops import align_cuda
    t0 = time.time()
    align_cuda.build(force=True)
    nvcc_s = time.time() - t0
    t0 = time.time()
    native.build(force=True)
    gxx_s = time.time() - t0
    print('[smoke] built csrc/align.cu (nvcc, sm_90a) in {:.1f} s, '
          'asm.cpp (g++) in {:.1f} s'.format(nvcc_s, gxx_s), flush=True)

    err = phase_kernel(device)
    with tempfile.TemporaryDirectory() as workdir:
        run = phase_slice(device, workdir)

    print(smi)
    print(json.dumps({'kernels': [{
        'name': 'ksw_extz (wavefront DP + traceback)', 'route': 'cuda',
        'source': 'kevlar_tpu_torch/csrc/align.cu',
        'replaces': 'kevlar_tpu/ops/align_pallas.py:204',
        'launches': run['launches'], 'max_abs_err': max(err, run['err']),
        'ms': run['ms'], 'plain_ms': run['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
