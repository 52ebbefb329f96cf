"""Benchmark: count+novel throughput (reads/s) on the device; the port's
counterpart of ``bench.py``.

    python -m kevlar_tpu_torch.bench.count_novel [--device cuda|cpu]

Generates ``bench.py``'s synthetic trio (tiled error-free reads over a
random genome with 20 de novo SNVs in the proband, drawn in the same
order from the same seed), runs the whole device pipeline, Count-Min
counting of all three samples plus the novel-k-mer screen of the case
reads (``ops.novel_ops.count_and_screen_stack_packed``: K1,
``kt_consume`` and ``kt_screen_reads`` on a card), and prints
``bench.py``'s JSON line:

    {"metric": "count_novel_reads_per_s", "value": N, "unit": "reads/s",
     "vs_baseline": R}

The timed region is ``bench.py``'s: the packed stacks' copies into the
device, the program and the read-back of the hit count; one untimed run
first (the kernels' build), then the best of 3.  A ``#`` line on
standard error gives the copies' and the program's milliseconds apart.
``vs_baseline`` is the device against the idealised vectorised-numpy CPU
baseline (``host_pipeline``); the per-read loop of the reference's novel
hot path (``reference_style_baseline``) is reported on standard error as
``vs_reference_architecture``.  ``KEVLAR_BENCH_BATCH`` sets the batch
rows, as in ``bench.py``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from kevlar_tpu_torch.bench import add_device_arg, start

KSIZE = 31
READLEN = 150
PADLEN = 160
BATCH = int(os.environ.get('KEVLAR_BENCH_BATCH', 8192))
GENOME_LEN = 200_000
COVERAGE = 30
TABLESIZE = 2_000_003
CASEMIN, CTRLMAX = 6, 1
SEED = 20260817


def make_genome(rng, n):
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def tile_reads(genome, readlen, coverage, rng):
    """Error-free reads at random starts, padded to ``PADLEN`` with code
    4."""
    n_reads = len(genome) * coverage // readlen
    starts = rng.integers(0, len(genome) - readlen, size=n_reads)
    idx = starts[:, None] + np.arange(readlen)[None, :]
    reads = genome[idx]
    out = np.full((n_reads, PADLEN), 4, dtype=np.uint8)
    out[:, :readlen] = reads
    return out


def batches(reads):
    for i in range(0, len(reads), BATCH):
        chunk = reads[i:i + BATCH]
        if len(chunk) < BATCH:
            pad = np.full((BATCH - len(chunk), PADLEN), 4, np.uint8)
            chunk = np.concatenate([chunk, pad])
        yield chunk


def stack_all(reads):
    """[N, PADLEN] -> [NB, BATCH, PADLEN] (rows padded with invalid)."""
    NB = -(-len(reads) // BATCH)
    out = np.full((NB * BATCH, PADLEN), 4, dtype=np.uint8)
    out[:len(reads)] = reads
    return out.reshape(NB, BATCH, PADLEN)


def bench_trio(genome_len=GENOME_LEN):
    """``bench.py``'s trio as its ``main`` draws it: (case, mother,
    father) reads [N, PADLEN] uint8; the case carries 20 de novo SNVs."""
    rng = np.random.default_rng(SEED)
    genome = make_genome(rng, genome_len)
    child = genome.copy()
    snv_positions = rng.choice(genome_len - 100, size=20, replace=False) + 50
    child[snv_positions] = (child[snv_positions] +
                            rng.integers(1, 4, size=len(snv_positions))) % 4
    case = tile_reads(child, READLEN, COVERAGE, rng)
    mom = tile_reads(genome, READLEN, COVERAGE, rng)
    dad = tile_reads(genome, READLEN, COVERAGE, rng)
    return case, mom, dad


def device_pipeline(case_reads, ctrl_reads_list, device='cuda'):
    """Count 3 samples + screen the case reads on ``device``.

    The stacks are packed to ``kevlar_tpu``'s 2-bit wire format on the
    host; each run copies them to the device as they lie, runs the whole
    count and screen as one program and reads the hit count back.
    Returns (best wall seconds, interesting k-mers, (copies seconds,
    program seconds) of the best run)."""
    import torch
    from kevlar_tpu_torch.batch import pack_bases
    from kevlar_tpu_torch.ops import novel_ops

    device = torch.device(device)
    all_reads = [case_reads] + ctrl_reads_list
    packed_stacks = [pack_bases(stack_all(r)) for r in all_reads]
    NB = packed_stacks[0][0].shape[0]
    lens = np.full((NB, BATCH), READLEN, np.int32)
    lens.reshape(-1)[len(case_reads):] = 0
    host = [x for stack in packed_stacks for x in stack] + [lens]

    def run():
        t0 = time.time()
        case_packed, case_bad, *ctrl, dlens = [
            torch.from_numpy(x).to(device) for x in host]
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t1 = time.time()
        outs, _, _ = novel_ops.count_and_screen_stack_packed(
            case_packed, case_bad, tuple(ctrl[0::2]), tuple(ctrl[1::2]),
            dlens, L=PADLEN, ksize=KSIZE, tablesize=TABLESIZE, ntables=4,
            maxcount=255, casemin=CASEMIN, ctrlmax=CTRLMAX)
        hit_idx, hit_abunds, n_hits, discard, skip = outs
        n_interesting = int(n_hits.sum())
        t2 = time.time()
        return t2 - t0, n_interesting, (t1 - t0, t2 - t1)

    print('# bench: building the kernels, first run of the count+screen '
          'pipeline...', file=sys.stderr, flush=True)
    run()
    print('# bench: built; timing device pipeline', file=sys.stderr,
          flush=True)
    best = min((run() for _ in range(3)), key=lambda r: r[0])
    return best


def host_pipeline(case_reads, ctrl_reads_list):
    """Single-threaded numpy version of the same workload (CPU baseline).
    Returns (seconds, interesting k-mers)."""
    from kevlar_tpu_torch import dna

    ntables = 4

    def consume(reads):
        tables = np.zeros((ntables, TABLESIZE), dtype=np.uint8)
        for i in range(0, len(reads), BATCH):
            chunk = reads[i:i + BATCH]
            h1, h2, valid = dna.kmer_hashes(chunk, KSIZE)
            h1f = h1[valid]
            h2f = h2[valid]
            for t in range(ntables):
                idx = (h1f + np.uint32(t) * h2f) % np.uint32(TABLESIZE)
                inc = np.bincount(idx.astype(np.int64), minlength=TABLESIZE)
                tables[t] = np.minimum(
                    tables[t].astype(np.int64) + inc, 255).astype(np.uint8)
        return tables

    def gather(tables, h1, h2):
        counts = None
        for t in range(ntables):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(TABLESIZE)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        return counts

    t0 = time.time()
    all_tables = [consume(r) for r in [case_reads] + ctrl_reads_list]
    n_interesting = 0
    for i in range(0, len(case_reads), BATCH):
        chunk = case_reads[i:i + BATCH]
        h1, h2, valid = dna.kmer_hashes(chunk, KSIZE)
        case_counts = gather(all_tables[0], h1, h2)
        ok = valid & (case_counts >= CASEMIN)
        for tb in all_tables[1:]:
            ok &= gather(tb, h1, h2) <= CTRLMAX
        n_interesting += int(ok.sum())
    elapsed = time.time() - t0
    return elapsed, n_interesting


def reference_style_baseline(case_reads, ctrl_reads_list, tables_list,
                             nsub=2000):
    """Per-read loop with per-sample point lookups: the reference's novel
    hot path (novel.py:95-176), against pre-built host tables."""
    from kevlar_tpu_torch import dna

    def gather(tables, h1, h2):
        counts = None
        for t in range(4):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(TABLESIZE)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        return counts

    sub = case_reads[:nsub]
    t0 = time.time()
    n_interesting = 0
    for read in sub:
        h1, h2, valid = dna.kmer_hashes(read[None, :], KSIZE)
        case_counts = gather(tables_list[0], h1[0], h2[0])
        keep = valid[0] & (case_counts >= CASEMIN)
        for tb in tables_list[1:]:
            ctrl_counts = gather(tb, h1[0], h2[0])
            keep &= ctrl_counts <= CTRLMAX
        n_interesting += int(keep.sum())
    elapsed = time.time() - t0
    # the counting pass is charged at the idealised vectorised rate (free
    # here), making this an upper bound on the reference's throughput
    return nsub / elapsed


def build_tables(reads):
    """One sample's 4 x TABLESIZE uint8 tables of ``reads`` in one pass
    (the reference-architecture baseline's pre-built tables)."""
    from kevlar_tpu_torch import dna
    tables = np.zeros((4, TABLESIZE), dtype=np.uint8)
    h1, h2, valid = dna.kmer_hashes(reads, KSIZE)
    h1f, h2f = h1[valid], h2[valid]
    for t in range(4):
        idx = (h1f + np.uint32(t) * h2f) % np.uint32(TABLESIZE)
        inc = np.bincount(idx.astype(np.int64), minlength=TABLESIZE)
        tables[t] = np.minimum(inc, 255).astype(np.uint8)
    return tables


def main(argv=None):
    """Run the benchmark; returns what it measured (the printed result,
    the interesting k-mers, the copies' and the program's seconds)."""
    ap = argparse.ArgumentParser(
        description='count+novel reads/s of the fused count and screen')
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)

    case_reads, mom_reads, dad_reads = bench_trio(GENOME_LEN)
    total_reads = len(case_reads) * 2 + len(mom_reads) + len(dad_reads)

    device_s, dev_hits, (copy_s, program_s) = device_pipeline(
        case_reads, [mom_reads, dad_reads], device)
    reads_per_s = total_reads / device_s

    # CPU baseline on a subset, extrapolated; best of 3 (the host number is
    # sensitive to machine contention)
    sub = max(len(case_reads) // 8, BATCH)
    host_s = None
    for rep in range(3):
        elapsed, host_hits = host_pipeline(
            case_reads[:sub], [mom_reads[:sub], dad_reads[:sub]])
        host_s = elapsed if host_s is None else min(host_s, elapsed)
    host_total = sub * 4
    host_reads_per_s = host_total / host_s

    # faithful reference-architecture baseline (per-read loop)
    tables_list = [build_tables(r[:len(case_reads) // 4])
                   for r in (case_reads, mom_reads, dad_reads)]
    ref_reads_per_s = reference_style_baseline(
        case_reads, [mom_reads, dad_reads], tables_list)

    result = {
        'metric': 'count_novel_reads_per_s',
        'value': round(reads_per_s, 1),
        'unit': 'reads/s',
        'vs_baseline': round(reads_per_s / host_reads_per_s, 2),
    }
    print(json.dumps(result), flush=True)
    print('# device: {:.2f}s for {} reads ({} interesting kmers)'.format(
        device_s, total_reads, dev_hits), file=sys.stderr)
    print('# idealised vectorised CPU baseline (the headline denominator): '
          '{:.2f}s for {} reads -> {:.0f} reads/s'.format(
              host_s, host_total, host_reads_per_s), file=sys.stderr)
    print('# reference-architecture CPU baseline (per-read loop, the '
          'BASELINE.md 10x target): {:.0f} reads/s -> '
          'vs_reference_architecture {:.1f}x'.format(
              ref_reads_per_s, reads_per_s / ref_reads_per_s),
          file=sys.stderr)
    print('# of the best run: the stacks\' copies to {} {:.3f} ms, the '
          'program and the hit count\'s read-back {:.3f} ms'.format(
              device, 1e3 * copy_s, 1e3 * program_s), file=sys.stderr,
          flush=True)
    return dict(result=result, interesting=dev_hits, wall_s=device_s,
                copy_s=copy_s, program_s=program_s, host_s=host_s,
                host_reads=host_total, ref_reads_per_s=ref_reads_per_s)


if __name__ == '__main__':
    main()
