"""Secondary benchmark: assemble+call throughput (contigs/s); the port's
counterpart of ``bench_call.py``.

    python -m kevlar_tpu_torch.bench.call [--device cuda|cpu]

Simulates ``bench_call.py``'s partitioned variant loci (reads tiling a
mutated locus, drawn from the same seed in the same order), then
measures the two call-path engines end to end:

- assemble (``native.assemble``, the C++ overlap assembler) + direct
  alignment of each contig against its locus cutout with the C++ aligner
  (``ops.align.align_both_strands``; the host path)
- the batched ksw2 aligner on the device
  (``ops.align_cuda.align_batch``: ``kt_ksw_dp`` + ``kt_ksw_traceback``
  on a card), on the loci's rows and on ``REP`` copies of them in one
  call; each is called twice and the first call, which builds the
  kernels, is reported apart

The C++ libraries load, and build at first use, before any timer.

Prints ``bench_call.py``'s three JSON lines, one per engine.
"""

import argparse
import json
import random
import sys
import time

from kevlar_tpu_torch.bench import add_device_arg, start

N_LOCI = 64
REP = 16
SEED = 20260817


def make_genome(rng, n):
    return ''.join(rng.choice('ACGT') for _ in range(n))


def make_loci(rng, n_loci=N_LOCI, locus=300, readlen=100, step=10):
    """Returns (partitions, cutouts): reads per locus + the reference span."""
    partitions, cutouts = [], []
    for _ in range(n_loci):
        g = make_genome(rng, locus + 200)
        pos = locus // 2 + 100
        alt = rng.choice([b for b in 'ACGT' if b != g[pos]])
        child = g[:pos] + alt + g[pos + 1:]
        reads = [child[i:i + readlen]
                 for i in range(100, locus + 100 - readlen + 1, step)]
        partitions.append(reads)
        cutouts.append(g[50:locus + 150])
    return partitions, cutouts


def main(argv=None):
    """Run the benchmark; returns what it measured, with the device
    rows (``targets``, ``queries``) and their second call's ``aligned``
    ``(cigar, score)`` pairs."""
    from kevlar_tpu_torch import native
    from kevlar_tpu_torch.ops.align import align_both_strands
    from kevlar_tpu_torch.ops.align_cuda import align_batch

    ap = argparse.ArgumentParser(description='assemble+call contigs/s')
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)

    rng = random.Random(SEED)
    partitions, cutouts = make_loci(rng, N_LOCI)
    # the C++ assembler and aligner load (building at first use) before
    # the timer, as the JAX entry's native.available() does
    native.load()
    native.load_align()

    # assemble all partitions
    t0 = time.time()
    contigs = []
    for reads in partitions:
        contigs.append(max(native.assemble(reads, min_overlap=45), key=len))
    asm_s = time.time() - t0

    # host path: C++ aligner, both strands per contig x cutout
    t0 = time.time()
    for contig, cutout in zip(contigs, cutouts):
        align_both_strands(cutout, contig)
    host_s = time.time() - t0

    # device path: batched wavefront (forward strand; both-strand batched
    # doubles the batch)
    targets = cutouts + cutouts
    queries = contigs + [c[::-1] for c in contigs]
    t0 = time.time()
    align_batch(targets, queries, device=device)
    dev_first = time.time() - t0  # includes the kernels' build
    t0 = time.time()
    aligned = align_batch(targets, queries, device=device)
    dev_s = time.time() - t0

    # device path at aggregation scale: one call covering the alignments
    # of many alac flushes at once
    big_t = targets * REP
    big_q = queries * REP
    t0 = time.time()
    align_batch(big_t, big_q, device=device)
    big_first = time.time() - t0
    t0 = time.time()
    align_batch(big_t, big_q, device=device)
    big_s = time.time() - t0

    n = len(contigs)
    results = [{
        'metric': 'assemble_call_contigs_per_s_host',
        'value': round(n / (asm_s + host_s), 1), 'unit': 'contigs/s'}, {
        'metric': 'call_align_contigs_per_s_device',
        'value': round(n / dev_s, 1), 'unit': 'contigs/s'}, {
        'metric': 'call_align_contigs_per_s_device_batched',
        'value': round(n * REP / big_s, 1), 'unit': 'contigs/s'}]
    for line in results:
        print(json.dumps(line))
    sys.stdout.flush()
    print('# assemble: {:.3f}s; host align: {:.3f}s; device align: {:.3f}s '
          '(first, including the build, {:.1f}s) for {} loci'.format(
              asm_s, host_s, dev_s, dev_first, n), file=sys.stderr)
    print('# device at aggregation scale: {:.3f}s (first {:.1f}s) for {} '
          'loci ({} pair alignments per call)'.format(
              big_s, big_first, n * REP, len(big_t)), file=sys.stderr,
          flush=True)
    return dict(results=results, asm_s=asm_s, host_s=host_s, dev_s=dev_s,
                dev_first_s=dev_first, big_s=big_s, big_first_s=big_first,
                targets=targets, queries=queries, aligned=aligned)


if __name__ == '__main__':
    main()
