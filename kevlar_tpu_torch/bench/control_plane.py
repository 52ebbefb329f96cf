"""Human-scale stress of the partition and localize control paths; the
port's counterpart of ``tools/control_plane_stress.py``.

The partition stage's components and the localizer's clustering run on
the host apart from K4; this entry synthesises those workloads at up to
~40x the 80 Mb bigsim run and measures:

1. connected components of the read <-> k-mer incidence: the host
   union-find against K4 (``ops/cc_ops.connected_components_bipartite`` on
   ``--device`` tensors, called directly, whatever the pair count), at
   bigsim scale and at ``--scale`` times it;
2. the whole partition stage (``ReadGraph.load``, the components on
   ``--device`` and each partition's dedup) on synthetic annotated reads;
3. the localizer's seed-position clustering (sort and gap split per
   sequence) over millions of seed hits on 25 chromosomes.

Draws the JAX entry's data from the same seeded generators in the same
order and prints its JSON line, with its keys.  Writes the JSON to a file
only where ``--out`` says.

Usage:  python -m kevlar_tpu_torch.bench.control_plane [--scale 40]
        [--out PATH] [--device cuda|cpu]
"""

import argparse
import json
import random
import sys
import time

import numpy as np

from kevlar_tpu_torch.bench import add_device_arg, start


def synth_incidence(rng, n_parts, reads_per_part, kmers_per_part):
    """Bipartite (read, kmer) incidence of n_parts disjoint components."""
    reads, kmers = [], []
    rbase = kbase = 0
    for p in range(n_parts):
        nr = 1 + int(rng.integers(1, reads_per_part * 2))
        nk = 1 + int(rng.integers(1, kmers_per_part * 2))
        # each read carries a few of the partition's k-mers
        for r in range(nr):
            picks = rng.integers(0, nk, size=min(nk, 8))
            for k in np.unique(picks):
                reads.append(rbase + r)
                kmers.append(kbase + int(k))
        rbase += nr
        kbase += nk
    return (np.array(reads, np.int32), np.array(kmers, np.int32),
            rbase, kbase)


def cc_incidence(scale):
    """The components' incidence at ``scale``: ~1,500 partitions a bigsim
    run (its round-3 count), ~12 reads and ~20 k-mers each."""
    return synth_incidence(np.random.default_rng(7), int(1500 * scale), 12,
                           20)


def device_labels(reads, kmers, n_reads, n_kmers, device):
    """K4's labels from host arrays: the copies to ``device``, the
    components there and the labels back on the host."""
    import torch
    from kevlar_tpu_torch.ops import cc_ops
    labels = cc_ops.connected_components_bipartite(
        torch.from_numpy(reads).to(device), torch.from_numpy(kmers).to(device),
        n_reads, n_kmers)
    return labels.cpu().numpy()


def bench_cc(scale, device):
    from kevlar_tpu_torch.ops import cc_ops
    reads, kmers, n_reads, n_kmers = cc_incidence(scale)
    rows = {'incidences': len(reads), 'reads': n_reads,
            'partitions': int(1500 * scale)}

    t0 = time.time()
    host = cc_ops.host_connected_components(reads, kmers, n_reads, n_kmers)
    rows['host_union_find_s'] = round(time.time() - t0, 2)

    t0 = time.time()
    dev = device_labels(reads, kmers, n_reads, n_kmers, device)
    rows['device_label_prop_first_s'] = round(time.time() - t0, 2)
    t0 = time.time()
    dev = device_labels(reads, kmers, n_reads, n_kmers, device)
    rows['device_label_prop_steady_s'] = round(time.time() - t0, 2)
    if not np.array_equal(host, dev):
        raise AssertionError('CC backends disagree')
    return rows


def bench_partition_stage(scale, device):
    """The whole stage on synthetic annotated reads (the novel stage's
    output shape): ~400 partitions a bigsim run (its ~50k novel reads)."""
    from kevlar_tpu_torch.readgraph import ReadGraph
    from kevlar_tpu_torch.sequence import Record

    rng = random.Random(11)
    n_parts = int(400 * scale)
    readlen = 100
    records = []
    for p in range(n_parts):
        # one shared novel k-mer neighborhood per partition
        core = ''.join(rng.choice('ACGT') for _ in range(readlen + 40))
        nreads = rng.randint(4, 24)
        for r in range(nreads):
            off = rng.randint(0, 40)
            seq = core[off:off + readlen]
            rec = Record(name='p{}r{}'.format(p, r), sequence=seq,
                         quality='I' * readlen)
            for x in range(rng.randint(1, 6)):
                ko = rng.randint(0, readlen - 31)
                rec.annotate(seq[ko:ko + 31], ko, (9, 0, 0))
            records.append(rec)
    t0 = time.time()
    graph = ReadGraph(device=device)
    graph.load(iter(records))
    load_s = time.time() - t0
    t0 = time.time()
    nparts = sum(1 for _ in graph.partitions(dedup=True, minabund=2,
                                             maxabund=200))
    part_s = time.time() - t0
    return {'reads': len(records), 'partitions_found': nparts,
            'graph_load_s': round(load_s, 2),
            'partitions_s': round(part_s, 2)}


def bench_localize_cluster(scale):
    from kevlar_tpu_torch.localize import Localizer
    rng = np.random.default_rng(3)
    n_hits = int(50_000 * scale)
    loc = Localizer(seedsize=51)
    seqids = ['chr{}'.format(i) for i in range(1, 26)]
    t0 = time.time()
    for s in seqids:
        for pos in rng.integers(0, 119_000_000, size=n_hits // 25):
            loc.add_seed_match(s, int(pos))
    add_s = time.time() - t0
    t0 = time.time()
    cutouts = sum(1 for _ in loc.get_cutouts(refrseqs=None, delta=50,
                                             clusterdist=1000))
    cluster_s = time.time() - t0
    return {'seed_hits': n_hits, 'add_s': round(add_s, 2),
            'cluster_s': round(cluster_s, 2), 'cutouts': cutouts}


def main(argv=None):
    """Run the four measurements; returns the printed result."""
    ap = argparse.ArgumentParser(
        description='human-scale stress of the partition and localize '
        'control paths')
    ap.add_argument('--scale', type=float, default=40.0,
                    help='multiplier over the 80 Mb bigsim workload '
                         '(40 ~= human)')
    ap.add_argument('--out', metavar='PATH',
                    help='also write the result there (indented JSON)')
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = start(args.device)

    result = {'suite': 'control_plane_stress', 'scale_vs_bigsim': args.scale}
    result['cc_bigsim_scale'] = bench_cc(1.0, device)
    result['cc_human_scale'] = bench_cc(args.scale, device)
    result['partition_stage_human_scale'] = bench_partition_stage(
        args.scale, device)
    result['localize_cluster_human_scale'] = bench_localize_cluster(
        args.scale)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    if args.out:
        print('# wrote', args.out, file=sys.stderr)
    return result


if __name__ == '__main__':
    main()
