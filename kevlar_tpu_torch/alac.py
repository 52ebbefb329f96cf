"""``alac`` stage: fused assemble → localize → align → call.

One pass over a partitioned read stream: assemble every partition into
contigs, localize all contigs against the reference in a single seed-index
sweep, align every partition's contig x cutout pairs as one batch on
``device`` (the CUDA kernel of :mod:`kevlar_tpu_torch.ops.align_cuda` on a
GPU, its plain PyTorch version on the CPU), then call variants per
partition and emit them sorted by (seqid, position). Contract: reference
kevlar/alac.py:19-92, with ``--threads`` parallelizing the per-partition
call step (the reference's flag is serial, ref cli/alac.py:92-94).
"""

from collections import defaultdict

import kevlar_tpu_torch
from kevlar_tpu_torch import seqio


def _assembled_contigs(pstream, maxreads, threads, min_ikmers):
    from kevlar_tpu_torch import assemble
    grouped = defaultdict(list)
    for partid, contig in assemble.assemble(pstream, maxreads=maxreads,
                                            threads=threads):
        if min_ikmers is None or len(contig.annotations) >= min_ikmers:
            grouped[partid].append(contig)
    return grouped


def _localized_targets(contigs_by_partition, refrfile, **kw):
    from kevlar_tpu_torch import localize
    grouped = defaultdict(list)
    for partid, gdna in localize.localize(
            sorted(contigs_by_partition.items(),
                   key=lambda kv: (kv[0] is None, kv[0])),
            refrfile, **kw):
        grouped[partid].append(gdna)
    return grouped


def alac(pstream, refrfile, threads=1, ksize=31, maxreads=10000, delta=50,
         seedsize=31, maxdiff=None, inclpattern=None, exclpattern=None,
         match=1, mismatch=2, gapopen=5, gapextend=0, min_ikmers=None,
         maskfile=None, maskmem=1e6, maskmaxfpr=0.01, maxtargetlen=10000,
         device='cuda'):
    import time
    from kevlar_tpu_torch import call as call_mod

    t0 = time.time()
    contigs = _assembled_contigs(pstream, maxreads, threads, min_ikmers)
    t1 = time.time()
    targets = _localized_targets(
        contigs, refrfile, seedsize=seedsize, delta=delta, maxdiff=maxdiff,
        inclpattern=inclpattern, exclpattern=exclpattern, device=device)
    t2 = time.time()

    # one global alignment batch across every partition — the
    # device-parallel analog of the reference's N parallel call shards
    # (Snakefile:345-356)
    strandings = call_mod.align_partitions(
        {partid: call_mod.partition_jobs(
            targets[partid], contigs[partid], maxtargetlen)[3]
         for partid in targets},
        match=match, mismatch=mismatch, gapopen=gapopen,
        gapextend=gapextend, device=device)
    t3 = time.time()

    def call_one(partid):
        return list(call_mod.call(
            targets[partid], contigs[partid], partid, match=match,
            mismatch=mismatch, gapopen=gapopen, gapextend=gapextend,
            ksize=ksize, refrfile=refrfile, maxtargetlen=maxtargetlen,
            strandings=strandings[partid], device=device))

    partids = sorted(targets, key=lambda p: (p is None, p))
    calls = []
    if threads and threads > 1:
        # the alignments are already done, so workers only interpret them
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as pool:
            for partcalls in pool.map(call_one, partids):
                calls += partcalls
    else:
        for partid in partids:
            calls += call_one(partid)
    calls.sort(key=lambda c: (c.seqid, c.position))
    t4 = time.time()

    if maskfile:
        kevlar_tpu_torch.plog('[kevlar::alac] generating mask of '
                              'variant-spanning k-mers')
        call_mod.make_call_mask(calls, ksize, maskmem, maskmaxfpr, maskfile,
                                logprefix='[kevlar::alac]')
    kevlar_tpu_torch.plog(
        '[kevlar::alac] phase walls: assemble {:.1f}s, localize {:.1f}s, '
        'align {:.1f}s, call {:.1f}s, mask {:.1f}s'.format(
            t1 - t0, t2 - t1, t3 - t2, t4 - t3, time.time() - t4))
    yield from calls


def main(args):
    from kevlar_tpu_torch import vcf
    readstream = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(args.infile, 'r'))
    if args.part_id:
        pstream = seqio.parse_single_partition(readstream, args.part_id)
    else:
        pstream = seqio.parse_partitioned_reads(readstream)
    writer = vcf.VCFWriter(kevlar_tpu_torch.open(args.out, 'w'),
                           source='kevlar::alac', refr=args.refr)
    writer.write_header()
    for varcall in alac(pstream, args.refr, threads=args.threads,
                        ksize=args.ksize, maxreads=args.max_reads,
                        delta=args.delta, seedsize=args.seed_size,
                        maxdiff=args.max_diff, inclpattern=args.include,
                        exclpattern=args.exclude, match=args.match,
                        mismatch=args.mismatch, gapopen=args.open,
                        gapextend=args.extend, min_ikmers=args.min_ikmers,
                        maskfile=args.gen_mask, maskmem=args.mask_mem,
                        maskmaxfpr=args.mask_max_fpr,
                        maxtargetlen=args.max_target_length,
                        device=args.device):
        writer.write(varcall)
