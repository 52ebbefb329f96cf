"""``call`` stage: align contigs to reference cutouts and call variants.

Per partition, every contig aligns against every cutout (all pairs batched
through the ksw2 wavefront on the chosen device, ops/align_cuda.py); only
the interpretable alignment(s) with the optimal score are reported. Calls
dedup by (seqid, pos) keeping the longest window, adjacent SNVs merge into
MNVs, targets beyond ``--max-target-length`` become no-calls, and
``--gen-mask`` persists a Bloom mask of variant-spanning k-mers.
Behavioral contract: reference kevlar/call.py:18-172.
"""

import kevlar_tpu_torch
from kevlar_tpu_torch.ops.align import align_both_strands_batch
from kevlar_tpu_torch.varmap import VariantMapping


def alignments_to_report(alignments):
    """The interpretable alignment(s) with the optimal score (all of them,
    when interpretable ones exist; otherwise everything ties).

    Canonically interpretable alignments (snv/indel shapes — the
    reference's report pool, call.py alignments_to_report) always take
    priority; 'complex' alignments form a RESCUE tier used only when no
    canonical shape exists anywhere (a high-scoring repeat-locus
    alignment must not displace the true locus's clean call)."""
    if len(alignments) <= 1:
        return alignments
    pool = [aln for aln in alignments if aln.vartype in ('snv', 'indel')]
    if not pool:
        pool = [aln for aln in alignments if aln.vartype is not None]
    if not pool:
        pool = alignments
    best = max(aln.score for aln in pool)
    return [aln for aln in pool if aln.score == best]


def dedup(callstream):
    """One call per (seqid, position): keep the widest window."""
    best = {}
    for call in callstream:
        key = (call.seqid, call.position)
        rival = best.get(key)
        if rival is None or call.windowlength > rival.windowlength:
            best[key] = call
    for key in sorted(best):
        yield best[key]


def merge_adjacent(callstream):
    """Fold immediately adjacent compatible SNVs into MNVs."""
    held = None
    for call in callstream:
        if held is not None and held.test_merge(call) is not None:
            continue  # `call` absorbed into `held`; keep extending it
        if held is not None:
            yield held
        held = call
    if held is not None:
        yield held


def _partition_mappings(targets, oversize, query, strandings, **kw):
    """VariantMappings of one query against every target, consuming
    precomputed (score, cigar, strand) tuples for the aligned ones."""
    mappings = []
    for target, toobig in zip(targets, oversize):
        if toobig:
            mappings.append(VariantMapping(query, target, nocall=True))
        else:
            score, cigar, strand = next(strandings)
            mappings.append(VariantMapping(
                query, target, score=score, cigar=cigar, strand=strand, **kw))
    return mappings


def partition_jobs(targetlist, querylist, maxtargetlen=10000):
    """The deterministic per-partition alignment work list: (sorted
    queries, sorted targets, oversize flags, (target, query) jobs) — the
    exact ordering contract of :func:`prelim_call`."""
    queries = sorted(querylist, reverse=True, key=len)
    targets = sorted(targetlist, key=lambda cutout: cutout.defline)
    oversize = [bool(maxtargetlen and len(t) > maxtargetlen)
                for t in targets]
    jobs = [(t.sequence, q.sequence)
            for q in queries
            for t, big in zip(targets, oversize) if not big]
    return queries, targets, oversize, jobs


def align_partitions(jobs_by_partition, match=1, mismatch=2, gapopen=5,
                     gapextend=0, device='cuda', mesh=None):
    """Align EVERY partition's (target, query) jobs as one global batch.

    The replacement for the reference's N parallel ``call`` shard
    processes (workflows/mark-I/Snakefile:345-356): instead of scattering
    partitions over processes, the (contig x cutout) pairs of all
    partitions concatenate into one batch on ``device``, or cut over the
    devices of ``mesh``.  Returns {partid: [(score, cigar, strand), ...]}
    in each partition's job order.
    """
    order = sorted(jobs_by_partition, key=lambda p: (p is None, str(p)))
    flat = []
    for pid in order:
        flat += jobs_by_partition[pid]
    results = align_both_strands_batch(
        flat, match=match, mismatch=mismatch, gapopen=gapopen,
        gapextend=gapextend, device=device, mesh=mesh)
    out = {}
    pos = 0
    for pid in order:
        n = len(jobs_by_partition[pid])
        out[pid] = results[pos:pos + n]
        pos += n
    return out


def prelim_call(targetlist, querylist, partid=None, match=1, mismatch=2,
                gapopen=5, gapextend=0, ksize=31, refrfile=None, debug=False,
                mindist=5, homopolyfilt=True, maxtargetlen=10000,
                strandings=None, device='cuda'):
    """The core calling procedure, as a generator.

    ``strandings`` supplies precomputed (score, cigar, strand) tuples in
    job order (from :func:`align_partitions`); without it the partition's
    jobs align here in one batch on ``device``.
    """
    queries, targets, oversize, jobs = partition_jobs(
        targetlist, querylist, maxtargetlen)
    if strandings is None:
        strandings = align_both_strands_batch(
            jobs, match=match, mismatch=mismatch, gapopen=gapopen,
            gapextend=gapextend, device=device)
    strandings = iter(strandings)

    for query in queries:
        mappings = _partition_mappings(
            targets, oversize, query, strandings,
            homopolyfilt=homopolyfilt)
        for aln in alignments_to_report(mappings):
            if debug:
                kevlar_tpu_torch.plog(
                    'DEBUG ', aln.cutout.defline, ' vs ', aln.contig.name,
                    '\n', str(aln), sep='', end='\n\n')
            for varcall in aln.call_variants(ksize, mindist):
                if partid is not None:
                    varcall.annotate('PART', partid)
                yield varcall


def call(*args, **kwargs):
    """prelim_call + dedup + adjacent-SNV merge."""
    yield from merge_adjacent(dedup(prelim_call(*args, **kwargs)))


def load_contigs(contigstream):
    kevlar_tpu_torch.plog(
        '[kevlar::call] Loading contigs into memory by partition')
    by_partition = dict(contigstream)
    ncontigs = sum(len(c) for c in by_partition.values())
    kevlar_tpu_torch.plog('[kevlar::call] Loaded {} contigs from {} '
                          'partitions'.format(ncontigs, len(by_partition)))
    return by_partition


def make_call_mask(calls, ksize, maskmem, maskmaxfpr=0.01, maskfile=None,
                   logprefix='[kevlar::call]'):
    """Build a Bloom mask of ALTWINDOW k-mers from a call set.

    The mask is a khmer-binary-compatible nodetable (oxli engine), so a
    ``--gen-mask`` file is byte-identical to the reference's and to
    ``kevlar_tpu``'s, and can be fed to either implementation.
    """
    from kevlar_tpu_torch import sketch
    from kevlar_tpu_torch.oxli import OxliSketch
    buckets = int(maskmem) * sketch.BUCKETS_PER_BYTE[1] // 4
    mask = OxliSketch(ksize, buckets, 4, counter_bits=1)
    for varcall in calls:
        window = varcall.attribute('ALTWINDOW')
        if window is not None and len(window) >= ksize:
            mask.consume(window)
    fpr = sketch.estimate_fpr(mask)
    if fpr > maskmaxfpr:
        kevlar_tpu_torch.plog(
            logprefix,
            'WARNING: mask FPR is {:.4f}; exceeds user-specified limit '
            'of {:.4f}'.format(fpr, maskmaxfpr))
    if maskfile:
        mask.save(maskfile)
    return mask


def main(args):
    from kevlar_tpu_torch import reference, seqio, vcf
    writer = vcf.VCFWriter(kevlar_tpu_torch.open(args.out, 'w'),
                           source='kevlar::call', refr=args.refr)
    writer.write_header()

    mesh = None
    if getattr(args, 'shards', None):
        from kevlar_tpu_torch.parallel import make_mesh
        mesh = make_mesh(n_data=args.shards, n_shard=1, device=args.device)
        kevlar_tpu_torch.plog('[kevlar::call] sharding alignment batches '
                              'over mesh', dict(mesh.shape))

    contigs_by_partition = load_contigs(seqio.parse_partitioned_reads(
        kevlar_tpu_torch.parse_augmented_fastx(
            kevlar_tpu_torch.open(args.queryseq, 'r'))))
    gdnastream = seqio.parse_partitioned_reads(
        reference.load_refr_cutouts(
            kevlar_tpu_torch.open(args.targetseq, 'r')))
    targets_by_partition = [
        (partid, gdnas) for partid, gdnas in gdnastream
        if partid in contigs_by_partition]
    # one global alignment batch across every partition on the device (or
    # cut over the mesh), then per-partition interpretation
    strandings = align_partitions(
        {partid: partition_jobs(gdnas, contigs_by_partition[partid],
                                args.max_target_length)[3]
         for partid, gdnas in targets_by_partition},
        match=args.match, mismatch=args.mismatch, gapopen=args.open,
        gapextend=args.extend, device=args.device, mesh=mesh)
    maskable = []
    for partid, gdnas in targets_by_partition:
        for varcall in call(gdnas, contigs_by_partition[partid], partid,
                            match=args.match, mismatch=args.mismatch,
                            gapopen=args.open, gapextend=args.extend,
                            ksize=args.ksize, refrfile=args.refr,
                            debug=args.debug, mindist=5,
                            homopolyfilt=not args.no_homopoly_filter,
                            maxtargetlen=args.max_target_length,
                            strandings=strandings[partid],
                            device=args.device):
            if args.gen_mask:
                maskable.append(varcall)
            writer.write(varcall)
    if args.gen_mask:
        kevlar_tpu_torch.plog('[kevlar::call] generating mask of '
                              'variant-spanning k-mers')
        make_call_mask(maskable, args.ksize, args.mask_mem,
                       args.mask_max_fpr, args.gen_mask)
