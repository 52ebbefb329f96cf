"""``assemble`` stage: assemble each partition's reads into contigs.

The reference bridges to the fermi-lite C library (FMD-index + unitig graph,
kevlar/assembly.pyx + third-party/fermi-lite).  Here the engine is the
C++ assembler ``kevlar_tpu_torch/csrc/asm.cpp`` (built by
:mod:`kevlar_tpu_torch.native`): spectral error correction plus an
exact-overlap string graph with fermi-class cleaning (tip removal, weak-edge
pruning, open/simple bubble popping).  Unlike ``kevlar_tpu.assemble`` there
is no quiet fallback: a failed build raises.  ``greedy_asm`` is the
pure-Python overlap-merge assembler built on the same perfect-overlap pair
logic the reference uses for strict-mode edge validation (ReadPair merge,
readpair.py:156-170); nothing selects it in place of the native engine.

Contigs are re-annotated with interesting k-mers via ``augment`` exactly as
the reference does (assemble.py:14-20).
"""

import kevlar_tpu_torch
from kevlar_tpu_torch.readpair import ReadPair
from kevlar_tpu_torch.sequence import Record


def _annotate_from_dict(record, ikmers, ksize):
    """Annotate `record` with every known interesting k-mer it contains."""
    seq = record.sequence
    for offset in range(len(seq) - ksize + 1):
        kmer = seq[offset:offset + ksize]
        if kmer in ikmers:
            record.annotate(kmer, offset, ikmers[kmer])
    return record


def greedy_asm(records):
    """Greedy perfect-overlap assembly; yields contig sequences.

    Deterministic: k-mers and read names are processed in sorted order.
    """
    records = list(records)
    if not records:
        return
    # collect the global interesting-k-mer dictionary (both strands)
    ikmers = {}
    ksize = None
    for read in records:
        for ikmer in read.annotations:
            seq = read.ikmerseq(ikmer)
            ikmers[seq] = ikmer.abund
            ikmers[kevlar_tpu_torch.revcom(seq)] = ikmer.abund
            ksize = ikmer.ksize
    if ksize is None:
        return

    # deduplicate by canonical sequence (PCR duplicates)
    contigs = {}
    seen = set()
    for read in records:
        canon = kevlar_tpu_torch.revcommin(read.sequence)
        if canon in seen:
            continue
        seen.add(canon)
        rec = Record(name=read.name, sequence=read.sequence)
        _annotate_from_dict(rec, ikmers, ksize)
        contigs[rec.name] = rec

    merged_any = True
    while merged_any:
        merged_any = False
        # index: canonical k-mer -> contig names containing it
        kindex = {}
        for name, rec in contigs.items():
            for ikmer in rec.annotations:
                canon = kevlar_tpu_torch.revcommin(rec.ikmerseq(ikmer))
                kindex.setdefault(canon, set()).add(name)
        for kmer in sorted(kindex):
            names = sorted(kindex[kmer])
            if len(names) < 2:
                continue
            done = False
            for i in range(len(names)):
                for j in range(i + 1, len(names)):
                    r1, r2 = contigs[names[i]], contigs[names[j]]
                    pair = ReadPair(r1, r2, kmer)
                    if pair.incompatible:
                        continue
                    merged = Record(name=pair.tail.name,
                                    sequence=pair.mergedseq)
                    _annotate_from_dict(merged, ikmers, ksize)
                    del contigs[names[i]]
                    del contigs[names[j]]
                    contigs[merged.name] = merged
                    merged_any = True
                    done = True
                    break
                if done:
                    break
            if done:
                break

    out = sorted(contigs.values(), key=lambda r: (-len(r.sequence), r.name))
    for rec in out:
        if rec.annotations:
            yield rec.sequence


def fml_asm(records, min_overlap=33):
    """Assembler entry point (name kept for parity with the reference's
    fermi-lite bridge): the native C++ overlap assembler."""
    from kevlar_tpu_torch import native
    yield from native.assemble(records, min_overlap=min_overlap)


def assemble_fml_asm(partition, logstream=None):
    reads = list(partition)
    for n, contig in enumerate(fml_asm(reads), 1):
        name = 'contig{:d}'.format(n)
        record = Record(name=name, sequence=contig)
        from kevlar_tpu_torch import augment as augment_mod
        yield next(augment_mod.augment(reads, [record]))


def assemble(partstream, maxreads=10000, threads=1):
    """Assemble every partition; yields (partid, contig).

    With ``threads > 1`` partitions assemble concurrently (the native
    assembler releases the GIL inside kt_assemble), with results emitted in
    partition order so contig numbering is identical to a serial run.
    """
    n = 0
    pn = 0

    def worker(partition):
        return list(assemble_fml_asm(partition))

    if threads and threads > 1:
        from concurrent.futures import ThreadPoolExecutor
        parts = []
        for partid, partition in partstream:
            pn += 1
            if len(partition) > maxreads:
                kevlar_tpu_torch.plog('[kevlar::assemble] WARNING: skipping '
                                'partition with {:d} reads'.format(
                                    len(partition)))
                continue
            parts.append((partid, partition))
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results = pool.map(worker, [p for _, p in parts])
            for (partid, _), contigs in zip(parts, results):
                for contig in contigs:
                    n += 1
                    newname = 'contig{}'.format(n)
                    if partid is not None:
                        newname += ' kvcc={}'.format(partid)
                    contig.name = newname
                    yield partid, contig
    else:
        for partid, partition in partstream:
            pn += 1
            numreads = len(partition)
            if numreads > maxreads:
                kevlar_tpu_torch.plog('[kevlar::assemble] WARNING: skipping '
                                'partition with {:d} reads'.format(numreads))
                continue
            for contig in assemble_fml_asm(partition):
                n += 1
                newname = 'contig{}'.format(n)
                if partid is not None:
                    newname += ' kvcc={}'.format(partid)
                contig.name = newname
                yield partid, contig
    kevlar_tpu_torch.plog('[kevlar::assemble] processed {} partitions and '
                    'assembled {} contigs'.format(pn, n))


def main(args):
    from kevlar_tpu_torch import seqio
    readstream = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(args.augfastq, 'r'))
    if args.part_id:
        pstream = seqio.parse_single_partition(readstream, args.part_id)
    else:
        pstream = seqio.parse_partitioned_reads(readstream)
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    assembler = assemble(pstream, maxreads=args.max_reads)
    for partid, contig in assembler:
        kevlar_tpu_torch.print_augmented_fastx(contig, outstream)
