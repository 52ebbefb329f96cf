"""``partition`` stage: group reads into connected components.

Port of ``kevlar_tpu.partition``.  Reads sharing a novel k-mer belong to
the same candidate variant locus; components of the shared-k-mer graph
become partitions, emitted largest first with ``kvcc=N`` labels appended to
read names (contract: reference kevlar/partition.py:15-80). Strict mode
additionally requires a perfect overlap (ReadPair) before connecting two
reads; PCR duplicates are dropped per partition unless ``dedup`` is off.
Component extraction is :mod:`kevlar_tpu_torch.ops.cc_ops`: the host
union-find on small graphs, the components on ``device`` (K4 on a GPU) on
large ones.
"""

import kevlar_tpu_torch
from kevlar_tpu_torch.readgraph import ReadGraph, to_gml
from kevlar_tpu_torch.support import Timer


def _timed_phase(timer, name, text):
    timer.start(name)
    kevlar_tpu_torch.plog('[kevlar::partition]', text)


def _finish_phase(timer, name, text):
    kevlar_tpu_torch.plog('[kevlar::partition]',
                          text.format(timer.stop(name)))


def partition(readstream, strict=False, minabund=None, maxabund=None,
              dedup=True, gmlfile=None, device='cuda'):
    timer = Timer()
    timer.start()

    _timed_phase(timer, 'loadreads', 'Loading reads')
    graph = ReadGraph(device)
    graph.load(readstream, minabund=minabund, maxabund=maxabund)
    _finish_phase(timer, 'loadreads', 'Reads loaded in {:.2f} sec')

    _timed_phase(timer, 'buildgraph',
                 'Building read graph in {:s} mode'.format(
                     'strict' if strict else 'relaxed'))
    graph.populate_edges(strict=strict)
    _finish_phase(timer, 'buildgraph', 'Graph built in {:.2f} sec')

    if gmlfile:
        to_gml(graph, gmlfile)

    _timed_phase(timer, 'partition', 'Partition readgraph')
    label = 0
    for label, component in enumerate(
            graph.partitions(dedup, minabund, maxabund, abundfilt=True), 1):
        tag = ' kvcc={:d}'.format(label)
        members = []
        for readname in component:
            record = graph.get_record(readname)
            record.name += tag
            members.append(record)
        yield label, members
    _finish_phase(timer, 'partition', 'Partitioning done in {:.2f} sec')
    kevlar_tpu_torch.plog('[kevlar::partition] Total time: '
                          '{:.2f} seconds'.format(timer.stop()))


def _write_partition(reads, outstream):
    for read in reads:
        kevlar_tpu_torch.print_augmented_fastx(read, outstream)


def main(args):
    if args.split:
        kevlar_tpu_torch.mkdirp(args.split, trim=True)
    combined_out = None if args.split else \
        kevlar_tpu_torch.open(args.out, 'w')
    readstream = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(args.infile, 'r'))
    nreads = nparts = 0
    try:
        for label, reads in partition(readstream, strict=args.strict,
                                      minabund=args.min_abund,
                                      maxabund=args.max_abund,
                                      dedup=args.dedup, gmlfile=args.gml,
                                      device=args.device):
            nparts = label
            nreads += len(reads)
            if args.split:
                shardfile = '{:s}.cc{:d}.augfastq.gz'.format(args.split,
                                                             label)
                with kevlar_tpu_torch.open(shardfile, 'w') as fh:
                    _write_partition(reads, fh)
            else:
                _write_partition(reads, combined_out)
    finally:
        if combined_out is not None and args.out not in (None, '-'):
            combined_out.close()
    kevlar_tpu_torch.plog(
        '[kevlar::partition]',
        'grouped {:d} reads into {:d} connected components'.format(
            nreads, nparts))
