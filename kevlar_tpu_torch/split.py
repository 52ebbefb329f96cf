"""``split`` stage: deal partitions round-robin into N shard files.

Scatter step of the reference's scatter/gather partition parallelism
(contract: kevlar/split.py:14-29 — round-robin by partition, oversized
partitions dropped with a warning but still consuming their slot).
"""

import kevlar_tpu_torch
from kevlar_tpu_torch import seqio
from kevlar_tpu_torch.sequence import print_augmented_fastx

OVERSIZE_LIMIT = 10000


def split(pstream, outstreams, maxreads=OVERSIZE_LIMIT):
    fanout = len(outstreams)
    for slot, (partid, reads) in enumerate(pstream):
        if len(reads) > maxreads:
            kevlar_tpu_torch.plog(
                '[kevlar::split]',
                'WARNING: discarding partition with {} reads'.format(
                    len(reads)))
            continue
        sink = outstreams[slot % fanout]
        for read in reads:
            print_augmented_fastx(read, sink)


def _shard_path(base, index, gzipped):
    path = '{}.{}.augfastx'.format(base, index)
    return path + '.gz' if gzipped else path


def main(args):
    instream = kevlar_tpu_torch.open(args.infile, 'r')
    reads = kevlar_tpu_torch.parse_augmented_fastx(instream)
    gz = str(args.infile).endswith('.gz')
    sinks = [
        kevlar_tpu_torch.open(_shard_path(args.base, i, gz), 'w')
        for i in range(args.numfiles)
    ]
    try:
        split(seqio.parse_partitioned_reads(reads), sinks)
    finally:
        for sink in sinks:
            sink.close()
