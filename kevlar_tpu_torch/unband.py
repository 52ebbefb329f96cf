"""``unband`` stage: merge per-band novel outputs into one read stream.

When the screen ran as N hash-band passes, the same read can appear in
several outputs with disjoint annotation sets. This stage unions those
annotation lists per read name (contract: kevlar/unband.py:26-77). To bound
memory it spills records into name-hashed temp buckets and merges one
bucket at a time, emitting each bucket's reads in sorted-name order with
annotations sorted by offset.

A copy of ``kevlar_tpu.unband``: host code only.
"""

from tempfile import TemporaryDirectory

import kevlar_tpu_torch
from kevlar_tpu_torch import seqio


class _NameBuckets:
    """Spill-to-disk grouping of augmented records by read-name hash."""

    def __init__(self, nbuckets, tempdir):
        self._paths = [
            '{}/unband-bucket{}.augfastq.gz'.format(tempdir, i)
            for i in range(nbuckets)
        ]
        self._sinks = [kevlar_tpu_torch.open(p, 'w') for p in self._paths]

    def add(self, record):
        sink = self._sinks[hash(record.name) % len(self._sinks)]
        kevlar_tpu_torch.print_augmented_fastx(record, sink)

    def merged_buckets(self):
        """Close sinks, then yield per-bucket streams of merged records."""
        for sink in self._sinks:
            sink.close()
        for path in self._paths:
            with kevlar_tpu_torch.open(path, 'r') as fh:
                yield self._merge_one(kevlar_tpu_torch.parse_augmented_fastx(fh))

    @staticmethod
    def _merge_one(records):
        byname = {}
        for record in records:
            prior = byname.setdefault(record.name, record)
            if prior is not record:
                prior.annotations.extend(record.annotations)
        for name in sorted(byname):
            merged = byname[name]
            merged.annotations.sort(key=lambda ik: ik.offset)
            yield merged


def unband(recordstream, numbatches=16):
    with TemporaryDirectory() as tempdir:
        buckets = _NameBuckets(numbatches, tempdir)
        kevlar_tpu_torch.plog(
            '[kevlar::unband] writing records to '
            '{:d} temp batch files'.format(numbatches))
        for record in recordstream:
            buckets.add(record)
        kevlar_tpu_torch.plog(
            '[kevlar::unband] resolving duplicate reads in '
            '{:d} batches'.format(numbatches))
        for n, bucket in enumerate(buckets.merged_buckets()):
            yield from bucket
            kevlar_tpu_torch.plog(
                '[kevlar::unband]     batch {:d} complete'.format(n))
        kevlar_tpu_torch.plog('[kevlar::unband] Done!')


def main(args):
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    for read in unband(seqio.afxstream(args.infile), args.n_batches):
        kevlar_tpu_torch.print_augmented_fastx(read, outstream)
