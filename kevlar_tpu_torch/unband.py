"""``unband`` stage: merge per-band novel outputs into one read stream.

When the screen ran as N hash-band passes, the same read can appear in
several outputs with disjoint annotation sets. This stage unions those
annotation lists per read name (contract: kevlar/unband.py:26-77). To bound
memory it spills records into name-hashed temp buckets and merges one
bucket at a time, emitting each bucket's reads in sorted-name order with
annotations sorted by offset.

A copy of ``kevlar_tpu.unband``: host code only.  While spans are recorded
(:mod:`kevlar_tpu_torch.support`), a call is ``unband::pass``, recorded
when its stream ends with the differences of :data:`counters` over it;
inside it each chunk of records written to the buckets (and the buckets'
close) is ``unband::spill``, and each bucket read back, parsed, grouped
and sorted is ``unband::merge``.  Neither holds the time the record
stream takes to give its records, nor the time the caller holds between
yields.
"""

import itertools
import os
from tempfile import TemporaryDirectory

import kevlar_tpu_torch
from kevlar_tpu_torch import seqio, support
from kevlar_tpu_torch.support import span

# Always-on counts of the merge, in host ints (read as differences):
# records read in, records written out, and the compressed bytes the
# buckets took on disk.
counters = {'records_in': 0, 'records_out': 0, 'spilled_bytes': 0}

# records drawn from the stream before they are written, one spill span
# a chunk
SPILL_CHUNK = 4096


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

    def merged_buckets(self, parent=None):
        """Close sinks, then yield each bucket's merged records as a
        list (``parent``: the :func:`support.mark` of the spans)."""
        with span('unband::spill', parent=parent):
            for sink in self._sinks:
                sink.close()
        counters['spilled_bytes'] += sum(map(os.path.getsize, self._paths))
        for path in self._paths:
            with span('unband::merge', parent=parent):
                with kevlar_tpu_torch.open(path, 'r') as fh:
                    merged = list(self._merge_one(
                        kevlar_tpu_torch.parse_augmented_fastx(fh)))
            yield merged

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
    pass_ = support.mark('unband::pass')
    before = dict(counters)
    recordstream = iter(recordstream)
    with TemporaryDirectory() as tempdir:
        buckets = _NameBuckets(numbatches, tempdir)
        kevlar_tpu_torch.plog(
            '[kevlar::unband] writing records to '
            '{:d} temp batch files'.format(numbatches))
        while True:
            chunk = list(itertools.islice(recordstream, SPILL_CHUNK))
            if not chunk:
                break
            with span('unband::spill', parent=pass_):
                for record in chunk:
                    buckets.add(record)
            counters['records_in'] += len(chunk)
        kevlar_tpu_torch.plog(
            '[kevlar::unband] resolving duplicate reads in '
            '{:d} batches'.format(numbatches))
        for n, bucket in enumerate(buckets.merged_buckets(pass_)):
            counters['records_out'] += len(bucket)
            yield from bucket
            kevlar_tpu_torch.plog(
                '[kevlar::unband]     batch {:d} complete'.format(n))
        kevlar_tpu_torch.plog('[kevlar::unband] Done!')
    support.record(pass_, {k: counters[k] - before[k] for k in counters})


def main(args):
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    for read in unband(seqio.afxstream(args.infile), args.n_batches):
        kevlar_tpu_torch.print_augmented_fastx(read, outstream)
