"""Columnar read batches: the bridge between host Records and device tensors.

A copy of ``kevlar_tpu.batch``.  Reads are marshalled into padded
``uint8 [B, L]`` base-code arrays (padding code 4 so padded windows are
invalid and never counted), with lengths bucketed to a small set of padded
widths, and shipped to the device in the 2-bit wire format of
:func:`pack_bases`.  The bucketing also fixes the order in which
:func:`batches_from_records` emits reads of mixed lengths, which the novel
stage's output follows, so it is kept as it is.
"""

import queue
import threading

import numpy as np

from kevlar_tpu_torch import dna


# Reads per batch (kevlar_tpu's default).
DEFAULT_BATCH_SIZE = 4096
# pad lengths to these buckets (ceil); last bucket grows by doubling
LENGTH_BUCKETS = (128, 160, 256, 512, 1024)


def bucket_length(length):
    for b in LENGTH_BUCKETS:
        if length <= b:
            return b
    b = LENGTH_BUCKETS[-1]
    while b < length:
        b *= 2
    return b


class ReadBatch:
    """A batch of reads as padded arrays, with the originating records.

    With ``pad_rows``, the row (batch) dimension is padded with invalid
    reads up to that size — the padding contributes no valid k-mer
    windows.
    """

    __slots__ = ('records', 'bases', 'lengths')

    def __init__(self, records, pad_to=None, pad_rows=None):
        self.records = records
        seqs = [r.sequence for r in records]
        maxlen = max((len(s) for s in seqs), default=0)
        pad = pad_to if pad_to is not None else bucket_length(maxlen)
        self.bases, self.lengths = dna.encode_batch(seqs, pad_to=pad)
        if pad_rows is not None and len(records) < pad_rows:
            extra = pad_rows - len(records)
            self.bases = np.concatenate(
                [self.bases, np.full((extra, pad), 4, dtype=np.uint8)])
            self.lengths = np.concatenate(
                [self.lengths, np.zeros(extra, dtype=np.int32)])

    def __len__(self):
        return len(self.records)


def chunk_long_records(recordstream, limit=1024, overlap=0):
    """Split records longer than ``limit`` into windows sharing ``overlap``
    characters (overlap = ksize-1 keeps every k-mer in exactly one window);
    short records pass through untouched."""
    from kevlar_tpu_torch.sequence import Record
    step = max(1, limit - overlap)
    for record in recordstream:
        seq = record.sequence
        if len(seq) <= limit:
            yield record
            continue
        for lo in range(0, len(seq) - overlap, step):
            yield Record(name=record.name, sequence=seq[lo:lo + limit])


def batches_from_records(recordstream, batch_size=DEFAULT_BATCH_SIZE):
    """Group a record stream into ReadBatches (per length bucket).

    A bucket's batch is emitted when it fills; the partial batches follow
    at the end, shortest bucket first.  Reads shorter than k are passed
    through in the batch but produce no valid k-mer windows.
    """
    pending = {}
    for record in recordstream:
        b = bucket_length(len(record.sequence))
        pending.setdefault(b, []).append(record)
        if len(pending[b]) >= batch_size:
            yield ReadBatch(pending.pop(b), pad_to=b, pad_rows=batch_size)
    for b in sorted(pending):
        if pending[b]:
            yield ReadBatch(pending[b], pad_to=b, pad_rows=batch_size)


def native_base_batches(path, batch_size=DEFAULT_BATCH_SIZE, max_len=1024,
                        overlap=0):
    """Stream ``(bases [batch_size, bucket] uint8, lengths)`` batches through
    the C++ reader (no per-read Python objects).  The column bucket adapts
    to the longest read seen so far (never shrinks).  Records longer than
    ``max_len`` chunk into rows sharing ``overlap`` characters (pass
    ksize-1 so genome-scale FASTA records lose no k-mers).  The reader is
    compiled at first use; a failed build raises."""
    from kevlar_tpu_torch import native
    reader = native.FastxBatchReader(path, max_reads=batch_size,
                                     max_len=max_len, overlap=overlap)
    bucket = 0
    for out in reader:
        bases, lengths = out[0], out[1]
        maxlen = int(lengths.max()) if len(lengths) else 0
        bucket = max(bucket, bucket_length(maxlen))
        view = bases[:, :bucket]
        if view.shape[0] < batch_size:
            view = pad_batch_rows(view, batch_size)
        yield np.ascontiguousarray(view), lengths


def pack_bases(bases):
    """Pack base codes into the 2-bit wire format.

    Returns (packed [..., ceil(L/4)] uint8, badmask [..., ceil(L/8)] uint8):
    base i sits in bits ``2*(i%4)`` of packed byte ``i//4`` (LSB-first, 3
    for an invalid base), and an invalid base sets bit ``7-(i%8)`` of
    badmask byte ``i//8`` (``np.packbits``, big-endian) — see
    :func:`kevlar_tpu_torch.ops.hashing.unpack_bases`.
    """
    bases = np.asarray(bases, dtype=np.uint8)
    L = bases.shape[-1]
    Lp = -(-L // 4) * 4
    b = np.minimum(bases, 3).astype(np.uint8)
    if Lp != L:
        pad = np.zeros(bases.shape[:-1] + (Lp - L,), np.uint8)
        b = np.concatenate([b, pad], axis=-1)
    b = b.reshape(bases.shape[:-1] + (Lp // 4, 4))
    shifts = np.uint8([0, 2, 4, 6])
    packed = np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint8)
    bad = (bases >= 4)
    badmask = np.packbits(bad, axis=-1)
    return packed, badmask


def pad_batch_rows(bases, batch_size):
    """Pad the batch (row) dimension up to `batch_size` with invalid bases."""
    B, L = bases.shape
    if B == batch_size:
        return bases
    out = np.full((batch_size, L), 4, dtype=np.uint8)
    out[:B] = bases
    return out


def prefetch_iter(iterable, depth=4):
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Hides host-side parse/marshal latency behind downstream (device) work.
    Exceptions from the producer re-raise at the consumption point; the
    thread is a daemon, so an abandoned iterator never blocks interpreter
    exit.
    """
    q = queue.Queue(maxsize=depth)
    _END = object()

    def produce():
        try:
            for item in iterable:
                q.put(item)
            q.put(_END)
        except BaseException as exc:
            q.put(exc)

    threading.Thread(target=produce, daemon=True).start()

    def consume():
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    return consume()
