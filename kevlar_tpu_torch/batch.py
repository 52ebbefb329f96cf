"""Columnar read batches: the bridge between host Records and device tensors.

A copy of ``kevlar_tpu.batch``.  Reads are marshalled into padded
``uint8 [B, L]`` base-code arrays (padding code 4 so padded windows are
invalid and never counted), with lengths bucketed to a small set of padded
widths, and shipped to the device as they are, one byte a base, through a
:class:`CodeStager` (``kevlar_tpu``'s unpacked-wire route; its 2-bit wire
format, :func:`pack_bases`, served a slow link and is kept for the tests
that hold the two packages' formats together).  The bucketing also fixes
the order in which :func:`batches_from_records` emits reads of mixed
lengths, which the novel stage's output follows, so it is kept as it is.
"""

import queue
import threading

import numpy as np
import torch

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


def sequence_blocks(filename, nreads=65536):
    """The sequences of a FASTA/FASTQ file (plain or gzipped) as lists of
    about ``nreads`` strings, in file order: those of the records
    :func:`kevlar_tpu_torch.seqio.parse_fastx` yields, without a Record per
    read.  FASTQ is read a block of lines at a time (blank lines dropped,
    the second of every four lines kept); FASTA goes through the record
    parser."""
    import itertools
    import kevlar_tpu_torch
    from kevlar_tpu_torch import seqio
    with kevlar_tpu_torch.open(filename, 'r') as fh:
        head = next((line for line in fh if line.strip()), None)
        if head is None:
            return
        if head[0] != '@':
            records = seqio.parse_fastx(itertools.chain([head], fh))
            while True:
                block = [r.sequence for r in itertools.islice(records,
                                                              nreads)]
                if not block:
                    return
                yield block
        carry = [head]
        while True:
            lines = fh.readlines(nreads * 512)
            if not lines:
                break
            lines = carry + [line for line in lines if line.strip()]
            whole = len(lines) - len(lines) % 4
            carry = lines[whole:]
            if whole:
                yield [seq.strip() for seq in lines[1:whole:4]]
        if carry:
            raise ValueError('{}: the last FASTQ record is cut short'
                             .format(filename))


def _bucket_lengths(lengths):
    """:func:`bucket_length` of every entry of an int array."""
    table = np.asarray(LENGTH_BUCKETS)
    idx = np.searchsorted(table, lengths, side='left')
    out = table[np.minimum(idx, len(table) - 1)]
    for i in np.flatnonzero(idx >= len(table)).tolist():
        out[i] = bucket_length(int(lengths[i]))
    return out


def _encode_rows(seqs, pad, rows):
    """``ReadBatch(...).bases`` of ``seqs``: a ``[max(rows, len(seqs)),
    pad]`` code array, 4 where there is no base."""
    out = np.full((max(rows, len(seqs)), pad), 4, dtype=np.uint8)
    raw = ''.join([s.ljust(pad, 'N') for s in seqs]).encode('ascii')
    out[:len(seqs)] = dna.BASE_TO_CODE[
        np.frombuffer(raw, dtype=np.uint8)].reshape(len(seqs), pad)
    return out


def base_batches_from_files(filenames, batch_size=DEFAULT_BATCH_SIZE):
    """The ``bases`` arrays of ``batches_from_records(seqio.multi_file_iter(
    filenames), batch_size)``: the same rows in the same batches in the
    same order (a bucket's batch when its last read arrives, the partial
    batches at the end, shortest bucket first), built a block of reads at a
    time instead of a Record at a time."""
    pending = {}
    for filename in filenames:
        for block in sequence_blocks(filename):
            lengths = np.fromiter(map(len, block), dtype=np.int64,
                                  count=len(block))
            buckets = _bucket_lengths(lengths)
            full = []       # (block position of the read that fills it, b)
            for b in np.unique(buckets).tolist():
                where = np.flatnonzero(buckets == b)
                have = pending.setdefault(b, [])
                first = batch_size - len(have) - 1
                have.extend(block if len(where) == len(block)
                            else [block[i] for i in where.tolist()])
                full += [(int(where[at]), b)
                         for at in range(first, len(where), batch_size)]
            for _, b in sorted(full):
                yield _encode_rows(pending[b][:batch_size], b, batch_size)
                pending[b] = pending[b][batch_size:]
    for b in sorted(pending):
        if pending[b]:
            yield _encode_rows(pending[b], b, batch_size)


class CodeStager:
    """Ships ``uint8`` base-code batches to a device.

    :meth:`buffer` hands out a host array to fill and :meth:`ship` copies
    it to the device.  For a CUDA device the arrays are a ring of pinned
    buffers and the copies do not block the host: a buffer is handed out
    again only once the copy out of it has completed (its event), so the
    host fills one batch while the copy of the one before is in flight.
    For the CPU every batch gets a fresh array, which the tensor shares.
    One thread uses a stager at a time.  ``waits`` counts the times the
    host waited for a buffer's copy.
    """

    DEPTH = 2       # pinned buffers: one being filled, one being copied

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned = self.device.type == 'cuda'
        self._ring = [[None, None] for _ in range(self.DEPTH)]
        self._next = 0
        self._current = None
        self.waits = 0

    def buffer(self, shape):
        """A ``uint8`` array of ``shape`` to fill with the next batch."""
        if not self._pinned:
            self._current = torch.empty(shape, dtype=torch.uint8)
            return self._current.numpy()
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        tensor, event = slot
        if event is not None:
            event.synchronize()
            self.waits += 1
        if tensor is None or tuple(tensor.shape) != tuple(shape):
            tensor = slot[0] = torch.empty(shape, dtype=torch.uint8,
                                           pin_memory=True)
        self._current = slot
        return tensor.numpy()

    def ship(self):
        """The device tensor of the array :meth:`buffer` returned last."""
        if not self._pinned:
            return self._current
        slot = self._current
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(self.device))
        return out


def native_base_batches(path, batch_size=DEFAULT_BATCH_SIZE, max_len=1024,
                        overlap=0, alloc=None):
    """Stream ``(bases [batch_size, bucket] uint8, lengths)`` batches through
    the C++ reader (no per-read Python objects).  The column bucket adapts
    to the longest read seen so far (never shrinks).  Records longer than
    ``max_len`` chunk into rows sharing ``overlap`` characters (pass
    ksize-1 so genome-scale FASTA records lose no k-mers).  ``alloc(shape)``
    gives the array each batch is written into (a fresh one by default; a
    :meth:`CodeStager.buffer` to fill pinned memory directly).  The reader
    is compiled at first use; a failed build raises."""
    from kevlar_tpu_torch import native
    reader = native.FastxBatchReader(path, max_reads=batch_size,
                                     max_len=max_len, overlap=overlap,
                                     want_names=False, reuse=True)
    bucket = 0
    for out in reader:
        bases, lengths = out[0], out[1]
        maxlen = int(lengths.max()) if len(lengths) else 0
        bucket = max(bucket, bucket_length(maxlen))
        shape = (batch_size, bucket)
        dest = alloc(shape) if alloc else np.empty(shape, np.uint8)
        n = bases.shape[0]
        dest[:n] = bases[:, :bucket]
        dest[n:] = 4
        yield dest, lengths


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
