"""Count-Min sketch: the port of ``kevlar_tpu.sketch``.

A :class:`Sketch` with ``backend='device'`` keeps its counters in a
``uint8 [ntables, width]`` tensor on an explicit device, bit-packed in the
persistent layout of :mod:`kevlar_tpu_torch.ops.sketch_ops`, with a lazily
built numpy mirror (unpacked counter values) for host point lookups; bulk
counting happens in :func:`kevlar_tpu_torch.count.consume_seqfile`.  With
``backend='host'`` it keeps numpy counters and no tensor: ``kevlar_tpu``'s
own choice for small control-plane sketches (the filter's recount,
simlike's point queries), not a stand-in for a device sketch.

Files are the ``kevlar_tpu`` npz format: members ``tables`` ([ntables,
tablesize] uint8, unpacked), ``ksize``, ``tablesize``, ``ntables``,
``counter_bits`` and ``n_occupied``; the khmer-style extension (.nt, .sct,
.ct, ...) names the counter width.  Either package loads the other's files.
"""

import contextlib
import io
import os
import zipfile

import numpy as np
import torch

from kevlar_tpu_torch import dna
from kevlar_tpu_torch.ops import hashing, sketch_ops
from kevlar_tpu_torch.reference import _load_npz_mmap
from kevlar_tpu_torch.support import span


class KevlarSketchTypeError(ValueError):
    pass


class KevlarUnsuitableFPRError(SystemExit):
    pass


# counter width (bits) by khmer-compatible filename extension
COUNTER_BITS_BY_EXTENSION = {
    '.nt': 1, '.nodetable': 1,
    '.ng': 1, '.nodegraph': 1,
    '.ct': 8, '.counttable': 8,
    '.cg': 8, '.countgraph': 8,
    '.sct': 4, '.smallcounttable': 4,
    '.scg': 4, '.smallcountgraph': 4,
}

GRAPH_EXTENSIONS = ('.ng', '.nodegraph', '.cg', '.countgraph',
                    '.scg', '.smallcountgraph')

# buckets of counter storage per byte of memory budget (khmer parity:
# tablesize = memory/4 * buckets_per_byte)
BUCKETS_PER_BYTE = {1: 8, 4: 2, 8: 1}
MAXCOUNT = sketch_ops.MAXCOUNT


def get_extension(count=False, graph=False, smallcount=False):
    """(short, long) filename extensions of a sketch type."""
    if count:
        if graph:
            return ('.scg', '.smallcountgraph') if smallcount \
                else ('.cg', '.countgraph')
        return ('.sct', '.smallcounttable') if smallcount \
            else ('.ct', '.counttable')
    return ('.ng', '.nodegraph') if graph else ('.nt', '.nodetable')


class Sketch:
    """Count-Min sketch with canonical k-mer hashing.

    ``backend='device'`` keeps the counters on ``device``; ``backend='host'``
    keeps them in numpy (``device`` is then unused).  ``tables``, when
    given, are unpacked counter values ([ntables, tablesize] uint8, numpy
    or tensor), as in ``kevlar_tpu``.
    """

    def __init__(self, ksize, tablesize, ntables=4, counter_bits=8,
                 tables=None, device='cuda', backend='device'):
        tablesize = int(tablesize)
        if tablesize < 1:
            raise ValueError('tablesize must be positive')
        self._ksize = int(ksize)
        self.tablesize = tablesize
        self.ntables = int(ntables)
        self.counter_bits = int(counter_bits)
        self.maxcount = MAXCOUNT[self.counter_bits]
        self.backend = backend
        self._n_occupied = None
        self._host_tables = None
        self._acc = None
        if backend == 'host':
            self.device = None
            if tables is None:
                self.tables = np.zeros((self.ntables, tablesize),
                                       dtype=np.uint8)
            else:
                self.tables = np.asarray(tables, dtype=np.uint8)
            self._host_tables = self.tables
            return
        if backend != 'device':
            raise ValueError('backend must be "device" or "host", got '
                             '{!r}'.format(backend))
        self.device = torch.device(device)
        if tables is None:
            width = sketch_ops.packed_width(tablesize, self.counter_bits)
            self.tables = torch.zeros((self.ntables, width),
                                      dtype=torch.uint8, device=self.device)
        else:
            values = torch.as_tensor(np.asarray(tables, dtype=np.uint8))
            if tuple(values.shape) != (self.ntables, tablesize):
                raise ValueError('tables of shape {} for {} x {}'.format(
                    tuple(values.shape), self.ntables, tablesize))
            self.tables = sketch_ops.pack_rows(values.to(self.device),
                                               self.counter_bits)

    # -- the accumulator of a batch consume ------------------------------
    @contextlib.contextmanager
    def consuming(self):
        """Hold a device sketch's int32 :class:`~kevlar_tpu_torch.ops.
        sketch_ops.Accumulator` open over a loop of batch consumes::

            with sketch.consuming():
                for bases in batches:
                    sketch.consume_batch(bases)

        The block's entry unpacks the tables into it and its exit saturates
        and packs them back, once for all its batches (the spans
        ``count::open`` and ``count::close``, timed on the device too);
        inside, ``tables`` is None and the sketch cannot be read.  A batch
        consume outside a block is a block of its own.  Blocks nest: the
        outermost closes."""
        if self.backend != 'device':
            raise ValueError('a host-backend sketch has no accumulator')
        if self._acc is not None:
            yield self._acc
            return
        with span('count::open', device=self.device):
            self._acc = sketch_ops.Accumulator(
                self.tables, self.counter_bits, self.tablesize)
        self.tables = None
        self._invalidate()
        try:
            yield self._acc
        finally:
            with span('count::close', device=self.device):
                tables = self._acc.tables()
            self.tables, self._acc = tables, None

    # -- khmer-parity introspection ------------------------------------
    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return [self.tablesize] * self.ntables

    def n_occupied(self):
        """Occupied buckets in table 0: from the file's metadata for a
        loaded sketch, else one reduction on the device (or over the host
        counters)."""
        if self._n_occupied is None:
            if self.backend == 'host':
                self._n_occupied = int(np.count_nonzero(self.tables[0]))
            else:
                self._n_occupied = sketch_ops.occupancy(
                    self.tables, self.counter_bits, self.tablesize)
        return self._n_occupied

    def n_unique_kmers(self):
        """Estimated distinct k-mers via Bloom occupancy inversion."""
        occ = self.n_occupied()
        if occ >= self.tablesize:
            return self.tablesize
        frac = occ / self.tablesize
        return int(round(-self.tablesize * np.log1p(-frac)))

    def table_spec(self):
        """``(tables, counter_bits, tablesize)``: what the device ops take of
        a sketch (a consume's mask, a screen's sample)."""
        if self.backend != 'device':
            raise ValueError('a host-backend sketch has no device tables')
        if self._acc is not None:
            raise ValueError('the sketch is inside a consuming() block: its '
                             'tables are packed when the block ends')
        return self.tables, self.counter_bits, self.tablesize

    # -- host mirror (always unpacked counter values) ---------------------
    def _host(self):
        if self._host_tables is None:
            self._host_tables = sketch_ops.unpack_rows(
                self.tables, self.counter_bits, self.tablesize).cpu().numpy()
        return self._host_tables

    def _invalidate(self):
        if self.backend != 'host':
            self._host_tables = None
        self._n_occupied = None

    # -- host-backend counting -------------------------------------------
    def _host_consume_hashes(self, h1, h2, valid=None):
        h1 = np.asarray(h1, dtype=np.uint32)
        h2 = np.asarray(h2, dtype=np.uint32)
        if valid is not None:
            keep = np.asarray(valid, dtype=bool).ravel()
            h1 = h1.ravel()[keep]
            h2 = h2.ravel()[keep]
        else:
            h1 = h1.ravel()
            h2 = h2.ravel()
        for t in range(self.ntables):
            idx = ((h1 + np.uint32(t) * h2) % np.uint32(self.tablesize))
            # touch only the hit buckets, not the whole table
            uniq, cnt = np.unique(idx.astype(np.int64), return_counts=True)
            cur = self.tables[t][uniq].astype(np.int64)
            self.tables[t][uniq] = np.minimum(
                cur + cnt, self.maxcount).astype(np.uint8)
        self._host_tables = self.tables
        self._n_occupied = None
        return len(h1)

    # -- hashing helpers ------------------------------------------------
    def hash(self, kmer):
        """64-bit canonical hash of a k-mer string (h1<<32 | h2)."""
        h1, h2 = dna.hash_kmer(kmer)
        return (h1 << 32) | h2

    def reverse_hash(self, value):
        """Table hashes are one-way (khmer raises the same error for its
        table types; only graph types hash reversibly)."""
        raise ValueError('reverse hashing not implemented for table-hashed '
                         'sketches')

    def get_kmers(self, seq):
        k = self._ksize
        return [seq[i:i + k] for i in range(len(seq) - k + 1)]

    # -- point/host queries ----------------------------------------------
    def _host_counts(self, h1, h2, valid=None):
        tables = self._host()
        counts = None
        for t in range(self.ntables):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(self.tablesize)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        if valid is not None:
            counts = np.where(valid, counts, 0)
        return counts

    def get(self, kmer):
        """Count of a single k-mer (canonical)."""
        h1, h2 = dna.hash_kmer(kmer)
        return int(self._host_counts(np.uint32([h1]), np.uint32([h2]))[0])

    def get_kmer_counts(self, seq):
        """Counts for every k-mer of `seq` (invalid windows -> 0)."""
        h1, h2, valid = dna.kmer_hashes(dna.encode(seq), self._ksize)
        return [int(c) for c in self._host_counts(h1, h2, valid)]

    def get_kmer_hashes(self, seq):
        """64-bit canonical hashes for the valid k-mers of `seq`
        (khmer-contract API; hash values use this package's scheme, with
        the same canonicality invariant)."""
        h1, h2, valid = dna.kmer_hashes(dna.encode(seq), self._ksize)
        keys = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
        return [int(key) for key, v in zip(keys, valid) if v]

    def abundance_distribution(self, records, tracking):
        """Histogram of distinct-k-mer abundances, khmer-style.

        ``records`` is an iterable of Records (or a filename); ``tracking``
        is a presence sketch (counter_bits=1, host backend) used to count
        each distinct k-mer exactly once across calls.  Returns a
        length-256 array where entry ``c`` is the number of distinct
        k-mers with count ``c``.  Host point queries, as in ``kevlar_tpu``;
        the ``dist`` stage has its own pass on the device.
        """
        from kevlar_tpu_torch import seqio
        from kevlar_tpu_torch.batch import batches_from_records
        if isinstance(records, str):
            records = seqio.multi_file_iter([records])
        hist = np.zeros(256, dtype=np.int64)
        for batch in batches_from_records(records):
            h1, h2, valid = dna.kmer_hashes(batch.bases, self._ksize)
            h1, h2, valid = h1.ravel(), h2.ravel(), valid.ravel()
            fresh = valid & (tracking._host_counts(h1, h2, valid) == 0)
            if not fresh.any():
                continue
            keys = (h1.astype(np.uint64) << np.uint64(32)) | \
                h2.astype(np.uint64)
            _, first = np.unique(keys[fresh], return_index=True)
            idx = np.flatnonzero(fresh)[first]
            counts = self._host_counts(h1[idx], h2[idx])
            np.add.at(hist, np.clip(counts, 0, 255).astype(np.int64), 1)
            tracking._host_consume_hashes(h1[idx], h2[idx])
        return hist

    # -- mutation ---------------------------------------------------------
    def add(self, kmer):
        self.consume(kmer)

    def count(self, kmer):
        self.consume(kmer)

    def consume(self, seq):
        """Count every k-mer in a sequence string; returns the number of
        k-mers consumed.  The sequence is padded to a bucketed length, as a
        read batch is."""
        if len(seq) < self._ksize:
            return 0
        from kevlar_tpu_torch.batch import bucket_length
        pad = bucket_length(len(seq))
        bases = np.full((1, pad), 4, dtype=np.uint8)
        bases[0, :len(seq)] = dna.encode(seq)
        return int(self.consume_batch(bases))

    def _codes(self, bases):
        """``bases`` (numpy or tensor, uint8 base codes, 4 = not ACGT) as a
        contiguous tensor on the sketch's device."""
        if not torch.is_tensor(bases):
            bases = torch.from_numpy(np.ascontiguousarray(bases, np.uint8))
        return bases.to(self.device).contiguous()

    def _mask_spec(self, mask):
        """``(tables, counter_bits, tablesize)`` of a consume's mask on
        this sketch's device (a host-backend mask is packed and shipped)."""
        if mask is None:
            return None
        if not isinstance(mask, Sketch):
            raise ValueError('the mask of a device consume must be a sketch '
                             'of this package\'s format, not khmer\'s: '
                             'their hash spaces differ')
        if mask.backend == 'host':
            packed = sketch_ops.pack_rows(
                torch.from_numpy(mask.tables).to(self.device),
                mask.counter_bits)
            return packed, mask.counter_bits, mask.tablesize
        if mask.device != self.device:
            raise ValueError('mask is on {}, sketch on {}'.format(
                mask.device, self.device))
        return mask.table_spec()

    def consume_batch(self, bases, numbands=None, band=None, mask=None,
                      mask_threshold=0, consume_masked=False):
        """Count all k-mers of a padded ``[B, L]`` base-code batch.

        A device sketch hashes the batch (K1), gets the mask's counts (K2)
        and scatters into its accumulator (K3's consume, which also counts
        what it kept) on its device: the kernels on a GPU, their plain
        versions on the CPU.  A loop of calls goes inside a
        :meth:`consuming` block.  Returns the number of k-mers consumed: a
        0-d tensor on the device (no host sync per batch), an int on the
        host backend.
        """
        if self.backend == 'host':
            h1, h2, valid = dna.kmer_hashes(np.asarray(bases), self._ksize)
            if numbands:
                valid = valid & ((h1 & np.uint32(numbands - 1))
                                 == np.uint32(band))
            if mask is not None:
                mcnt = mask._host_counts(h1, h2)
                if consume_masked:
                    valid = valid & (mcnt >= mask_threshold)
                else:
                    valid = valid & (mcnt <= mask_threshold)
            return self._host_consume_hashes(h1, h2, valid)
        maskspec = self._mask_spec(mask)
        with self.consuming() as acc:
            return sketch_ops.consume_batch(
                acc, self._codes(bases), self._ksize, numbands=numbands,
                band=band, mask=maskspec, mask_threshold=mask_threshold,
                consume_masked=consume_masked)

    def consume_batch_stack(self, bases_stack, numbands=None, band=None,
                            mask=None, mask_threshold=0,
                            consume_masked=False):
        """Count a ``[NB, B, L]`` stack of batches (the span
        ``count::consume``, timed on the device too)."""
        if self.backend == 'host':
            for bases in bases_stack:
                self.consume_batch(bases, numbands=numbands, band=band,
                                   mask=mask, mask_threshold=mask_threshold,
                                   consume_masked=consume_masked)
            return
        maskspec = self._mask_spec(mask)
        with self.consuming() as acc, \
                span('count::consume', device=self.device):
            sketch_ops.consume_batch_stack(
                acc, self._codes(bases_stack), self._ksize,
                numbands=numbands, band=band, mask=maskspec,
                mask_threshold=mask_threshold, consume_masked=consume_masked)

    def query_batch(self, bases):
        """Device query: uint8 ``[B, P]`` counts (0 at invalid windows) and
        validity for a base-code batch, tensors on the sketch's device: K1,
        then K2."""
        if self.backend != 'device':
            raise ValueError('query_batch needs a device sketch')
        return sketch_ops.query_batch(self.tables, self._codes(bases),
                                      self._ksize, self.counter_bits,
                                      self.tablesize)

    def consume_hashes(self, h1, h2, valid=None):
        """Count pre-hashed k-mers (uint32 arrays); returns the number
        counted.  A device sketch computes their bucket indices and
        scatters them into the consume's accumulator (K3's entry from
        indices on a GPU)."""
        if self.backend == 'host':
            return self._host_consume_hashes(h1, h2, valid)
        h1 = np.asarray(h1, dtype=np.uint32).ravel()
        h2 = np.asarray(h2, dtype=np.uint32).ravel()
        keep = np.ones(h1.shape, dtype=bool) if valid is None else \
            np.asarray(valid, dtype=bool).ravel()
        a = torch.from_numpy(h1.astype(np.int64)).to(self.device)
        b = torch.from_numpy(h2.astype(np.int64)).to(self.device)
        ok = torch.from_numpy(keep).to(self.device)
        idx = torch.stack([hashing.table_index(a, b, t, self.tablesize)
                           for t in range(self.ntables)])
        with self.consuming() as acc:
            acc.add_indices(torch.where(ok, idx, -1).to(torch.int32))
        return int(keep.sum())

    # -- persistence ------------------------------------------------------
    def _rows(self):
        """The unpacked table rows as numpy, one at a time: a device
        sketch unpacks each row on the device, so no full-table host copy
        is made."""
        for t in range(self.ntables):
            if self.backend == 'host':
                yield self.tables[t]
            else:
                yield sketch_ops.unpack_rows(
                    self.tables[t:t + 1], self.counter_bits,
                    self.tablesize).cpu().numpy()

    def save(self, filename):
        """Write the npz file row by row (see :func:`write_npz`)."""
        write_npz(filename, dict(ksize=self._ksize, tablesize=self.tablesize,
                                 ntables=self.ntables,
                                 counter_bits=self.counter_bits,
                                 n_occupied=self.n_occupied()),
                  (self.ntables, self.tablesize), self._rows())

    @classmethod
    def load_file(cls, filename, device='cuda', backend='device'):
        data = _load_npz_mmap(filename)
        if data is None:
            data = np.load(filename, allow_pickle=False)
        tables = data['tables']
        sketch = cls(int(data['ksize']), int(data['tablesize']),
                     int(data['ntables']), int(data['counter_bits']),
                     tables=tables, device=device, backend=backend)
        # the file's (memory-mapped) tables are the host mirror
        sketch._host_tables = tables
        if 'n_occupied' in data:
            sketch._n_occupied = int(data['n_occupied'])
        return sketch


def write_npz(filename, meta, shape, rows):
    """A sketch file: the scalars of ``meta`` and a uint8 ``tables`` member
    of ``shape`` written from ``rows`` (numpy arrays in order) to an
    uncompressed zip member, so that no full-table host copy is made and a
    load can memory-map it."""
    with zipfile.ZipFile(filename, 'w', zipfile.ZIP_STORED) as zf:
        for name, val in meta.items():
            buf = io.BytesIO()
            np.save(buf, np.asarray(val))
            zf.writestr(name + '.npy', buf.getvalue())
        info = zipfile.ZipInfo('tables.npy', date_time=(1980, 1, 1, 0, 0, 0))
        with zf.open(info, 'w', force_zip64=True) as fh:
            header = {'descr': '|u1', 'fortran_order': False,
                      'shape': tuple(shape)}
            np.lib.format.write_array_header_1_0(fh, header)
            for row in rows:
                fh.write(np.ascontiguousarray(row).tobytes())


def estimate_fpr(sketch):
    """(occupancy / min_table_size) ** ntables, as in the reference
    (kevlar/sketch.py:62-74)."""
    occ = float(sketch.n_occupied())
    fp_one = occ / min(sketch.hashsizes())
    return fp_one ** float(sketch.ntables)


def allocate(ksize, target_tablesize, num_tables=4, count=False, graph=False,
             smallcount=False, device='cuda'):
    bits = (4 if smallcount else 8) if count else 1
    if graph:
        # khmer graph types hash with the reversible 2-bit code (and khmer
        # raises on reverse_hash for table types); graphs are control-plane
        # objects in kevlar, so the khmer-compatible host engine serves them
        from kevlar_tpu_torch.oxli import OxliSketch
        return OxliSketch(ksize, target_tablesize, num_tables,
                          counter_bits=bits, hash_mode='twobit')
    return Sketch(ksize, target_tablesize, num_tables, counter_bits=bits,
                  device=device)


def allocate_from_memory(ksize, memory, num_tables=4, counter_bits=8,
                         device='cuda'):
    """khmer-parity sizing: tablesize = memory/ntables * buckets_per_byte,
    forced ODD (khmer sizes its tables to primes for the same reason):
    banding fixes h1 mod numbands, so a tablesize sharing a factor with the
    (power-of-two) band count would confine every band's k-mers to
    1/numbands of each table's buckets."""
    tablesize = int(memory) // num_tables * BUCKETS_PER_BYTE[counter_bits]
    if tablesize % 2 == 0:
        tablesize -= 1
    return Sketch(ksize, max(tablesize, 1), num_tables,
                  counter_bits=counter_bits, device=device)


# In-process cache of sketches this process itself counted and saved, as in
# kevlar_tpu: a multi-stage run (the trio workflow) would otherwise
# reload tables from disk one stage after writing them.  The file's (mtime,
# size) is snapshotted on first use, so an externally modified file always
# reloads from disk.  A cache-served sketch is the SAME live object that
# was saved: callers treat it as read-only.  Bounded to the most recent
# _PROCESS_CACHE_MAX entries.
_process_cache = {}
_PROCESS_CACHE_MAX = 4


def _stat_key(filename):
    try:
        st = os.stat(filename)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def join_save(sketch):
    """Wait for an async save of ``sketch`` (see
    :func:`kevlar_tpu_torch.count.load_sample_seqfile`), if one runs."""
    thread = getattr(sketch, '_save_thread', None)
    if thread is not None:
        thread.join()
        sketch._save_thread = None


def register_saved(filename, sketch):
    """Remember a sketch this process just persisted to ``filename``
    (possibly still being written by its save_async thread)."""
    path = os.path.abspath(filename)
    _process_cache.pop(path, None)
    _process_cache[path] = [sketch, None]
    while len(_process_cache) > _PROCESS_CACHE_MAX:
        evicted = next(iter(_process_cache))
        join_save(_process_cache[evicted][0])
        del _process_cache[evicted]


def _cached_load(filename, device, backend):
    """The live sketch saved to ``filename`` by this process, when the file
    is unchanged since and the sketch lives where the caller asks."""
    path = os.path.abspath(filename)
    entry = _process_cache.get(path)
    if entry is None:
        return None
    sketch, key = entry
    join_save(sketch)
    if key is None:
        entry[1] = key = _stat_key(path)
    if key is None or key != _stat_key(path):
        del _process_cache[path]  # file changed on disk since we wrote it
        return None
    if getattr(sketch, 'mesh', None) is not None:
        return None  # a sharded sketch: the caller gets the file's
    # a khmer-format sketch lives on the host whatever the caller asks
    same_place = not isinstance(sketch, Sketch) or (
        sketch.backend == backend and (
            backend == 'host' or sketch.device == torch.device(device)))
    return sketch if same_place else None


def load(filename, device='cuda', backend='device', cache=True):
    """Load a sketch file of this package's (and ``kevlar_tpu``'s) npz
    format onto ``device``; the extension must name its counter width.
    ``backend='host'`` keeps the counters as a (copy-on-write
    memory-mapped) numpy array, for point-query-only consumers (simlike).
    A khmer-format (OXLI) file loads through :mod:`kevlar_tpu_torch.oxli`,
    whose engine is host-side.  ``cache=False`` skips the in-process cache
    (but still waits for an async save of the same file)."""
    extensions = tuple(COUNTER_BITS_BY_EXTENSION)
    if not filename.endswith(extensions):
        message = 'unable to determine sketch type from filename ' + filename
        raise KevlarSketchTypeError(message)
    if cache:
        cached = _cached_load(filename, device, backend)
        if cached is not None:
            return cached
    else:
        entry = _process_cache.get(os.path.abspath(filename))
        if entry is not None:
            join_save(entry[0])
    from kevlar_tpu_torch import oxli
    if oxli.is_oxli_file(filename):
        sk = oxli.OxliSketch.load(filename)
        if filename.endswith(GRAPH_EXTENSIONS):
            sk.hash_mode = 'twobit'
        return sk
    sketch = Sketch.load_file(filename, device=device, backend=backend)
    ext = '.' + filename.split('.')[-1]
    expected_bits = COUNTER_BITS_BY_EXTENSION[ext]
    if sketch.counter_bits != expected_bits:
        message = 'sketch "{}" has {}-bit counters but extension {} implies {}'
        raise KevlarSketchTypeError(message.format(
            filename, sketch.counter_bits, ext, expected_bits))
    return sketch


def autoload(infile, count=True, graph=False, ksize=31, table_size=1e4,
             num_tables=4, num_bands=None, band=None, device='cuda'):
    """Load a sketch file, or build one from FASTA/FASTQ input."""
    try:
        return load(infile, device=device)
    except KevlarSketchTypeError:
        sketch = allocate(ksize, table_size, num_tables, count=count,
                          graph=graph, smallcount=False, device=device)
        if graph:
            # khmer-engine object: its own (khmer-semantics) consume;
            # library-level band indices are 0-based, as in the reference
            sketch.consume_seqfile(infile, numbands=num_bands, band=band)
            return sketch
        from kevlar_tpu_torch import count as count_mod
        count_mod.consume_seqfile(sketch, [infile], numbands=num_bands,
                                  band=band)
        return sketch


class BandedSketchView:
    """Host-side read-only view over N per-band sketch files.

    Point queries route each k-mer to its band's table with the hash-space
    predicate of the banded count (``h1 & (numbands-1)``); the band files
    load as host-backend memory maps, so scoring touches only the queried
    buckets.
    """

    def __init__(self, sketches):
        n = len(sketches)
        if n & (n - 1):
            raise ValueError('numbands must be a power of two')
        ksizes = {s.ksize() for s in sketches}
        if len(ksizes) != 1:
            raise ValueError('band sketches disagree on ksize')
        self._sketches = list(sketches)
        self._numbands = n
        self._ksize = ksizes.pop()

    @classmethod
    def load(cls, filenames, backend='host', device='cuda'):
        return cls([load(f, device=device, backend=backend, cache=False)
                    for f in filenames])

    def ksize(self):
        return self._ksize

    def get_kmer_counts(self, seq):
        """Counts for every k-mer of ``seq`` (invalid windows -> 0), each
        answered by its owning band's table."""
        h1, h2, valid = dna.kmer_hashes(dna.encode(seq), self._ksize)
        band = h1 & np.uint32(self._numbands - 1)
        counts = np.zeros(h1.shape, dtype=np.int64)
        for b, sk in enumerate(self._sketches):
            sel = valid & (band == b)
            if not sel.any():
                continue
            counts[sel] = sk._host_counts(h1[sel], h2[sel])
        return [int(c) for c in counts]

    def get(self, kmer):
        h1, h2 = dna.hash_kmer(kmer)
        b = int(np.uint32(h1) & np.uint32(self._numbands - 1))
        return self._sketches[b].get(kmer)


def load_sketchfiles(sketchfiles, maxfpr=0.2, device='cuda'):
    """Load each sketch file; raises KevlarUnsuitableFPRError when a
    sketch's estimated false positive rate exceeds ``maxfpr``."""
    from kevlar_tpu_torch import plog
    sketches = []
    for sketchfile in sketchfiles:
        plog('[kevlar::sketch]     loading sketchfile "{}"...'.format(
            sketchfile))
        sketch = autoload(sketchfile, device=device)
        fpr = estimate_fpr(sketch)
        message = 'estimated false positive rate is {:1.3f}'.format(fpr)
        if fpr > maxfpr:
            message += ' (FPR too high, bailing out!!!)'
            raise KevlarUnsuitableFPRError(message)
        plog('[kevlar::sketch]     ' + message)
        sketches.append(sketch)
    return sketches
