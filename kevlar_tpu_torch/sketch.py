"""Count-Min sketch on one torch device: the port of ``kevlar_tpu.sketch``'s
device backend.

A :class:`Sketch` keeps its counters in a ``uint8 [ntables, width]`` tensor
on an explicit device, bit-packed in the persistent layout of
:mod:`kevlar_tpu_torch.ops.sketch_ops`, with a lazily built numpy mirror
(unpacked counter values) for host point lookups.  Counting happens in
:func:`kevlar_tpu_torch.count.consume_seqfile`.

Files are the ``kevlar_tpu`` npz format: members ``tables`` ([ntables,
tablesize] uint8, unpacked), ``ksize``, ``tablesize``, ``ntables``,
``counter_bits`` and ``n_occupied``; the khmer-style extension (.nt, .sct,
.ct, ...) names the counter width.  Either package loads the other's files.
"""

import io
import zipfile

import numpy as np
import torch

from kevlar_tpu_torch import dna
from kevlar_tpu_torch.ops import sketch_ops
from kevlar_tpu_torch.reference import _load_npz_mmap


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
    """Count-Min sketch with canonical k-mer hashing on ``device``.

    ``tables``, when given, are unpacked counter values ([ntables,
    tablesize] uint8, numpy or tensor), as in ``kevlar_tpu``.
    """

    def __init__(self, ksize, tablesize, ntables=4, counter_bits=8,
                 tables=None, device='cuda'):
        tablesize = int(tablesize)
        if tablesize < 1:
            raise ValueError('tablesize must be positive')
        self._ksize = int(ksize)
        self.tablesize = tablesize
        self.ntables = int(ntables)
        self.counter_bits = int(counter_bits)
        self.maxcount = MAXCOUNT[self.counter_bits]
        self.device = torch.device(device)
        self._n_occupied = None
        self._host_tables = None
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

    # -- khmer-parity introspection ------------------------------------
    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return [self.tablesize] * self.ntables

    def n_occupied(self):
        """Occupied buckets in table 0: from the file's metadata for a
        loaded sketch, else one reduction on the device."""
        if self._n_occupied is None:
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
        return self.tables, self.counter_bits, self.tablesize

    # -- host mirror (always unpacked counter values) ---------------------
    def _host(self):
        if self._host_tables is None:
            self._host_tables = sketch_ops.unpack_rows(
                self.tables, self.counter_bits, self.tablesize).cpu().numpy()
        return self._host_tables

    def _invalidate(self):
        self._host_tables = None
        self._n_occupied = None

    # -- point/host queries ----------------------------------------------
    def _host_counts(self, h1, h2):
        tables = self._host()
        counts = None
        for t in range(self.ntables):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(self.tablesize)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        return counts

    def get(self, kmer):
        """Count of a single k-mer (canonical)."""
        h1, h2 = dna.hash_kmer(kmer)
        return int(self._host_counts(np.uint32([h1]), np.uint32([h2]))[0])

    # -- persistence ------------------------------------------------------
    def save(self, filename):
        """Write the npz file row by row: each table row unpacks on the
        device and streams to an uncompressed zip member, so no full-table
        host copy is made."""
        meta = dict(ksize=self._ksize, tablesize=self.tablesize,
                    ntables=self.ntables, counter_bits=self.counter_bits,
                    n_occupied=self.n_occupied())
        with zipfile.ZipFile(filename, 'w', zipfile.ZIP_STORED) as zf:
            for name, val in meta.items():
                buf = io.BytesIO()
                np.save(buf, np.asarray(val))
                zf.writestr(name + '.npy', buf.getvalue())
            info = zipfile.ZipInfo('tables.npy',
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, 'w', force_zip64=True) as fh:
                header = {'descr': '|u1', 'fortran_order': False,
                          'shape': (self.ntables, self.tablesize)}
                np.lib.format.write_array_header_1_0(fh, header)
                for t in range(self.ntables):
                    row = sketch_ops.unpack_rows(
                        self.tables[t:t + 1], self.counter_bits,
                        self.tablesize)
                    fh.write(row.cpu().numpy().tobytes())

    @classmethod
    def load_file(cls, filename, device='cuda'):
        data = _load_npz_mmap(filename)
        if data is None:
            data = np.load(filename, allow_pickle=False)
        tables = data['tables']
        sketch = cls(int(data['ksize']), int(data['tablesize']),
                     int(data['ntables']), int(data['counter_bits']),
                     tables=tables, device=device)
        # the file's (memory-mapped) tables are the host mirror
        sketch._host_tables = tables
        if 'n_occupied' in data:
            sketch._n_occupied = int(data['n_occupied'])
        return sketch


def estimate_fpr(sketch):
    """(occupancy / min_table_size) ** ntables, as in the reference
    (kevlar/sketch.py:62-74)."""
    occ = float(sketch.n_occupied())
    fp_one = occ / min(sketch.hashsizes())
    return fp_one ** float(sketch.ntables)


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


def load(filename, device='cuda'):
    """Load a sketch file of this package's (and ``kevlar_tpu``'s) npz
    format onto ``device``; the extension must name its counter width."""
    extensions = tuple(COUNTER_BITS_BY_EXTENSION)
    if not filename.endswith(extensions):
        message = 'unable to determine sketch type from filename ' + filename
        raise KevlarSketchTypeError(message)
    sketch = Sketch.load_file(filename, device=device)
    ext = '.' + filename.split('.')[-1]
    expected_bits = COUNTER_BITS_BY_EXTENSION[ext]
    if sketch.counter_bits != expected_bits:
        message = 'sketch "{}" has {}-bit counters but extension {} implies {}'
        raise KevlarSketchTypeError(message.format(
            filename, sketch.counter_bits, ext, expected_bits))
    return sketch


def load_sketchfiles(sketchfiles, maxfpr=0.2, device='cuda'):
    """Load each sketch file; raises KevlarUnsuitableFPRError when a
    sketch's estimated false positive rate exceeds ``maxfpr``."""
    from kevlar_tpu_torch import plog
    sketches = []
    for sketchfile in sketchfiles:
        plog('[kevlar::sketch]     loading sketchfile "{}"...'.format(
            sketchfile))
        sketch = load(sketchfile, device=device)
        fpr = estimate_fpr(sketch)
        message = 'estimated false positive rate is {:1.3f}'.format(fpr)
        if fpr > maxfpr:
            message += ' (FPR too high, bailing out!!!)'
            raise KevlarUnsuitableFPRError(message)
        plog('[kevlar::sketch]     ' + message)
        sketches.append(sketch)
    return sketches
