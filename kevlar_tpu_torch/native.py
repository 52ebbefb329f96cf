"""Compiled components: the build helper, the C++ assembler binding, the
single-pair aligner, the FASTA/FASTQ batch reader and the novel stage's
text writer.

Every library is compiled at first use into ``BUILD_DIR`` (git-ignored,
inside the package) and loaded with ``ctypes``.  A failed build raises:
nothing falls back to a slower engine (the port has no Python-parser
fallback for counting).

The C++ sources are the port's own, under ``csrc/`` (copies of
``kevlar_tpu``'s, equal but for comments, so that the port builds without
the JAX package's files):

- the assembler from ``csrc/asm.cpp`` alone (no other source, no zlib); its
  ``kt_assemble`` and ``kt_correct`` entry points are bound;
- the aligner from ``csrc/align.cpp`` alone, a library of its own
  (``libkevlar_hostalign.so``, apart from the CUDA aligner's); its
  ``kt_align`` entry point is bound as :func:`align`;
- the reader from ``csrc/fastx.cpp`` alone, linked with ``-lz`` (plain and
  gzipped input); its ``kt_fastx_*`` entry points are bound;
- the novel stage's text writer from ``csrc/augtext.cpp`` alone; its
  ``kt_augtext_lines`` and ``kt_augtext`` entry points are bound as
  :class:`AugTextWriter`.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile

import numpy as np

import kevlar_tpu_torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, '_build')
ASM_SOURCE = os.path.join(_HERE, 'csrc', 'asm.cpp')
FASTX_SOURCE = os.path.join(_HERE, 'csrc', 'fastx.cpp')
ALIGN_SOURCE = os.path.join(_HERE, 'csrc', 'align.cpp')
AUGTEXT_SOURCE = os.path.join(_HERE, 'csrc', 'augtext.cpp')

_lib = None
_fastx_lib = None
_align_lib = None
_augtext_lib = None


def nvcc():
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default ``/usr/local/cuda``)."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    return os.path.join(home, 'bin', 'nvcc')


def build_shared(libname, compile_argv, sources, libs=(), force=False):
    """Compile ``sources`` into ``BUILD_DIR/libname`` with ``compile_argv``
    (the compiler and its flags; ``-o``, the sources and then ``libs`` are
    appended).

    Rebuilds when the library is missing, older than a source, or
    ``force`` is set.  An exclusive lock on ``BUILD_DIR/<libname>.lock``
    serialises concurrent builds of one library (parallel test workers)
    while different libraries build side by side, and the output is
    renamed into place, so a reader never maps a partial file.  The compiler's
    messages go to the log; a failed compile raises ``RuntimeError`` with
    them.  Returns the library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, libname)
    with open(os.path.join(BUILD_DIR, libname + '.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fresh = os.path.exists(path) and all(
            os.path.getmtime(s) <= os.path.getmtime(path) for s in sources)
        if fresh and not force:
            return path
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix='.so.tmp')
        os.close(fd)
        try:
            proc = subprocess.run(
                list(compile_argv) + ['-o', tmp] + list(sources) +
                list(libs),
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError('building {} failed:\n{}{}'.format(
                    libname, proc.stdout, proc.stderr))
            if proc.stdout or proc.stderr:
                kevlar_tpu_torch.plog(proc.stdout + proc.stderr, end='')
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def build(force=False):
    """Compile the assembler library. Returns its path."""
    return build_shared(
        'libkevlar_asm.so',
        ['g++', '-O3', '-shared', '-fPIC', '-std=c++17'], [ASM_SOURCE],
        force=force)


def build_fastx(force=False):
    """Compile the FASTA/FASTQ reader library. Returns its path."""
    return build_shared(
        'libkevlar_fastx.so',
        ['g++', '-O3', '-shared', '-fPIC', '-std=c++17'], [FASTX_SOURCE],
        libs=['-lz'], force=force)


def build_align(force=False):
    """Compile the single-pair aligner library. Returns its path."""
    return build_shared(
        'libkevlar_hostalign.so',
        ['g++', '-O3', '-shared', '-fPIC', '-std=c++17'], [ALIGN_SOURCE],
        force=force)


def build_augtext(force=False):
    """Compile the novel stage's text writer library. Returns its path."""
    return build_shared(
        'libkevlar_augtext.so',
        ['g++', '-O3', '-shared', '-fPIC', '-std=c++17'], [AUGTEXT_SOURCE],
        force=force)


def load():
    """Load (building if needed) the assembler library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.kt_assemble.restype = ctypes.c_int
    lib.kt_assemble.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.kt_correct.restype = ctypes.c_int
    lib.kt_correct.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return _lib


def correct(seqs, k=25, minabund=2):
    """Spectral (k-mer spectrum) substitution-error correction: the BFC
    analog (fermi-lite bfc.c) — repairs weak k-mer runs anchored by solid
    ones.  Returns the corrected sequences (order preserved)."""
    lib = load()
    seqs = [s.sequence if hasattr(s, 'sequence') else s for s in seqs]
    arr = (ctypes.c_char_p * len(seqs))(*[s.encode() for s in seqs])
    cap = sum(len(s) for s in seqs) + len(seqs) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.kt_correct(arr, len(seqs), k, minabund, out, cap)
    return [p.decode() for p in out.raw.split(b'\0')[:n]]


def assemble(records, min_overlap=45):
    """Overlap assembly of a partition; yields contig strings."""
    lib = load()
    seqs = [r.sequence if hasattr(r, 'sequence') else r for r in records]
    arr = (ctypes.c_char_p * len(seqs))(*[s.encode() for s in seqs])
    cap = sum(len(s) for s in seqs) + len(seqs) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.kt_assemble(arr, len(seqs), min_overlap, out, cap)
    pieces = out.raw.split(b'\0')[:n]
    for p in pieces:
        if p:
            yield p.decode()


def load_align():
    """Load (building if needed) the single-pair aligner library."""
    global _align_lib
    if _align_lib is None:
        lib = ctypes.CDLL(build_align())
        lib.kt_align.restype = ctypes.c_int
        lib.kt_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        _align_lib = lib
    return _align_lib


def align(target, query, match=1, mismatch=2, gapopen=5, gapextend=0):
    """(cigar, score) of the global affine-gap alignment of ``query``
    against ``target``, with exact ksw2 (``ksw_extz``) semantics."""
    lib = load_align()
    cap = 2 * (len(target) + len(query)) + 64
    cigar = ctypes.create_string_buffer(cap)
    score = lib.kt_align(target.encode(), len(target), query.encode(),
                         len(query), match, mismatch, gapopen, gapextend,
                         cigar, cap)
    return cigar.value.decode(), score


def load_fastx():
    """Load (building if needed) the FASTA/FASTQ reader library."""
    global _fastx_lib
    if _fastx_lib is not None:
        return _fastx_lib
    lib = ctypes.CDLL(build_fastx())
    lib.kt_fastx_open.restype = ctypes.c_void_p
    lib.kt_fastx_open.argtypes = [ctypes.c_char_p]
    lib.kt_fastx_next_batch.restype = ctypes.c_int
    lib.kt_fastx_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
    lib.kt_fastx_set_overlap.restype = None
    lib.kt_fastx_set_overlap.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kt_fastx_close.restype = None
    lib.kt_fastx_close.argtypes = [ctypes.c_void_p]
    _fastx_lib = lib
    return _fastx_lib


class FastxBatchReader:
    """Stream [max_reads, max_len] padded base batches from a FASTX file
    (plain or gzipped).  Each item is ``(bases [n, max_len] uint8, lengths
    [n] int32, names, quals)``: padding holds the invalid code 4, and
    ``quals`` is a [n, max_len] uint8 array (zero past each read) with
    ``want_quals``, else None.  Records longer than ``max_len`` chunk into
    rows sharing ``overlap`` characters.

    With ``want_names=False`` the names are not decoded (``names`` is
    None).  With ``reuse=True`` every item's ``bases`` is a view of one
    buffer that the next step overwrites, for a caller that copies each
    batch out at once: a step then re-fills only what the last one wrote
    instead of a fresh ``max_reads x max_len`` array."""

    def __init__(self, path, max_reads=4096, max_len=1024, want_quals=False,
                 overlap=0, want_names=True, reuse=False):
        self._lib = load_fastx()
        self._handle = self._lib.kt_fastx_open(path.encode())
        if not self._handle:
            raise IOError('cannot open ' + path)
        if overlap:
            self._lib.kt_fastx_set_overlap(self._handle, int(overlap))
        self.max_reads = max_reads
        self.max_len = max_len
        self.want_quals = want_quals
        self.want_names = want_names
        self.reuse = reuse
        self._bases = None
        self._names = None
        self._dirty = (0, 0)        # rows and columns the last step wrote

    def __iter__(self):
        return self

    def _buffers(self):
        """(bases filled with 4, names buffer) for one step."""
        names_cap = self.max_reads * 256
        if not self.reuse or self._bases is None:
            bases = np.full((self.max_reads, self.max_len), 4,
                            dtype=np.uint8)
            names = ctypes.create_string_buffer(names_cap)
            if self.reuse:
                self._bases, self._names = bases, names
            return bases, names
        rows, cols = self._dirty
        self._bases[:rows, :cols] = 4
        return self._bases, self._names

    def __next__(self):
        if not self._handle:
            raise StopIteration
        bases, names = self._buffers()
        lengths = np.zeros(self.max_reads, dtype=np.int32)
        qbuf = None
        if self.want_quals:
            qbuf = ctypes.create_string_buffer(self.max_reads * self.max_len)
        n = self._lib.kt_fastx_next_batch(
            self._handle, self.max_reads, self.max_len,
            bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            names, len(names), qbuf)
        if n < 0:
            self.close()
            raise IOError('parse error in FASTX input')
        if n == 0:
            self.close()
            raise StopIteration
        self._dirty = (n, int(lengths[:n].max()))
        namelist = None
        if self.want_names:
            # maxsplit: the buffer's tail would otherwise split into
            # ~names_cap empty strings
            namelist = [s.decode('ascii', 'replace')
                        for s in names.raw.split(b'\0', n)[:n]]
        quals = None
        if qbuf is not None:
            quals = np.frombuffer(qbuf.raw, dtype=np.uint8).reshape(
                self.max_reads, self.max_len)[:n]
        return bases[:n], lengths[:n], namelist, quals

    def close(self):
        if self._handle:
            self._lib.kt_fastx_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def load_augtext():
    """Load (building if needed) the novel stage's text writer library."""
    global _augtext_lib
    if _augtext_lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib = ctypes.CDLL(build_augtext())
        lib.kt_augtext_lines.restype = i64
        lib.kt_augtext_lines.argtypes = [p, i64, i64, i64, p, i64, p, p, p]
        lib.kt_augtext.restype = i64
        lib.kt_augtext.argtypes = [
            ctypes.c_int, p, i64, i64, p, i64, p, i64, i64, p, p, i64, p,
            i64, p, i64, p, i64, i64, p, i64, ctypes.c_int, p, i64, p, p]
        _augtext_lib = lib
    return _augtext_lib


# ``AugTextWriter.write``'s canonical code of a k-mer it leaves to the host
NO_CANON = (1 << 64) - 1


def _rows(a):
    """``(address, row stride, bytes addressable)`` of the uint8 array
    ``a``, rows at any non-negative stride, bytes one apart."""
    if a.dtype != np.uint8 or a.ndim != 2 or a.strides[1] != 1 or \
            a.strides[0] < 0:
        raise TypeError('read rows must be uint8 rows of adjacent bytes')
    extent = 0 if not a.size else \
        1 + (a.shape[0] - 1) * a.strides[0] + a.shape[1] - 1
    return a.ctypes.data, a.strides[0], extent


class AugTextWriter:
    """One novel-screen batch's augmented-FASTX block in two calls of
    ``csrc/augtext.cpp`` (``kt_augtext_lines``, ``kt_augtext``), into host
    buffers that each call reuses (the text's grown to twice a block that
    does not fit, and that block written again)."""

    def __init__(self):
        self._lib = load_augtext()
        self._grow_out(0)
        self._grow_lines(0)

    def _grow_out(self, size):
        self._out = np.empty(size, np.uint8)
        self._out_p = self._out.ctypes.data

    def _grow_lines(self, size):
        """Each hit's index kept, each read's row and each line's code."""
        self._keep = np.empty(size, np.int64)
        self._rows = np.empty(size, np.int64)
        self._codes = np.empty(size, np.uint64)
        self._lines_p = [a.ctypes.data for a in
                         (self._keep, self._rows, self._codes)]

    def write(self, ksize, windows, hits, abund, nvalid, discard, fields):
        """``(text, canon, reads, host_hits)`` of one batch's hits.

        Hit ``h`` is window ``h % windows`` of batch row ``h // windows``,
        with the uint8 abundances ``abund[:, h]``; hits on rows from
        ``nvalid`` on, or whose ``discard`` is set, are dropped.
        ``fields(rows)`` gives the reads of the batch rows ``rows`` (int64,
        ascending) as a dict: ``names``, one a row; ``seq``, uint8 rows, and
        ``lengths``, int32, one a data row; ``read_row``, each read's data
        row (absent: the batch rows themselves); where there are qualities,
        ``qual``, uint8 rows, and ``qual_len`` (absent: the lengths);
        ``from_reader`` (default True): the rows are the reader's base
        codes and raw quality bytes (FASTA where those are all NUL), else
        text as the records hold it (FASTA where ``qual_len`` is negative).
        ``canon`` lists each line's canonical k-mer as a 2-bit code,
        :data:`NO_CANON` where ``ksize`` > 32 or the k-mer is not upper-case
        ACGT; ``host_hits`` are those lines' hits."""
        lib = self._lib
        hits = np.ascontiguousarray(hits, dtype=np.int64)
        nhits = len(hits)
        abund = np.ascontiguousarray(abund)
        if abund.dtype != np.uint8 or abund.ndim != 2 or \
                abund.shape[1] != nhits:
            raise TypeError('abundances must be uint8 [samples, hits]')
        discard = np.ascontiguousarray(discard, dtype=np.uint8)
        if len(self._keep) < nhits:
            self._grow_lines(2 * nhits)
        keep, rows, codes = self._keep, self._rows, self._codes
        keep_p, rows_p, codes_p = self._lines_p
        hits_p = hits.ctypes.data
        nrows = ctypes.c_int64()
        nlines = lib.kt_augtext_lines(
            hits_p, nhits, windows, nvalid, discard.ctypes.data,
            len(discard), keep_p, rows_p, ctypes.byref(nrows))
        if nlines < 0:
            raise ValueError('a negative hit, or no windows')
        if not nlines:
            return '', [], 0, hits[:0]
        nreads = nrows.value
        f = fields(rows[:nreads])
        seq, seq_stride, seq_extent = _rows(f['seq'])
        lengths = np.ascontiguousarray(f['lengths'], dtype=np.int32)
        read_row = f.get('read_row')
        if read_row is None:
            read_row_p = rows_p
        else:
            read_row = np.ascontiguousarray(read_row, dtype=np.int64)
            if len(read_row) < nreads:
                raise ValueError('a data row a read is wanted')
            read_row_p = read_row.ctypes.data
        qual, qual_stride, qual_extent, qual_len = None, 0, 0, None
        if f.get('qual') is not None:
            qual, qual_stride, qual_extent = _rows(f['qual'])
            if f.get('qual_len') is not None:
                qual_len = np.ascontiguousarray(f['qual_len'],
                                                dtype=np.int32)
                if len(qual_len) != len(lengths):
                    raise ValueError('qualities and lengths disagree')
        names = '\0'.join(f['names']).encode('utf-8')
        if names.count(b'\0') != nreads - 1:
            raise ValueError('a name a read is wanted, none with a NUL')
        nhost = ctypes.c_int64()
        while True:
            need = lib.kt_augtext(
                int(f.get('from_reader', True)), seq, seq_stride, seq_extent,
                lengths.ctypes.data, len(lengths), qual, qual_stride,
                qual_extent, None if qual_len is None else
                qual_len.ctypes.data, read_row_p, nreads, names, len(names),
                hits_p, nhits, keep_p, nlines, windows, abund.ctypes.data,
                abund.shape[0], ksize, self._out_p, len(self._out), codes_p,
                ctypes.byref(nhost))
            if need < 0:
                raise ValueError('read fields or lines out of bounds')
            if need <= len(self._out):
                break
            self._grow_out(2 * need)
        text = str(memoryview(self._out)[:need], 'utf-8')
        codes = codes[:nlines]
        host_hits = hits[keep[:nlines][codes == np.uint64(NO_CANON)]] \
            if nhost.value else hits[:0]
        return text, codes.tolist(), nreads, host_hits
