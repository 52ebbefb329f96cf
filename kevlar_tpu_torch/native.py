"""Compiled components: the build helper, the C++ assembler binding and
the FASTA/FASTQ batch reader.

Every library is compiled at first use into ``BUILD_DIR`` (git-ignored,
inside the package) and loaded with ``ctypes``.  A failed build raises:
nothing falls back to a slower engine (the port has no Python-parser
fallback for counting).

Both C++ sources are compiled by path from ``kevlar_tpu/native/`` — reading
a file imports nothing of the JAX package:

- the assembler from ``asm.cpp`` alone (no other source, no zlib); its
  ``kt_assemble`` and ``kt_correct`` entry points are bound;
- the reader from ``fastx.cpp`` alone, linked with ``-lz`` (plain and
  gzipped input); its ``kt_fastx_*`` entry points are bound.
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
ASM_SOURCE = os.path.normpath(
    os.path.join(_HERE, '..', 'kevlar_tpu', 'native', 'asm.cpp'))
FASTX_SOURCE = os.path.normpath(
    os.path.join(_HERE, '..', 'kevlar_tpu', 'native', 'fastx.cpp'))

_lib = None
_fastx_lib = None


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
