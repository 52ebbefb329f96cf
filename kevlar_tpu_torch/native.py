"""Compiled components: the build helper and the C++ assembler binding.

Every library is compiled at first use into ``BUILD_DIR`` (git-ignored,
inside the package) and loaded with ``ctypes``.  A failed build raises:
nothing falls back to a slower engine.

The assembler is built from ``kevlar_tpu/native/asm.cpp`` alone, by path —
the file needs no other source and no zlib, and reading it imports nothing
of the JAX package.  Only its ``kt_assemble`` and ``kt_correct`` entry points
are bound here.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile

import kevlar_tpu_torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, '_build')
ASM_SOURCE = os.path.normpath(
    os.path.join(_HERE, '..', 'kevlar_tpu', 'native', 'asm.cpp'))

_lib = None


def build_shared(libname, compile_argv, sources, force=False):
    """Compile ``sources`` into ``BUILD_DIR/libname`` with ``compile_argv``
    (the compiler and its flags; ``-o`` and the sources are appended).

    Rebuilds when the library is missing, older than a source, or
    ``force`` is set.  An exclusive lock on ``BUILD_DIR/.lock`` serialises
    concurrent builds (parallel test workers), and the output is renamed
    into place, so a reader never maps a partial file.  The compiler's
    messages go to the log; a failed compile raises ``RuntimeError`` with
    them.  Returns the library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, libname)
    with open(os.path.join(BUILD_DIR, '.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fresh = os.path.exists(path) and all(
            os.path.getmtime(s) <= os.path.getmtime(path) for s in sources)
        if fresh and not force:
            return path
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix='.so.tmp')
        os.close(fd)
        try:
            proc = subprocess.run(
                list(compile_argv) + ['-o', tmp] + list(sources),
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
