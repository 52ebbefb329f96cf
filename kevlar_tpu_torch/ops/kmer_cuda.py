"""The count and screen stages' CUDA kernels: build, load and launch.

``csrc/kmer.cu`` holds three kernels for Hopper (nvcc, ``sm_90a``), bound
with ``ctypes`` through plain C entry points:

- **K1** :func:`kmer_hashes_cuda` — canonical k-mer hashing straight from
  the 2-bit wire format; replaces the XLA program of
  ``kevlar_tpu/ops/hashing.py`` (``unpack_bases``, ``kmer_codes``,
  ``hash_pair``).  Plain version:
  :func:`kevlar_tpu_torch.ops.hashing.kmer_hashes_packed_plain`.
- **K2** :func:`gather_counts_cuda` — the min over the tables of a
  Count-Min sketch at 1, 4 or 8 bits per counter; replaces
  ``kevlar_tpu/ops/sketch_ops.py::gather_counts``.  Plain version:
  :func:`kevlar_tpu_torch.ops.sketch_ops.gather_counts_plain`.
- **K3** :func:`scatter_add_cuda` — the per-table bincount into a resident
  int32 accumulator; replaces ``tools/scatter_probe.py::pallas_scatter_add``
  (the ``pl.pallas_call`` at ``:76``, B10).  Plain version:
  :func:`kevlar_tpu_torch.ops.sketch_ops.scatter_add_plain`.

Each launch function takes tensors its dispatcher has checked, launches on
the current stream, raises on a CUDA error and adds one to its entry of
:data:`launches`.  The library compiles into ``kevlar_tpu_torch/_build/``
at first use; a failed build raises.
"""

import ctypes
import os

import torch

from kevlar_tpu_torch import native

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc', 'kmer.cu')

# Kernel launches by kernel, for runs that must show the main path went
# through the kernels.
launches = {'kmer_hashes': 0, 'gather_counts': 0, 'scatter_add': 0}

_lib = None


def build(force=False):
    """Compile ``csrc/kmer.cu`` for sm_90a; returns the library path."""
    return native.build_shared(
        'libkevlar_kmer.so',
        [native.nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
         '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas',
         '-v'],
        [SOURCE], force=force)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.kt_kmer_hashes.restype = ci
        lib.kt_kmer_hashes.argtypes = [vp, vp, cl, ci, ci, ci, ci, vp, vp,
                                       vp, vp]
        lib.kt_gather_counts.restype = ci
        lib.kt_gather_counts.argtypes = [vp, ci, cl, cl, ci, vp, vp, cl, vp,
                                         vp]
        lib.kt_scatter_add.restype = ci
        lib.kt_scatter_add.argtypes = [vp, cl, vp, cl, cl, vp]
        lib.kt_kmer_error_string.restype = ctypes.c_char_p
        lib.kt_kmer_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError('{}: CUDA error {}: {}'.format(
            name, err, lib.kt_kmer_error_string(err).decode()))


def kmer_hashes_cuda(packed, badmask, L, ksize):
    """K1 on a checked wire-format batch (see
    :func:`kevlar_tpu_torch.ops.hashing.kmer_hashes_packed`): returns [N, P]
    int32 h1, int32 h2 (uint32 bits) and uint8 valid."""
    lib = _load()
    dev = packed.device
    N = packed.shape[0]
    P = L - ksize + 1
    h1 = torch.empty((N, P), dtype=torch.int32, device=dev)
    h2 = torch.empty((N, P), dtype=torch.int32, device=dev)
    valid = torch.empty((N, P), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.kt_kmer_hashes(
            packed.data_ptr(), badmask.data_ptr(), N, packed.shape[1],
            badmask.shape[1], P, ksize, h1.data_ptr(), h2.data_ptr(),
            valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_kmer_hashes', err)
    launches['kmer_hashes'] += 1
    return h1, h2, valid


def gather_counts_cuda(tables, h1, h2, counter_bits, tablesize):
    """K2 on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.gather_counts`): uint8 [N]."""
    lib = _load()
    dev = tables.device
    out = torch.empty(h1.shape, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.kt_gather_counts(
            tables.data_ptr(), tables.shape[0], tables.shape[1], tablesize,
            counter_bits, h1.data_ptr(), h2.data_ptr(), h1.numel(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_gather_counts', err)
    launches['gather_counts'] += 1
    return out


def scatter_add_cuda(acc, idx):
    """K3 on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.scatter_add`): adds in place and
    returns ``acc``."""
    lib = _load()
    dev = acc.device
    with torch.cuda.device(dev):
        err = lib.kt_scatter_add(
            acc.data_ptr(), acc.shape[1], idx.data_ptr(), idx.shape[0],
            idx.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_scatter_add', err)
    launches['scatter_add'] += 1
    return acc
