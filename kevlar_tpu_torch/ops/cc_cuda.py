"""The partition stage's CUDA kernel: build, load and launch.

``csrc/cc.cu`` holds **K4**, connected components of the read <-> k-mer
incidence by a lock-free union-find in one pass over the pairs, for Hopper
(nvcc, ``sm_90a``), bound with ``ctypes`` through a plain C entry point.  It replaces the XLA
program of ``kevlar_tpu/ops/cc_ops.py`` (``connected_components_bipartite``,
B6).  Plain version:
:func:`kevlar_tpu_torch.ops.cc_ops.connected_components_plain`.

:func:`cc_labels_cuda` takes tensors its dispatcher has checked, enqueues
the kernels on the current stream without waiting for them (the caller's
copy of the labels to the host is the only wait), raises on a CUDA error and
adds one to ``launches['cc_labels']``.  The library compiles into
``kevlar_tpu_torch/_build/`` at first use; a failed build raises.
"""

import ctypes
import os

import torch

from kevlar_tpu_torch import native

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc', 'cc.cu')

# Kernel runs, for runs that must show the main path went through K4.
launches = {'cc_labels': 0}
_lib = None


def build(force=False):
    """Compile ``csrc/cc.cu`` for sm_90a; returns the library path."""
    return native.build_shared(
        'libkevlar_cc.so',
        [native.nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
         '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas',
         '-v'],
        [SOURCE], force=force)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, cl = ctypes.c_void_p, ctypes.c_int64
        lib.kt_cc_labels.restype = ctypes.c_int
        lib.kt_cc_labels.argtypes = [vp, vp, cl, cl, cl, vp, vp, vp]
        lib.kt_cc_error_string.restype = ctypes.c_char_p
        lib.kt_cc_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def cc_labels_cuda(read_ids, kmer_ids, n_reads, n_kmers):
    """K4 on checked tensors (see
    :func:`kevlar_tpu_torch.ops.cc_ops.connected_components_bipartite`):
    int32 [n_reads] labels, each the smallest read index of its
    component."""
    lib = _load()
    dev = read_ids.device
    labels = torch.empty(n_reads, dtype=torch.int32, device=dev)
    parent = torch.empty(n_reads + n_kmers, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kt_cc_labels(
            read_ids.data_ptr(), kmer_ids.data_ptr(), read_ids.numel(),
            n_reads, n_kmers, labels.data_ptr(), parent.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError('kt_cc_labels: CUDA error {}: {}'.format(
            err, lib.kt_cc_error_string(err).decode()))
    launches['cc_labels'] += 1
    return labels
