"""The count and screen stages' CUDA kernels: build, load and launch.

``csrc/kmer.cu`` holds the kernels of the Count-Min sketch for Hopper (nvcc,
``sm_90a``), bound with ``ctypes`` through plain C entry points:

- **K1** :func:`kmer_hashes_cuda` — canonical k-mer hashing of the reader's
  base codes (one byte a base), a rolling update per window; replaces the
  XLA program of ``kevlar_tpu/ops/hashing.py`` (``kmer_codes``,
  ``hash_pair``).  Plain version:
  :func:`kevlar_tpu_torch.ops.hashing.kmer_hashes_plain`.
- **K2** :func:`gather_counts_cuda` — the min over the tables of up to
  :data:`MAX_SAMPLES` Count-Min sketches in one launch, at 1, 4 or 8 bits
  per counter; replaces ``kevlar_tpu/ops/sketch_ops.py::gather_counts``
  and ``gather_counts_multi``.  Plain version:
  :func:`kevlar_tpu_torch.ops.sketch_ops.gather_counts_multi_plain`.
- **K2 words** :func:`gather_words_cuda` (``kt_gather_words``) — the same
  minimum over packed sample tables, four samples' 8-bit counters to a
  uint32 word (:func:`kevlar_tpu_torch.ops.sketch_ops.pack_sample_tables`),
  so one 4-byte load serves four samples; replaces
  ``kevlar_tpu/ops/sketch_ops.py::gather_counts_multi`` over packed words
  (``:105``), the screen of ``count_and_screen_stack_packed``.  Plain
  version: :func:`kevlar_tpu_torch.ops.sketch_ops.gather_counts_words_plain`.
- **The screen** :func:`screen_reads_cuda` (``kt_screen_reads``) — one
  read batch's base codes screened over packed sample words in one
  launch: each window hashed as K1 hashes it (in the block, never written
  out), every sample's count gathered from the words as the word gather
  does, the screen's predicates tested where they are gathered (casemin,
  ctrlmax, the band, the reads to skip, the abundance screen's discard)
  and each hit stored at its global rank below a fixed capacity;
  replaces ``kevlar_tpu/ops/novel_ops.py::novel_screen_compact`` over
  packed words (``:111``).  Plain version:
  :func:`kevlar_tpu_torch.ops.novel_ops.novel_screen_compact_plain`.
- **K3**, two entries over the same atomic add into a resident int32
  accumulator; both replace ``tools/scatter_probe.py::pallas_scatter_add``
  (the ``pl.pallas_call`` at ``:76``, B10).  :func:`consume_cuda` is the
  count path's kernel: it takes K1's hashes and validity (and K2's mask
  counts), applies the band and mask predicates and computes the bucket
  indices itself; plain version
  :func:`kevlar_tpu_torch.ops.sketch_ops.consume_hashes_plain`.  The same
  kernel can add the number of k-mers it kept to a device counter, and in
  mark mode (:func:`mark_cuda`, plain version ``mark_hashes_plain``) stores
  1 into a table of 8-bit counters instead.  ``kt_scatter_add`` takes
  given indices, as B10 does, in two forms: :func:`scatter_add_cuda`, a
  ``[T, N]`` index tensor (plain version
  :func:`kevlar_tpu_torch.ops.sketch_ops.scatter_add_plain`), and
  :func:`scatter_add_parts_cuda`, the received bins of a routed consume
  where they lie, each read up to its population (plain version
  :func:`kevlar_tpu_torch.ops.sketch_ops.scatter_add_parts_plain`).
- K2 and :func:`consume_cuda` also take a bucket range: a shard of a
  :class:`kevlar_tpu_torch.parallel.ShardedSketch` holds the buckets
  ``[lo, lo + span)`` of a hash space of ``total``; the gather reads 255
  outside it and the consume adds only inside it.  Their launches count
  under ``gather_counts_range`` and ``consume_range``.
- :func:`route_cuda` (``kt_route``) — bins every table's bucket index of
  hashed k-mers by owner shard into a ``[T, S, C]`` send buffer, each bin's
  slots in k-mer order, for the routed consume of a sharded sketch;
  replaces the binning half of
  ``kevlar_tpu/parallel/sharded.py::_route_consume``.  Plain version:
  :func:`kevlar_tpu_torch.ops.sketch_ops.route_plain`.

Each launch function takes tensors its dispatcher has checked, launches on
the current stream, raises on a CUDA error and adds one to its entry of
:data:`launches`.  The library compiles into ``kevlar_tpu_torch/_build/``
at first use; a failed build raises.
"""

import ctypes
import functools
import os

import torch

from kevlar_tpu_torch import native
from kevlar_tpu_torch.dna import POLY_M1, POLY_M2

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc', 'kmer.cu')

# Kernel launches by kernel, for runs that must show the main path went
# through the kernels.
launches = {'kmer_hashes': 0, 'gather_counts': 0, 'gather_counts_range': 0,
            'gather_counts_words': 0, 'screen_reads': 0, 'consume': 0,
            'consume_range': 0, 'scatter_add': 0, 'scatter_add_parts': 0,
            'route': 0}

# Sketches one K2 launch serves (``kMaxSamples`` in the source).
MAX_SAMPLES = 8
# Word tensors one word-gather launch serves (``kMaxWords``): 16 samples.
MAX_WORDS = 4
# Longest row K1 takes: a block keeps one whole row in shared memory.
MAX_ROW_BASES = 200_000

_lib = None


class _GatherSample(ctypes.Structure):
    _fields_ = [('tables', ctypes.c_void_p), ('width', ctypes.c_int64),
                ('tablesize', ctypes.c_uint32), ('magic', ctypes.c_uint32),
                ('lo', ctypes.c_uint32), ('span', ctypes.c_uint32),
                ('ntables', ctypes.c_int32), ('bits', ctypes.c_int32)]


class _GatherArgs(ctypes.Structure):
    _fields_ = [('s', _GatherSample * MAX_SAMPLES)]


class _ScatterSeg(ctypes.Structure):
    """A ``[T, n]`` block of int32 bucket indices for ``kt_scatter_add``:
    row t at ``idx + t * stride``, holding ``min(pop[t * pop_stride], n)``
    indices where ``pop`` is not null (``ScatterSeg`` in the source)."""
    _fields_ = [('idx', ctypes.c_void_p), ('pop', ctypes.c_void_p),
                ('stride', ctypes.c_int64), ('pop_stride', ctypes.c_int64),
                ('n', ctypes.c_int64)]


def mod_magic(tablesize):
    """The reciprocal K2 reduces with: ``floor(2^32 / tablesize)``, capped
    at ``2^32 - 1`` (tablesize 1).  With it, ``r = x - umulhi(x, magic) *
    tablesize`` lies in ``[0, 2 * tablesize)`` for every uint32 ``x``, and
    ``r - tablesize`` where ``r >= tablesize`` is ``x mod tablesize``."""
    if not 1 <= tablesize < (1 << 31):
        raise ValueError('tablesize must be in [1, 2^31)')
    return min((1 << 32) // tablesize, (1 << 32) - 1)


@functools.lru_cache(maxsize=None)
def roll_constants(ksize):
    """The 8 uint32 constants of K1's rolling update (``RollConstants`` in
    the source): the weights of the digits leaving the high and low
    forward halves for k <= 32 (0 where the weight is 4^16 = 2^32), then
    ``M^k``, ``M^(k-1)`` and ``M^-1`` mod 2^32 of both polynomial
    multipliers for k > 32."""
    lo_len = min(ksize, 16)
    hi_len = ksize - lo_len
    mod = 1 << 32
    return (pow(4, hi_len, mod), pow(4, lo_len, mod),
            pow(POLY_M1, ksize, mod), pow(POLY_M2, ksize, mod),
            pow(POLY_M1, ksize - 1, mod), pow(POLY_M2, ksize - 1, mod),
            pow(POLY_M1, -1, mod), pow(POLY_M2, -1, mod))


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
        lib.kt_kmer_hashes.argtypes = [vp, cl, ci, ci, vp, vp, vp, vp, vp]
        lib.kt_gather_counts.restype = ci
        lib.kt_gather_counts.argtypes = [vp, ci, vp, vp, cl, vp, vp]
        lib.kt_gather_words.restype = ci
        lib.kt_gather_words.argtypes = [vp, ci, ci, ci, cl, ctypes.c_uint32,
                                        vp, vp, cl, vp, vp]
        u32 = ctypes.c_uint32
        lib.kt_screen_reads.restype = ci
        lib.kt_screen_reads.argtypes = [vp, ci, ci, ci, ci, cl, u32, vp, vp,
                                        cl, ci, ci, vp, u32, u32, ci, ci, ci,
                                        ci, vp, vp, vp, vp, vp, vp, vp]
        lib.kt_screen_reads_scratch.restype = cl
        lib.kt_screen_reads_scratch.argtypes = [cl, ci]
        lib.kt_scatter_add.restype = ci
        lib.kt_scatter_add.argtypes = [vp, cl, ci, vp, ci, vp]
        lib.kt_consume.restype = ci
        lib.kt_consume.argtypes = [vp, cl, u32, cl, cl, ci, vp, vp, vp, vp,
                                   cl, u32, u32, ci, ci, ci, vp, vp]
        lib.kt_route.restype = ci
        lib.kt_route.argtypes = [vp, vp, vp, cl, cl, u32, cl, u32, ci, ci,
                                 cl, vp, vp, vp, vp]
        lib.kt_route_scratch.restype = cl
        lib.kt_route_scratch.argtypes = [cl, ci, ci]
        lib.kt_kmer_error_string.restype = ctypes.c_char_p
        lib.kt_kmer_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError('{}: CUDA error {}: {}'.format(
            name, err, lib.kt_kmer_error_string(err).decode()))


def kmer_hashes_cuda(codes, ksize):
    """K1 on a checked batch of base codes (see
    :func:`kevlar_tpu_torch.ops.hashing.kmer_hashes_codes`): returns [N, P]
    int32 h1, int32 h2 (uint32 bits) and uint8 valid."""
    lib = _load()
    dev = codes.device
    N, L = codes.shape
    P = L - ksize + 1
    h1 = torch.empty((N, P), dtype=torch.int32, device=dev)
    h2 = torch.empty((N, P), dtype=torch.int32, device=dev)
    valid = torch.empty((N, P), dtype=torch.uint8, device=dev)
    consts = (ctypes.c_uint32 * 8)(*roll_constants(ksize))
    with torch.cuda.device(dev):
        err = lib.kt_kmer_hashes(
            codes.data_ptr(), N, L, ksize, consts, h1.data_ptr(),
            h2.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_kmer_hashes', err)
    launches['kmer_hashes'] += 1
    return h1, h2, valid


def gather_counts_cuda(samples, h1, h2):
    """K2 on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.gather_counts_multi`; each
    sample ``(tables, counter_bits, tablesize)`` or ``(tables, counter_bits,
    total, lo, span)``): uint8 [S, N], one launch per :data:`MAX_SAMPLES`
    sketches."""
    lib = _load()
    dev = h1.device
    n = h1.numel()
    out = torch.empty((len(samples), n), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for first in range(0, len(samples), MAX_SAMPLES):
        chunk = samples[first:first + MAX_SAMPLES]
        args = _GatherArgs()
        ranged = False
        for slot, sample in zip(args.s, chunk):
            tables, bits, total = sample[:3]
            lo, span = sample[3:] if len(sample) == 5 else (0, total)
            ranged = ranged or (lo, span) != (0, total)
            slot.tables = tables.data_ptr()
            slot.width = tables.shape[1]
            slot.tablesize = total
            slot.magic = mod_magic(total)
            slot.lo = lo
            slot.span = span
            slot.ntables = tables.shape[0]
            slot.bits = bits
        with torch.cuda.device(dev):
            err = lib.kt_gather_counts(
                ctypes.byref(args), len(chunk), h1.data_ptr(), h2.data_ptr(),
                n, out[first:].data_ptr(), stream)
        _raise_on(lib, 'kt_gather_counts', err)
        launches['gather_counts_range' if ranged else 'gather_counts'] += 1
    return out


def gather_words_cuda(words, nsamples, h1, h2):
    """The word gather on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.gather_counts_words`; ``words``
    int32 [T, tablesize] tensors holding the uint32 words): uint8 [S, N],
    one launch per :data:`MAX_WORDS` word tensors."""
    lib = _load()
    dev = h1.device
    n = h1.numel()
    ntables, tablesize = words[0].shape
    out = torch.empty((nsamples, n), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for first in range(0, len(words), MAX_WORDS):
        chunk = words[first:first + MAX_WORDS]
        ptrs = (ctypes.c_void_p * len(chunk))(*[w.data_ptr() for w in chunk])
        with torch.cuda.device(dev):
            err = lib.kt_gather_words(
                ptrs, len(chunk), min(nsamples - 4 * first, 4 * len(chunk)),
                ntables, tablesize, mod_magic(tablesize), h1.data_ptr(),
                h2.data_ptr(), n, out[4 * first:].data_ptr(), stream)
        _raise_on(lib, 'kt_gather_words', err)
        launches['gather_counts_words'] += 1
    return out


def screen_reads_cuda(words, nsamples, ncase, codes, lengths, ksize,
                      casemin, ctrlmax, screen, numbands, band, max_hits):
    """``kt_screen_reads`` on checked tensors (see
    :func:`kevlar_tpu_torch.ops.novel_ops.novel_screen_compact`; ``words``
    int32 [T, tablesize] tensors holding the uint32 words, at most
    :data:`MAX_WORDS`).  Returns ``(hit_idx int32 [max_hits], hit_abunds
    uint8 [S, max_hits], n_hits int32 0-d, discard bool [B], skip bool
    [B])``."""
    lib = _load()
    dev = codes.device
    B, L = codes.shape
    ntables, tablesize = words[0].shape
    hit_idx = torch.empty(max_hits, dtype=torch.int32, device=dev)
    hit_abunds = torch.empty((nsamples, max_hits), dtype=torch.uint8,
                             device=dev)
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    discard = torch.empty(B, dtype=torch.bool, device=dev)
    skip = torch.empty(B, dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.kt_screen_reads_scratch(B, L - ksize + 1),
                          dtype=torch.int64, device=dev)
    ptrs = (ctypes.c_void_p * len(words))(*[w.data_ptr() for w in words])
    consts = (ctypes.c_uint32 * 8)(*roll_constants(ksize))
    with torch.cuda.device(dev):
        err = lib.kt_screen_reads(
            ptrs, len(words), nsamples, ncase, ntables, tablesize,
            mod_magic(tablesize), codes.data_ptr(), lengths.data_ptr(), B, L,
            ksize, consts, numbands - 1 if numbands else 0,
            band if numbands else 0, casemin, ctrlmax,
            -1 if screen is None else screen, max_hits, hit_idx.data_ptr(),
            hit_abunds.data_ptr(), n_hits.data_ptr(), discard.data_ptr(),
            skip.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_screen_reads', err)
    launches['screen_reads'] += 1
    return hit_idx, hit_abunds, n_hits, discard, skip


def _launch_scatter(acc, segs, counter):
    lib = _load()
    dev = acc.device
    array = (_ScatterSeg * len(segs))(*segs)
    with torch.cuda.device(dev):
        err = lib.kt_scatter_add(
            acc.data_ptr(), acc.shape[1], acc.shape[0], array, len(segs),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_scatter_add', err)
    launches[counter] += 1
    return acc


def scatter_add_cuda(acc, idx):
    """K3 from a ``[T, N]`` index tensor, on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.scatter_add`): adds in place and
    returns ``acc``."""
    n = idx.shape[1]
    return _launch_scatter(acc, [_ScatterSeg(idx.data_ptr(), None, n, 0, n)],
                           'scatter_add')


def scatter_add_parts_cuda(acc, parts, pops):
    """K3 over received bins where they lie, on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.scatter_add_parts`): each part
    ``[T, C]`` (rows at any stride) is read up to its population in
    ``pops`` (``[T]`` at any stride); adds in place and returns ``acc``."""
    return _launch_scatter(acc, [
        _ScatterSeg(part.data_ptr(), pop.data_ptr(), part.stride(0),
                    pop.stride(0), part.shape[1])
        for part, pop in zip(parts, pops)], 'scatter_add_parts')


def _launch_consume(target, h1, h2, valid, mcnt, mask_threshold,
                    consume_masked, numbands, band, mark, nkept, total, lo):
    lib = _load()
    dev = target.device
    span = target.shape[1]
    if total is None:
        total = span
    with torch.cuda.device(dev):
        err = lib.kt_consume(
            target.data_ptr(), total, mod_magic(total), lo, span,
            target.shape[0], h1.data_ptr(), h2.data_ptr(), valid.data_ptr(),
            None if mcnt is None else mcnt.data_ptr(), h1.numel(),
            numbands - 1 if numbands else 0, band if numbands else 0,
            int(mask_threshold), int(bool(consume_masked)), int(mark),
            None if nkept is None else nkept.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_consume', err)
    launches['consume' if (lo, span) == (0, total) else 'consume_range'] += 1
    return target


def consume_cuda(acc, h1, h2, valid, mcnt=None, mask_threshold=0,
                 consume_masked=False, numbands=None, band=None, nkept=None,
                 total=None, lo=0):
    """K3 from hashes, on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.consume_hashes`; ``acc`` holds
    the buckets ``[lo, lo + acc.shape[1])`` of a hash space of ``total``,
    by default all of it): adds in place (and the number of k-mers kept to
    ``nkept``, where given) and returns ``acc``."""
    return _launch_consume(acc, h1, h2, valid, mcnt, mask_threshold,
                           consume_masked, numbands, band, False, nkept,
                           total, lo)


def mark_cuda(tables, h1, h2, valid, mcnt=None, mask_threshold=0,
              consume_masked=False, numbands=None, band=None):
    """K3's kernel in mark mode, on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.mark_hashes`): stores 1 at the
    kept k-mers' buckets of the 8-bit ``tables`` in place and returns
    them."""
    return _launch_consume(tables, h1, h2, valid, mcnt, mask_threshold,
                           consume_masked, numbands, band, True, None, None,
                           0)


def route_cuda(h1, h2, valid, ntables, nshards, shard_size, total, capacity):
    """``kt_route`` on checked tensors (see
    :func:`kevlar_tpu_torch.ops.sketch_ops.route`): returns ``send``
    [ntables, nshards, capacity] int32, each bin's first ``min(population,
    capacity)`` slots filled in k-mer order and the others left as they
    were allocated, and the bins' populations [ntables, nshards] int32."""
    lib = _load()
    dev = h1.device
    send = torch.empty((ntables, nshards, capacity), dtype=torch.int32,
                       device=dev)
    pop = torch.empty((ntables, nshards), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.kt_route_scratch(h1.numel(), ntables, nshards),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kt_route(
            h1.data_ptr(), h2.data_ptr(), valid.data_ptr(), h1.numel(),
            total, mod_magic(total), shard_size, mod_magic(shard_size),
            ntables, nshards, capacity, send.data_ptr(), pop.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, 'kt_route', err)
    launches['route'] += 1
    return send, pop
