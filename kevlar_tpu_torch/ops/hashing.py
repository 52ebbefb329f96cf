"""Canonical k-mer hashing over device tensors: the plain PyTorch version and
the dispatch to its CUDA kernel.

Counterpart of ``kevlar_tpu/ops/hashing.py`` (B2).  Torch's uint32 support
is partial, so the plain version carries every uint32 value in an int64
tensor and masks with ``& 0xFFFFFFFF`` after each operation that can leave
32 bits (add, multiply, left shift); the CUDA kernel
(``csrc/kmer.cu::kt_kmer_hashes``) uses ``uint32_t`` throughout.

:func:`kmer_hashes_codes` is the entry point of the count and screen
stages: it takes the reader's ``uint8 [N, L]`` base codes (0-3, 4 = not
ACGT) and returns ``(h1, h2, valid)`` as ``[N, P]`` int32 (the uint32
bits) and uint8 tensors.  On a CUDA tensor it launches the kernel; on a CPU
tensor it runs :func:`kmer_hashes_plain`.  No path falls back from one to
the other.  :func:`unpack_bases` and :func:`unpack_badmask` read the 2-bit
wire format of ``kevlar_tpu`` (:func:`kevlar_tpu_torch.batch.pack_bases`);
no stage ships it any more, and they stay for the tests that hold the two
packages' formats together.
"""

import torch

from kevlar_tpu_torch.dna import MAX_KSIZE, POLY_POW1, POLY_POW2

U32 = 0xFFFFFFFF
GOLDEN1 = 0x3c6ef372
GOLDEN2 = 0x9e3779b9


def fmix32(h):
    """Murmur3 32-bit finaliser on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * 0x85ebca6b) & U32
    h = h ^ (h >> 13)
    h = (h * 0xc2b2ae35) & U32
    return h ^ (h >> 16)


def kmer_codes(bases, ksize):
    """Canonical (hi, lo, valid) code pair per k-window of ``bases``
    ([..., L] uint8 codes, 4 = invalid): int64 tensors holding uint32
    values, and a bool validity mask.  Op for op the arithmetic of
    ``kevlar_tpu.ops.hashing.kmer_codes`` (shift packing for k <= 32, two
    polynomial hashes per strand for k > 32)."""
    if not 1 <= ksize <= MAX_KSIZE:
        raise ValueError('ksize must be in [1, {}]'.format(MAX_KSIZE))
    L = bases.shape[-1]
    P = L - ksize + 1
    if P <= 0:
        raise ValueError('rows of {} bases hold no {}-mer'.format(L, ksize))
    lo_len = min(ksize, 16)
    hi_len = ksize - lo_len
    b = bases.to(torch.int64)
    comp = 3 - b.clamp(max=3)
    shape = bases.shape[:-1] + (P,)
    f_lo = torch.zeros(shape, dtype=torch.int64, device=bases.device)
    f_hi = torch.zeros_like(f_lo)
    r_lo = torch.zeros_like(f_lo)
    r_hi = torch.zeros_like(f_lo)
    for i in range(ksize):
        w = b[..., i:i + P]
        c = comp[..., i:i + P]
        if ksize > 32:
            f_lo = (f_lo + w * POLY_POW1[ksize - 1 - i]) & U32
            f_hi = (f_hi + w * POLY_POW2[ksize - 1 - i]) & U32
            r_lo = (r_lo + c * POLY_POW1[i]) & U32
            r_hi = (r_hi + c * POLY_POW2[i]) & U32
            continue
        if i >= ksize - lo_len:
            f_lo = (f_lo + (w << (2 * (ksize - 1 - i)))) & U32
        else:
            f_hi = (f_hi + (w << (2 * (hi_len - 1 - i)))) & U32
        if i < lo_len:
            r_lo = (r_lo + (c << (2 * i))) & U32
        else:
            r_hi = (r_hi + (c << (2 * (i - lo_len)))) & U32
    bad = (bases >= 4).to(torch.int32)
    cum = torch.nn.functional.pad(torch.cumsum(bad, dim=-1), (1, 0))
    valid = (cum[..., ksize:ksize + P] - cum[..., :P]) == 0
    use_f = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    return (torch.where(use_f, f_hi, r_hi), torch.where(use_f, f_lo, r_lo),
            valid)


def hash_pair(c_hi, c_lo):
    """Double hash (h1, h2 | 1) of a canonical code pair (int64 tensors
    holding uint32 values)."""
    h1 = fmix32(c_lo ^ fmix32(c_hi ^ GOLDEN1))
    h2 = fmix32(c_hi ^ fmix32(c_lo ^ GOLDEN2)) | 1
    return h1, h2


def kmer_hashes(bases, ksize):
    """(h1, h2, valid) for every k-window; h1/h2 int64 holding uint32."""
    c_hi, c_lo, valid = kmer_codes(bases, ksize)
    h1, h2 = hash_pair(c_hi, c_lo)
    return h1, h2, valid


def table_index(h1, h2, table, tablesize):
    """Bucket index of probe ``table``: ``(h1 + table*h2) mod 2^32 mod
    tablesize``, as int64; h1/h2 are int64 tensors holding uint32 values."""
    return ((h1 + table * h2) & U32) % tablesize


def to_u32(h):
    """int32 tensor of uint32 bits -> int64 tensor of the uint32 values."""
    return h.to(torch.int64) & U32


def to_i32_bits(h):
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def unpack_badmask(badmask, L):
    """[..., L] bool: base i is invalid.  ``badmask`` [..., ceil(L/8)] is
    numpy's ``packbits`` layout: bit 7-(i%8) of byte i//8."""
    idx = torch.arange(L, device=badmask.device)
    return ((badmask[..., idx // 8] >> (7 - idx % 8).to(torch.uint8)) & 1) == 1


def unpack_bases(packed, badmask, L):
    """Unpack the 2-bit wire format into [..., L] uint8 base codes.

    ``packed`` [..., ceil(L/4)]: base i in bits ``2*(i%4)`` of byte i//4;
    an invalid base in ``badmask`` (:func:`unpack_badmask`) unpacks to
    code 4."""
    idx = torch.arange(L, device=packed.device)
    bases = (packed[..., idx // 4] >> (2 * (idx % 4)).to(torch.uint8)) & 3
    return torch.where(unpack_badmask(badmask, L), torch.full_like(bases, 4),
                       bases)


def kmer_hashes_plain(codes, ksize):
    """Plain PyTorch version of the K1 kernel, on any device: hash every
    window and convert to the kernel's output types ([N, P] int32 h1, h2
    holding the uint32 bits; uint8 valid)."""
    h1, h2, valid = kmer_hashes(codes, ksize)
    return to_i32_bits(h1), to_i32_bits(h2), valid.to(torch.uint8)


def kmer_hashes_codes(codes, ksize):
    """(h1, h2, valid) for every k-window of ``codes`` (uint8 [N, L] base
    codes, >= 4 invalid): [N, P] int32 (uint32 bits), int32, uint8.  A CUDA
    batch launches the kernel, a CPU batch runs the plain version."""
    from kevlar_tpu_torch.ops import kmer_cuda
    if codes.dtype != torch.uint8 or codes.dim() != 2 or \
            not codes.is_contiguous():
        raise ValueError('codes must be a contiguous 2-D uint8 tensor, got '
                         '{} {}'.format(codes.dtype, tuple(codes.shape)))
    L = codes.shape[1]
    if not 1 <= ksize <= min(MAX_KSIZE, L):
        raise ValueError('ksize {} outside [1, min({}, L={})]'.format(
            ksize, MAX_KSIZE, L))
    kind = codes.device.type
    if kind == 'cuda':
        if L > kmer_cuda.MAX_ROW_BASES:
            raise ValueError('rows of {} bases exceed the kernel\'s {}'
                             .format(L, kmer_cuda.MAX_ROW_BASES))
        return kmer_cuda.kmer_hashes_cuda(codes, ksize)
    if kind == 'cpu':
        return kmer_hashes_plain(codes, ksize)
    raise ValueError('no k-mer hashing engine for device ' +
                     str(codes.device))
