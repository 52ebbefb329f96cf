"""Canonical k-mer hashing in plain PyTorch, written from the definition.

A window of k <= 31 bases (codes 0-3 for A, C, G, T; 4 or more is not a
base) is the 2k-bit integer ``f`` of its codes, first base highest; its
reverse complement is ``r``, the complement ``3 - code`` of each base with
the last base highest.  The canonical value is ``min(f, r)``; its high 32
bits ``hi`` and low 32 bits ``lo`` (the 62 bits fit a signed 64-bit
integer) are mixed with the Murmur3 finaliser
into two 32-bit hashes::

    h1 = fmix32(lo ^ fmix32(hi ^ 0x3c6ef372))
    h2 = fmix32(hi ^ fmix32(lo ^ 0x9e3779b9)) | 1

and table ``t`` of a Count-Min sketch of ``Z`` buckets a table takes the
bucket ``((h1 + t * h2) mod 2^32) mod Z``.  A window holding a non-base is
not valid.  This is the hash that kevlar's sketches use; the system under
test must give the same buckets, so the constants are part of the
contract, not of an implementation.  Every value lives in an int64 tensor.
"""

import torch

U32 = 0xFFFFFFFF
GOLDEN1 = 0x3c6ef372
GOLDEN2 = 0x9e3779b9


def fmix32(h):
    """Murmur3's 32-bit finaliser on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = (h * 0x85ebca6b) & U32
    h = h ^ (h >> 13)
    h = (h * 0xc2b2ae35) & U32
    return h ^ (h >> 16)


def canonical(codes, ksize):
    """``(value, valid)`` of every k-window of ``codes`` (uint8 [N, L]):
    int64 [N, L-k+1] canonical values and their bool validity."""
    if not 1 <= ksize <= 31:
        raise ValueError('the reference hashes k <= 31, not {}'.format(ksize))
    n, length = codes.shape
    windows = length - ksize + 1
    base = codes.to(torch.int64).clamp(max=3)
    fwd = torch.zeros((n, windows), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for i in range(ksize):
        col = base[:, i:i + windows]
        fwd = (fwd << 2) | col
        rev = rev | ((3 - col) << (2 * i))
    bad = torch.nn.functional.pad((codes >= 4).to(torch.int32).cumsum(1),
                                  (1, 0))
    valid = (bad[:, ksize:] - bad[:, :windows]) == 0
    return torch.minimum(fwd, rev), valid


def hashes(codes, ksize):
    """``(h1, h2, valid)`` of every k-window: int64 [N, P] holding uint32."""
    value, valid = canonical(codes, ksize)
    hi, lo = value >> 32, value & U32
    h1 = fmix32(lo ^ fmix32(hi ^ GOLDEN1))
    h2 = fmix32(hi ^ fmix32(lo ^ GOLDEN2)) | 1
    return h1, h2, valid


def bucket(h1, h2, table, tablesize):
    """Bucket of table ``table`` in a table of ``tablesize`` buckets."""
    return ((h1 + table * h2) & U32) % tablesize
