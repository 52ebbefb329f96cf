"""DNA sequence primitives: encoding, reverse complement, canonical k-mer
hashing and seeds.

Reads are handled as ``uint8`` arrays of 2-bit base codes (A=0, C=1, G=2,
T=3, anything else 4), the encoding the kernels read.  Host-side numpy
only: a copy of ``kevlar_tpu.dna``.  The k-mer hashing here serves point
lookups (``Sketch.get``) and the tests; the batched hashing of the count
and screen stages is :mod:`kevlar_tpu_torch.ops.hashing` and its CUDA
kernel.  ``tests/test_torch_host.py`` and ``tests/test_torch_hashing.py``
pin the copy to its original.
"""

import numpy as np

# Base encoding table: A=0 C=1 G=2 T=3, everything else 4 ("N"/invalid).
BASE_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate('ACGT'):
    BASE_TO_CODE[ord(_b)] = _i
    BASE_TO_CODE[ord(_b.lower())] = _i
CODE_TO_BASE = np.frombuffer(b'ACGTN', dtype=np.uint8)

# IUPAC-aware reverse complement (same alphabet handling as the reference's
# sequence module, kevlar/sequence.pyx:16-23).
REVCOM_TABLE = str.maketrans(
    'ATUGCYRSWKMBDHVNatugcyrswkmbdhvn',
    'TAACGRYSWMKVHDBNTAACGRYSWMKVHDBN'
)


def revcom(sequence):
    """Reverse complement of a DNA string (IUPAC-aware)."""
    return sequence.translate(REVCOM_TABLE)[::-1]


def revcommin(seq):
    """Lexicographic minimum of a sequence and its reverse complement."""
    rc = revcom(seq)
    return seq if seq <= rc else rc


def same_seq(seq1, seq2, seq2revcom=None):
    """Whether ``seq1`` is ``seq2`` or its reverse complement."""
    if seq2revcom is None:
        seq2revcom = revcom(seq2)
    return seq1 == seq2 or seq1 == seq2revcom


def encode(sequence):
    """Encode a DNA string to a uint8 array of 2-bit codes (4 = invalid)."""
    raw = np.frombuffer(sequence.encode('ascii'), dtype=np.uint8)
    return BASE_TO_CODE[raw]


def decode(codes):
    """Decode a uint8 code array back to a DNA string ('N' for invalid)."""
    codes = np.asarray(codes, dtype=np.uint8)
    return CODE_TO_BASE[np.minimum(codes, 4)].tobytes().decode('ascii')


def encode_batch(sequences, pad_to=None):
    """Encode a list of strings into a padded [B, L] code array + lengths.

    Padding positions are filled with 4 (invalid) so no k-mer spanning the pad
    is ever counted.
    """
    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    maxlen = pad_to if pad_to is not None else (int(lengths.max()) if len(sequences) else 0)
    out = np.full((len(sequences), maxlen), 4, dtype=np.uint8)
    for i, s in enumerate(sequences):
        out[i, :len(s)] = encode(s)
    return out, lengths


# ---------------------------------------------------------------------------
# Canonical k-mer codes and hashing (32-bit arithmetic only).
# ---------------------------------------------------------------------------

_U32 = np.uint32
GOLDEN1 = _U32(0x3c6ef372)
GOLDEN2 = _U32(0x9e3779b9)

# long-k (k > 32) polynomial hashing: odd multipliers (units mod 2^32) and
# their precomputed power tables; shared verbatim with ops/hashing.py
MAX_KSIZE = 64
POLY_M1 = 0x9E3779B1
POLY_M2 = 0x85EBCA77
POLY_POW1 = tuple(pow(POLY_M1, i, 1 << 32) for i in range(MAX_KSIZE))
POLY_POW2 = tuple(pow(POLY_M2, i, 1 << 32) for i in range(MAX_KSIZE))


def _fmix32(h):
    """Murmur3 32-bit finaliser (numpy uint32, elementwise)."""
    h = h.astype(np.uint32, copy=True)
    h ^= h >> _U32(16)
    h *= _U32(0x85ebca6b)
    h ^= h >> _U32(13)
    h *= _U32(0xc2b2ae35)
    h ^= h >> _U32(16)
    return h


def kmer_codes(bases, ksize):
    """Pack every k-window of `bases` into canonical (hi, lo) uint32 pairs.

    Parameters
    ----------
    bases : uint8 array [..., L] of 2-bit codes (>=4 marks invalid bases)
    ksize : static int, 1 <= ksize <= MAX_KSIZE

    Returns
    -------
    (c_hi, c_lo, valid): uint32 [..., P], uint32 [..., P], bool [..., P]
    with P = L - ksize + 1.  `valid[p]` is False if any base in the window is
    invalid.  For k <= 32 the code pair is the lexicographic min of the
    forward and reverse-complement packings, so string ``revcommin`` order
    and numeric (hi, lo) order agree (A<C<G<T in both ASCII and numeric
    code); for k > 32 each strand accumulates two polynomial hashes mod 2^32
    and the smaller pair is kept.
    """
    if not 1 <= ksize <= MAX_KSIZE:
        raise ValueError('ksize must be in [1, {}]'.format(MAX_KSIZE))
    bases = np.asarray(bases, dtype=np.uint8)
    L = bases.shape[-1]
    P = L - ksize + 1
    if P <= 0:
        shape = bases.shape[:-1] + (0,)
        z = np.zeros(shape, dtype=np.uint32)
        return z, z.copy(), np.zeros(shape, dtype=bool)

    lo_len = min(ksize, 16)
    hi_len = ksize - lo_len

    b = bases.astype(np.uint32)
    comp = _U32(3) - np.minimum(b, 3).astype(np.uint32)  # garbage where invalid; masked later

    f_lo = np.zeros(bases.shape[:-1] + (P,), dtype=np.uint32)
    f_hi = np.zeros_like(f_lo)
    r_lo = np.zeros_like(f_lo)
    r_hi = np.zeros_like(f_lo)
    if ksize > 32:
        # the reverse strand uses the mirrored powers, so the {forward,
        # reverse} accumulator pair is strand-symmetric and the min below
        # stays canonical
        for i in range(ksize):
            w = b[..., i:i + P]
            c = comp[..., i:i + P]
            f_lo += w * _U32(POLY_POW1[ksize - 1 - i])
            f_hi += w * _U32(POLY_POW2[ksize - 1 - i])
            r_lo += c * _U32(POLY_POW1[i])
            r_hi += c * _U32(POLY_POW2[i])
    else:
        for i in range(ksize):
            w = b[..., i:i + P]
            c = comp[..., i:i + P]
            if i >= ksize - lo_len:
                f_lo += w << _U32(2 * (ksize - 1 - i))
            else:
                f_hi += w << _U32(2 * (hi_len - 1 - i))
            if i < lo_len:
                r_lo += c << _U32(2 * i)
            else:
                r_hi += c << _U32(2 * (i - lo_len))

    bad = (bases >= 4)
    cum = np.zeros(bases.shape[:-1] + (L + 1,), dtype=np.int32)
    np.cumsum(bad, axis=-1, out=cum[..., 1:])
    valid = (cum[..., ksize:ksize + P] - cum[..., :P]) == 0

    use_f = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    c_hi = np.where(use_f, f_hi, r_hi)
    c_lo = np.where(use_f, f_lo, r_lo)
    return c_hi, c_lo, valid


def hash_pair(c_hi, c_lo):
    """Two independent 32-bit hashes from a canonical code pair.

    h2 is forced odd so (h1 + t*h2) mod tablesize gives distinct per-table
    probes (Kirsch-Mitzenmacher double hashing).
    """
    h1 = _fmix32(c_lo ^ _fmix32(c_hi ^ GOLDEN1))
    h2 = _fmix32(c_hi ^ _fmix32(c_lo ^ GOLDEN2)) | _U32(1)
    return h1, h2


def kmer_hashes(bases, ksize):
    """Canonical (h1, h2, valid) for every k-window. See `kmer_codes`."""
    c_hi, c_lo, valid = kmer_codes(bases, ksize)
    return (*hash_pair(c_hi, c_lo), valid)


def hash_kmer(kmer):
    """Hash a single k-mer string; returns (h1, h2) as python ints."""
    h1, h2, valid = kmer_hashes(encode(kmer), len(kmer))
    if not valid[0]:
        raise ValueError('k-mer contains non-ACGT characters: ' + kmer)
    return int(h1[0]), int(h2[0])


def seed_codes(bases, seedsize):
    """Canonical packed codes for long seeds (seedsize <= 128), host only.

    Used by the localizer: seeds (default 51 bp) exceed the 32-base limit
    of the count-stage k-mer packing, so pack into four 64-bit words (numpy
    uint64 is fine on the host).  Returns (codes [..., P, 4] uint64,
    valid [..., P]).  The code is exact (no collisions), so equality of
    codes == equality of canonical sequence, replacing the reference's
    exact-match `bwa mem -k s -T s` seed search
    (kevlar/localize.py:131-144).
    """
    if not 1 <= seedsize <= 128:
        raise ValueError('seedsize must be in [1, 128]')
    bases = np.asarray(bases, dtype=np.uint8)
    L = bases.shape[-1]
    P = L - seedsize + 1
    if P <= 0:
        shape = bases.shape[:-1]
        return (np.zeros(shape + (0, 4), dtype=np.uint64),
                np.zeros(shape + (0,), dtype=bool))
    if bases.ndim == 1 and L > 4096:
        # genome-scale fast path: the per-base pack loop below costs
        # O(seedsize * L) strided uint64 work (40 s for a 25 Mb genome);
        # packing the sequence once into a 64-bit stream and extracting
        # each seed as bit windows is O(L) (identical codes; pinned in
        # tests/test_localize.py, and this copy in tests/test_torch_host.py)
        return _seed_codes_stream(bases, seedsize)
    b = bases.astype(np.uint64)
    comp = np.uint64(3) - np.minimum(b, 3).astype(np.uint64)

    nwords = 4
    fwd = np.zeros(bases.shape[:-1] + (P, nwords), dtype=np.uint64)
    rev = np.zeros_like(fwd)
    # word w holds bases with pack-position in [32*w, 32*w+32), big-endian by
    # word: word 0 is most significant.
    for i in range(seedsize):
        wpos = seedsize - 1 - i          # forward: shift of base i
        fw = nwords - 1 - (wpos // 32)
        fs = np.uint64(2 * (wpos % 32))
        fwd[..., fw] += b[..., i:i + P] << fs
        rpos = i                          # reverse-complement packing
        rw = nwords - 1 - (rpos // 32)
        rs = np.uint64(2 * (rpos % 32))
        rev[..., rw] += comp[..., i:i + P] << rs

    bad = (bases >= 4)
    cum = np.zeros(bases.shape[:-1] + (L + 1,), dtype=np.int32)
    np.cumsum(bad, axis=-1, out=cum[..., 1:])
    valid = (cum[..., seedsize:seedsize + P] - cum[..., :P]) == 0

    # lexicographic word-wise min
    use_f = np.zeros(fwd.shape[:-1], dtype=bool)
    decided = np.zeros_like(use_f)
    for w in range(nwords):
        lt = fwd[..., w] < rev[..., w]
        gt = fwd[..., w] > rev[..., w]
        use_f |= (~decided) & lt
        decided |= lt | gt
    use_f |= ~decided  # equal -> forward
    canon = np.where(use_f[..., None], fwd, rev)
    return canon, valid


def _pack_stream_u64(codes):
    """2-bit-pack a 1-D code array into big-endian uint64 words (32 bases
    per word, first base most significant), padded with two zero words."""
    L = len(codes)
    pad = (-L) % 32
    b = np.concatenate([np.minimum(codes, 3),
                        np.zeros(pad, np.uint8)]).astype(np.uint64)
    w = b.reshape(-1, 32)
    shifts = np.uint64(62) - np.uint64(2) * np.arange(32, dtype=np.uint64)
    gw = np.bitwise_or.reduce(w << shifts[None, :], axis=1)
    return np.concatenate([gw, np.zeros(2, np.uint64)])


def _window64(gw, a):
    """64 stream bits starting at bit offset ``a`` (array), MSB-first."""
    k = a >> 6
    s = (a & 63).astype(np.uint64)
    hi = gw[k] << s
    lo = np.where(s > 0,
                  gw[k + 1] >> ((np.uint64(64) - s) & np.uint64(63)),
                  np.uint64(0))
    return hi | lo


def _seed_codes_stream(bases, seedsize):
    """Fast 1-D `seed_codes`: pack once, extract bit windows per seed.

    Produces the identical (codes, valid) arrays as the generic path for
    every valid seed (N-containing seeds are invalid either way and their
    code content is irrelevant)."""
    L = bases.shape[-1]
    P = L - seedsize + 1
    gw_f = _pack_stream_u64(bases)
    comp = (np.uint8(3) - np.minimum(bases, 3))[::-1]
    gw_r = _pack_stream_u64(comp)

    s2 = 2 * seedsize
    nw_used = -(-s2 // 64)
    r = s2 - 64 * (nw_used - 1)  # bits in the top used word
    p = np.arange(P, dtype=np.int64)

    def extract(gw, pos):
        out = np.zeros((P, 4), dtype=np.uint64)
        top = 4 - nw_used
        topbits = _window64(gw, 2 * pos)
        if r < 64:
            topbits = topbits >> np.uint64(64 - r)
        out[:, top] = topbits
        for w in range(1, nw_used):
            out[:, top + w] = _window64(gw, 2 * pos + r + 64 * (w - 1))
        return out

    fwd = extract(gw_f, p)
    # revcomp(seed at p) == forward seed at (L - seedsize - p) of the
    # reverse-complemented sequence
    rev = extract(gw_r, (L - seedsize) - p)

    bad = (bases >= 4)
    cum = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(bad, out=cum[1:])
    valid = (cum[seedsize:seedsize + P] - cum[:P]) == 0

    use_f = np.zeros(P, dtype=bool)
    decided = np.zeros(P, dtype=bool)
    for w in range(4):
        lt = fwd[:, w] < rev[:, w]
        gt = fwd[:, w] > rev[:, w]
        use_f |= (~decided) & lt
        decided |= lt | gt
    use_f |= ~decided
    canon = np.where(use_f[:, None], fwd, rev)
    return canon, valid
