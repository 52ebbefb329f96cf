"""DNA sequence primitives: encoding, reverse complement, canonical seeds.

Reads are handled as ``uint8`` arrays of 2-bit base codes (A=0, C=1, G=2,
T=3, anything else 4), the encoding the aligner kernel reads.  Host-side
numpy only: a copy of the string and seed helpers of ``kevlar_tpu.dna``
(the k-mer hashing there belongs to the count and screen stages, which this
package does not run yet).  ``tests/test_torch_host.py`` pins the copy to
its original.
"""

import numpy as np

# Base encoding table: A=0 C=1 G=2 T=3, everything else 4 ("N"/invalid).
BASE_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate('ACGT'):
    BASE_TO_CODE[ord(_b)] = _i
    BASE_TO_CODE[ord(_b.lower())] = _i

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


def encode(sequence):
    """Encode a DNA string to a uint8 array of 2-bit codes (4 = invalid)."""
    raw = np.frombuffer(sequence.encode('ascii'), dtype=np.uint8)
    return BASE_TO_CODE[raw]


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
