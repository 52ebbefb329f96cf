"""Global affine-gap alignment with exact ksw2 ``ksw_extz`` semantics.

The reference calls Heng Li's ksw2 ``ksw_extz`` through a C bridge
(kevlar src/align.c:40-83) with an unbounded band, a 5x5 match/mismatch
matrix (N scores 0 against everything) and left-aligned gaps, then formats
the CIGAR with ops "MID".  Variant interpretation depends on the precise
CIGAR structure, so this module reproduces the algorithm's cell arithmetic
and tie-breaking *exactly* (including the quirky first-row E initialisation
and the backtrack's gap-continuation bits):

    H(i,j) = max(H(i-1,j-1) + s(t_i, q_j), E(i,j), F(i,j))
    E(i,j) = max(E(i-1,j) - gape, H(i-1,j) - gapoe)   # gap in query: 'D'
    F(i,j) = max(F(i,j-1) - gape, H(i,j-1) - gapoe)   # gap in target: 'I'

with gapoe = gapopen + gapextend and a gap of length L costing
gapopen + L*gapextend.

Implementations, all bit-identical (copied from ``kevlar_tpu.ops.align``):
- ``align_scalar``  — direct scalar loop (ground truth, tiny inputs/tests)
- ``align_numpy``   — anti-diagonal wavefront, vectorised numpy (host path
                      for a single pair)
- ``align_cuda.align_batch`` — the batched wavefront: a CUDA kernel on a
                      GPU, its plain PyTorch version on the CPU

Direction-byte layout (matches ksw2): bits 0-2 = which matrix maximised H
(0=H/diag, 1=E, 2=F); bit 3 = E-continuation; bit 4 = F-continuation.
"""

import json

import numpy as np

NEG_INF = -0x40000000

_ENC = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate('ACGT'):
    _ENC[ord(_b)] = _i
    _ENC[ord(_b.lower())] = _i


def encode(seq):
    return _ENC[np.frombuffer(seq.encode('ascii'), dtype=np.uint8)]


def score_matrix(match, mismatch):
    a = int(match)
    b = mismatch if mismatch < 0 else -mismatch
    mat = np.full((5, 5), b, dtype=np.int32)
    np.fill_diagonal(mat, a)
    mat[4, :] = 0
    mat[:, 4] = 0
    return mat


def _backtrack(z, tlen, qlen):
    """ksw2 backtrack over the direction matrix; returns CIGAR string."""
    cigar = []  # list of [op, length]

    def push(op, length=1):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += length
        else:
            cigar.append([op, length])

    i, j = tlen - 1, qlen - 1
    state = 0
    while i >= 0 and j >= 0:
        tmp = int(z[i, j])
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if state == 0:
            push('M')
            i -= 1
            j -= 1
        elif state == 1:
            push('D')
            i -= 1
        else:
            push('I')
            j -= 1
    if i >= 0:
        push('D', i + 1)
    if j >= 0:
        push('I', j + 1)
    cigar.reverse()
    return ''.join('{}{}'.format(length, op) for op, length in cigar)


def align_scalar(target, query, match=1, mismatch=2, gapopen=5, gapextend=0):
    """Scalar ground-truth implementation. Returns (cigar, score)."""
    t = encode(target)
    q = encode(query)
    tlen, qlen = len(t), len(q)
    mat = score_matrix(match, mismatch)
    gapoe = gapopen + gapextend
    gape = gapextend

    eh_h = np.zeros(qlen + 1, dtype=np.int64)
    eh_e = np.zeros(qlen + 1, dtype=np.int64)
    eh_h[0] = 0
    eh_e[0] = -(gapoe + gapoe)
    for j in range(1, qlen + 1):
        eh_h[j] = -(gapoe + gape * (j - 1))
        eh_e[j] = -(gapoe + gapoe + gape * j)

    z = np.zeros((tlen, qlen), dtype=np.uint8)
    for i in range(tlen):
        h1 = -(gapoe + gape * i)
        f = -(gapoe + gapoe + gape * i)
        row = mat[t[i]]
        for j in range(qlen):
            h = int(eh_h[j])
            e = int(eh_e[j])
            eh_h[j] = h1
            h += int(row[q[j]])
            d = 0 if h >= e else 1
            h = max(h, e)
            d = d if h >= f else 2
            h = max(h, f)
            h1 = h
            hh = h - gapoe
            e -= gape
            if e > hh:
                d |= 0x08
            e = max(e, hh)
            eh_e[j] = e
            f -= gape
            if f > hh:
                d |= 0x10
            f = max(f, hh)
            z[i, j] = d
        eh_h[qlen] = h1
        eh_e[qlen] = NEG_INF
    score = int(eh_h[qlen])
    return _backtrack(z, tlen, qlen), score


def align_numpy(target, query, match=1, mismatch=2, gapopen=5, gapextend=0):
    """Anti-diagonal wavefront implementation, vectorised along diagonals.

    Bit-identical to ``align_scalar`` (every cell's arithmetic and
    tie-breaking is per-cell identical; only the evaluation order differs,
    and all dependencies come from earlier diagonals).
    """
    t = encode(target)
    q = encode(query)
    tlen, qlen = len(t), len(q)
    if tlen == 0 or qlen == 0:
        # degenerate: pure gap
        if tlen == 0 and qlen == 0:
            return '', 0
        gapoe = gapopen + gapextend
        if tlen == 0:
            return '{}I'.format(qlen), -(gapoe + gapextend * (qlen - 1))
        return '{}D'.format(tlen), -(gapoe + gapextend * (tlen - 1))
    mat = score_matrix(match, mismatch)
    gapoe = gapopen + gapextend
    gape = gapextend

    # H/E/F stored per anti-diagonal d = i + j, indexed by i (target row).
    # Cell (i, j=d-i) valid when max(0, d-qlen+1) <= i <= min(d, tlen-1).
    ndiag = tlen + qlen - 1
    W = tlen  # wavefront width indexed by i
    H_prev = np.full(W, NEG_INF, dtype=np.int64)   # diagonal d-1
    H_prev2 = np.full(W, NEG_INF, dtype=np.int64)  # diagonal d-2
    E_prev = np.full(W, NEG_INF, dtype=np.int64)   # E on diagonal d-1 -> E(i-?,..)
    F_prev = np.full(W, NEG_INF, dtype=np.int64)
    z = np.zeros((tlen, qlen), dtype=np.uint8)

    # boundary helpers (exact ksw_extz initialisation)
    def h_boundary_row(i):   # H(i, -1): value read as diagonal for (i+1, 0)
        return -(gapoe + gape * i)

    def h_boundary_col(j):   # H(-1, j)
        return -(gapoe + gape * (j - 1)) if j >= 1 else 0

    def e_boundary(j):       # E(0, j)
        return -(gapoe + gapoe + gape * j)

    def f_boundary(i):       # F(i, 0)
        return -(gapoe + gapoe + gape * i)

    score_sub = mat[t][:, q]  # [tlen, qlen]

    for d in range(ndiag):
        ilo = max(0, d - qlen + 1)
        ihi = min(d, tlen - 1)
        idx = np.arange(ilo, ihi + 1)
        jdx = d - idx

        # diagonal input H(i-1, j-1): from diagonal d-2 at i-1
        hd = np.full(idx.shape, NEG_INF, dtype=np.int64)
        inner = idx >= 1
        hd[inner] = H_prev2[idx[inner] - 1] if d >= 2 else NEG_INF
        # boundaries: i == 0 -> H(-1, j-1); j == 0 -> H(i-1, -1)
        at_i0 = idx == 0
        if at_i0.any():
            j0 = jdx[at_i0][0]
            hd[at_i0] = h_boundary_col(j0)  # H(-1, j-1) where j = j0
        at_j0 = jdx == 0
        if at_j0.any() and idx[at_j0][0] >= 1:
            hd[at_j0] = h_boundary_row(idx[at_j0][0] - 1)
        # note: cell (0,0) hits both branches; H(-1,-1) = 0 = h_boundary_col(0)
        if at_i0.any() and jdx[at_i0][0] == 0:
            hd[at_i0] = 0

        # E(i, j) = max(E(i-1, j) - gape, H(i-1, j) - gapoe): diag d-1, i-1
        e = np.full(idx.shape, NEG_INF, dtype=np.int64)
        if d >= 1:
            src = idx - 1
            ok = src >= 0
            e[ok] = np.maximum(E_prev[src[ok]] - gape,
                               H_prev[src[ok]] - gapoe)
        if at_i0.any():
            e[at_i0] = e_boundary(jdx[at_i0][0])

        # F(i, j) = max(F(i, j-1) - gape, H(i, j-1) - gapoe): diag d-1, same i
        f = np.full(idx.shape, NEG_INF, dtype=np.int64)
        if d >= 1:
            ok = jdx >= 1
            f[ok] = np.maximum(F_prev[idx[ok]] - gape,
                               H_prev[idx[ok]] - gapoe)
        if at_j0.any():
            f[at_j0] = f_boundary(idx[at_j0][0])

        hdiag = hd + score_sub[idx, jdx]
        dbits = np.where(hdiag >= e, 0, 1).astype(np.uint8)
        h = np.maximum(hdiag, e)
        dbits = np.where(h >= f, dbits, 2).astype(np.uint8)
        h = np.maximum(h, f)

        hh = h - gapoe
        e_cont = (e - gape) > hh
        f_cont = (f - gape) > hh
        dbits |= (e_cont.astype(np.uint8) << 3)
        dbits |= (f_cont.astype(np.uint8) << 4)
        z[idx, jdx] = dbits

        H_prev2, H_prev = H_prev, H_prev2
        H_prev[:] = NEG_INF
        H_prev[idx] = h
        E_new = np.full(W, NEG_INF, dtype=np.int64)
        E_new[idx] = e
        F_new = np.full(W, NEG_INF, dtype=np.int64)
        F_new[idx] = f
        E_prev, F_prev = E_new, F_new

    score = int(H_prev[tlen - 1])
    return _backtrack(z, tlen, qlen), score


def align_both_strands(target_seq, query_seq, match=1, mismatch=2, gapopen=5,
                       gapextend=0, revcom=None):
    """Align query and its reverse complement with the numpy wavefront;
    keep the higher score.

    Parity with kevlar/alignment.pyx:27-44 (ties keep the forward strand).
    Returns (score, cigar, strand).
    """
    if revcom is None:
        from kevlar_tpu_torch.dna import revcom as _revcom
        revcom = _revcom
    cigar1, score1 = align_numpy(target_seq, query_seq, match, mismatch,
                                 gapopen, gapextend)
    cigar2, score2 = align_numpy(target_seq, revcom(query_seq), match,
                                 mismatch, gapopen, gapextend)
    if score2 > score1:
        return score2, cigar2, -1
    return score1, cigar1, 1


def _shared_runs(mesh, parts):
    """Every cell's run of results on every rank: ``parts`` are this
    rank's cells' runs, in cell order."""
    import torch
    from kevlar_tpu_torch.parallel import collectives
    mine = iter(parts)
    pieces = [torch.from_numpy(np.frombuffer(json.dumps(
        next(mine)).encode(), dtype=np.uint8).copy())
        if mesh.is_local(d, s) else None for d, s in mesh.cells()]
    shared = collectives.share(mesh, pieces, [mesh.ranks[d][s] for d, s in
                                              mesh.cells()],
                               device=torch.device('cpu'))
    return [[tuple(r) for r in json.loads(bytes(p.numpy()).decode())]
            for p in shared]


def align_both_strands_batch(pairs, match=1, mismatch=2, gapopen=5,
                             gapextend=0, device='cuda', mesh=None):
    """Both-strand alignment of many (target, query) pairs.

    Returns ``[(score, cigar, strand), ...]`` in input order.  The forward
    and reverse-complement rows of every pair go to the batched wavefront
    (:func:`kevlar_tpu_torch.ops.align_cuda.align_batch`) on ``device``:
    the CUDA kernel on a GPU, its plain PyTorch version on the CPU.  With
    ``mesh`` (:mod:`kevlar_tpu_torch.parallel`) the pairs are cut into
    contiguous runs, one per mesh cell, each aligned on its device by the
    rank that owns it (``device`` is then unused); distinct cards run side
    by side, and every rank gets every run's results (a mesh over ranks
    sends each run's as JSON text).
    """
    if not pairs:
        return []
    if mesh is not None:
        cells = mesh.cells()
        step = -(-len(pairs) // len(cells))
        runs = [(pairs[i * step:(i + 1) * step], mesh.devices[d][s])
                for i, (d, s) in enumerate(cells) if mesh.is_local(d, s)]

        def run(job):
            if not job[0]:
                return []
            return align_both_strands_batch(
                job[0], match=match, mismatch=mismatch, gapopen=gapopen,
                gapextend=gapextend, device=job[1])
        if len({dev for _, dev in runs}) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(len(runs)) as pool:
                parts = list(pool.map(run, runs))
        else:
            parts = [run(job) for job in runs]
        if mesh.distributed:
            parts = _shared_runs(mesh, parts)
        return [picked for part in parts for picked in part]
    from kevlar_tpu_torch.dna import revcom
    from kevlar_tpu_torch.ops.align_cuda import align_batch
    targets, queries = [], []
    for t, q in pairs:
        targets += [t, t]
        queries += [q, revcom(q)]
    flat = align_batch(targets, queries, match=match, mismatch=mismatch,
                       gapopen=gapopen, gapextend=gapextend, device=device)
    picked = []
    for (fwd_cigar, fwd_score), (rev_cigar, rev_score) in zip(flat[::2],
                                                              flat[1::2]):
        # strict: ties keep the forward strand
        if rev_score > fwd_score:
            picked.append((rev_score, rev_cigar, -1))
        else:
            picked.append((fwd_score, fwd_cigar, 1))
    return picked
