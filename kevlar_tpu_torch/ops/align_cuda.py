"""Batched ksw2 ``ksw_extz`` alignment: a Hopper CUDA kernel pair (DP and
traceback) and their plain PyTorch version.

Counterpart of ``kevlar_tpu/ops/align_pallas.py`` (the Pallas kernel) and
``kevlar_tpu/ops/align_ops.py`` (its XLA twin).  Three layers:

- :func:`align_batch` takes (target, query) strings and returns
  ``[(cigar, score)]`` in input order.  It sorts the pairs by target length
  into chunks whose padded direction buffer stays under
  ``ZDIAG_BUDGET_BYTES``, encodes each chunk to padded ``[B, T]`` /
  ``[B, Q]`` uint8 code tensors on ``device``, runs :func:`ksw_extz`, and
  builds the CIGARs on the host (:func:`_cigars_from_ops_batch`).
- :func:`ksw_extz` checks the tensors and dispatches on their device: a
  CUDA tensor launches the kernel (:func:`ksw_extz_cuda`, source
  ``csrc/align.cu``) or raises; a CPU tensor runs :func:`ksw_extz_plain`.
  No path falls back from one to the other.
- :func:`ksw_extz_plain` is the recurrence of
  ``align_ops._align_wavefront_batch`` and ``_traceback_batch``, written over
  the padded batch with a Python loop over anti-diagonals.  The CPU tests
  pin it to the JAX package, and the GPU smoke run pins the kernel to it.

Both return ``(scores [B] int32, ops_rev [B, T+Q] uint8, exit_i [B] int32,
exit_j [B] int32)``: the score at cell (tlen-1, qlen-1) (``NEG_INF`` for an
empty row), the traceback's op codes in walk order (0=M, 1=D, 2=I,
3=inactive) and the residual (i, j) of the leading gap run.
"""

import ctypes
import os

import numpy as np
import torch

from kevlar_tpu_torch import dna, native
from kevlar_tpu_torch.ops.align import NEG_INF

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc', 'align.cu')

# Bytes of direction codes one dispatch may hold (padded [B, T+Q-1, T] for
# the plain version, which bounds the kernel's ragged sum of tlen*qlen):
# 4 GiB on an 80 GB card, where the JAX twin kept 512 MB of TPU HBM.
ZDIAG_BUDGET_BYTES = 4 << 30

# Shared memory a block takes without opting in (48 KB).  The kernel parks
# two int32 per target row between the passes of a query wider than
# ``PASS_COLUMNS``; a chunk whose longest target needs more than this keeps
# them in global memory instead.
SMEM_LIMIT_BYTES = 49152

# The kernel's schedule: a warp per pair, lane l on a strip of
# ``strip_width(qlen)`` query columns, ``LANES`` strips a pass.
LANES = 32
MAX_STRIP = 32
PASS_COLUMNS = LANES * MAX_STRIP

# Kernel launches (one per ksw_extz_cuda call: the DP and its traceback),
# for runs that must show the main path went through the kernel.
launches = 0

_lib = None


def build(force=False):
    """Compile ``csrc/align.cu`` for sm_90a; returns the library path."""
    return native.build_shared(
        'libkevlar_align.so',
        [native.nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
         '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v'],
        [SOURCE], force=force)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kt_ksw_dp.restype = ci
        lib.kt_ksw_dp.argtypes = [
            vp, vp, ci, vp, vp, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci,
            vp]
        lib.kt_ksw_traceback.restype = ci
        lib.kt_ksw_traceback.argtypes = [
            vp, vp, ci, vp, vp, vp, ci, vp, vp, vp]
        lib.kt_cuda_error_string.restype = ctypes.c_char_p
        lib.kt_cuda_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def _check(targets, tlens, queries, qlens):
    """Validate dtype, shape, contiguity, device and lengths."""
    for name, x, ndim, dtype in (('targets', targets, 2, torch.uint8),
                                 ('queries', queries, 2, torch.uint8),
                                 ('tlens', tlens, 1, torch.int32),
                                 ('qlens', qlens, 1, torch.int32)):
        if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
            raise ValueError('{} must be a contiguous {}-D {} tensor, got '
                             '{} {}'.format(name, ndim, dtype, x.dtype,
                                            tuple(x.shape)))
        if x.device != targets.device:
            raise ValueError('{} is on {}, targets on {}'.format(
                name, x.device, targets.device))
    B, T = targets.shape
    Q = queries.shape[1]
    if queries.shape[0] != B or tlens.shape[0] != B or qlens.shape[0] != B:
        raise ValueError('batch sizes differ: targets {}, queries {}, '
                         'tlens {}, qlens {}'.format(
                             B, queries.shape[0], tlens.shape[0],
                             qlens.shape[0]))
    if T < 1 or Q < 1:
        raise ValueError('padded widths must be >= 1, got T={} Q={}'.format(
            T, Q))
    if B and (int(tlens.min()) < 0 or int(tlens.max()) > T or
              int(qlens.min()) < 0 or int(qlens.max()) > Q):
        raise ValueError('lengths must lie in [0, padded width]')


def ksw_extz(targets, tlens, queries, qlens, match=1, mismatch=2, gapopen=5,
             gapextend=0):
    """Exact ksw_extz DP + traceback for a padded batch (see module doc).

    ``targets`` [B, T] and ``queries`` [B, Q] are uint8 base codes (A=0,
    C=1, G=2, T=3, other 4); ``tlens``/``qlens`` [B] int32.  On CUDA tensors
    this launches the kernel, on CPU tensors it runs the plain version."""
    kind = targets.device.type
    if kind not in ('cuda', 'cpu'):
        raise ValueError('no ksw_extz engine for device ' +
                         str(targets.device))
    _check(targets, tlens, queries, qlens)
    if kind == 'cuda':
        return ksw_extz_cuda(targets, tlens, queries, qlens, match, mismatch,
                             gapopen, gapextend)
    return ksw_extz_plain(targets, tlens, queries, qlens, match, mismatch,
                          gapopen, gapextend)


def strip_width(qlen):
    """Query columns a lane's strip holds in the kernel: the least multiple
    of 4 with which ``LANES`` strips cover ``qlen``, at most ``MAX_STRIP``
    (a wider query takes passes of ``PASS_COLUMNS`` columns).  ``qlen`` is
    an int, or an integer numpy array for a whole batch."""
    return np.clip(4 * ((qlen + 127) // 128), 4, MAX_STRIP)


def z_bytes(tlen, qlen):
    """Bytes of direction codes the kernel keeps for a pair (ints or a
    batch's int64 numpy arrays): ``tlen + 31`` steps a pass, ``LANES``
    strips of ``strip_width(qlen)`` bytes a step; 0 for an empty pair."""
    C = strip_width(qlen)
    npass = (qlen + LANES * C - 1) // (LANES * C)
    nbytes = npass * (tlen + LANES - 1) * LANES * C
    return np.where((tlen > 0) & (qlen > 0), nbytes, 0)


def z_word_index(tlen, qlen, i, j):
    """Where the kernel keeps the direction code of cell (i, j): ``(index
    of the 32-bit word in the pair's region, byte within the word)``.

    Column j lies in pass ``p = j // (LANES * C)``, in the strip of lane
    ``l``, at offset ``c`` of it; the lane computes row i at step ``s = i +
    l`` of the pass.  A pass is ``tlen + 31`` steps of ``C/4`` planes of
    ``LANES`` words: at a step, lane l's codes of columns ``4w .. 4w+3`` of
    its strip are word ``(s * C/4 + w) * LANES + l``, so that the warp's
    store of one plane is 128 consecutive bytes."""
    C = int(strip_width(qlen))
    W = C // 4
    p, jj = divmod(j, LANES * C)
    lane, c = divmod(jj, C)
    s = i + lane
    word = (p * (tlen + LANES - 1) + s) * W * LANES + (c // 4) * LANES + lane
    return word, c % 4


def ksw_extz_cuda(targets, tlens, queries, qlens, match=1, mismatch=2,
                  gapopen=5, gapextend=0, events=None):
    """Launch ``csrc/align.cu`` on the current stream: the DP kernel, then
    the traceback kernel; raises on a CUDA error.  Arguments as
    :func:`ksw_extz`, already checked.  ``events`` are three CUDA events to
    record before the DP kernel, between the two kernels and after the
    traceback kernel, for a caller that times them apart."""
    global launches
    lib = _load()
    dev = targets.device
    B, T = targets.shape
    Q = queries.shape[1]
    S = T + Q
    # the pairs' regions of the direction buffer, laid out on the host:
    # one small copy each way instead of a dozen launches and a sync
    lens = torch.stack([tlens, qlens]).cpu().numpy().astype(np.int64)
    zlen = z_bytes(lens[0], lens[1])
    zoff = torch.from_numpy(np.cumsum(zlen) - zlen).to(dev)
    z = torch.empty(max(int(zlen.sum()), 4), dtype=torch.uint8, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    ops_rev = torch.empty((B, S), dtype=torch.uint8, device=dev)
    exit_i = torch.empty(B, dtype=torch.int32, device=dev)
    exit_j = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return scores, ops_rev, exit_i, exit_j
    # edge state between passes, only where a query takes a second pass
    smem_bytes = 8 * T if Q > PASS_COLUMNS else 0
    gscratch = None
    if smem_bytes > SMEM_LIMIT_BYTES:
        gscratch = torch.empty(B * 2 * T, dtype=torch.int32, device=dev)
        smem_bytes = 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if events is not None:
            events[0].record()
        err = lib.kt_ksw_dp(
            targets.data_ptr(), tlens.data_ptr(), T, queries.data_ptr(),
            qlens.data_ptr(), Q, B, zoff.data_ptr(), z.data_ptr(),
            scores.data_ptr(),
            None if gscratch is None else gscratch.data_ptr(), smem_bytes,
            int(match), int(mismatch), int(gapopen), int(gapextend), stream)
        _raise_on(lib, 'kt_ksw_dp', err)
        if events is not None:
            events[1].record()
        err = lib.kt_ksw_traceback(
            tlens.data_ptr(), qlens.data_ptr(), B, zoff.data_ptr(),
            z.data_ptr(), ops_rev.data_ptr(), S, exit_i.data_ptr(),
            exit_j.data_ptr(), stream)
        _raise_on(lib, 'kt_ksw_traceback', err)
        if events is not None:
            events[2].record()
    launches += 1
    return scores, ops_rev, exit_i, exit_j


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError('{}: CUDA error {}: {}'.format(
            name, err, lib.kt_cuda_error_string(err).decode()))


def ksw_extz_plain(targets, tlens, queries, qlens, match=1, mismatch=2,
                   gapopen=5, gapextend=0):
    """Plain PyTorch version of the kernel, on any device: the anti-diagonal
    recurrence of ``align_ops._align_wavefront_batch`` over the padded
    batch, then the walk of ``align_ops._traceback_batch``."""
    dev = targets.device
    i32 = torch.int32
    B, T = targets.shape
    Q = queries.shape[1]
    a = int(match)
    b = int(mismatch if mismatch < 0 else -mismatch)
    gapoe = gapopen + gapextend
    gape = gapextend
    ndiag = T + Q - 1

    ii = torch.arange(T, dtype=i32, device=dev)[None, :]
    tl = tlens[:, None]
    ql = qlens[:, None]
    t = targets.to(i32)
    q = queries.to(i32)
    negcol = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)

    def shift1(v):
        """v[:, i] -> v[:, i-1], with NEG_INF entering at i = 0."""
        return torch.cat([negcol, v[:, :-1]], dim=1)

    H1 = torch.full((B, T), NEG_INF, dtype=i32, device=dev)
    H2, E1, F1 = H1.clone(), H1.clone(), H1.clone()
    score = torch.full((B,), NEG_INF, dtype=i32, device=dev)
    zdiag = torch.zeros((B, ndiag, T), dtype=torch.uint8, device=dev)
    for d in range(ndiag):
        jj = d - ii
        inb = (ii < tl) & (jj >= 0) & (jj < ql)
        hd = shift1(H2)
        hd = torch.where((ii == 0) & (jj >= 1), -(gapoe + gape * (jj - 1)),
                         hd)
        hd = torch.where((jj == 0) & (ii >= 1), -(gapoe + gape * (ii - 1)),
                         hd)
        hd = torch.where((ii == 0) & (jj == 0), 0, hd)
        e = torch.maximum(shift1(E1) - gape, shift1(H1) - gapoe)
        e = torch.where(ii == 0, -(gapoe + gapoe + gape * jj), e)
        f = torch.maximum(F1 - gape, H1 - gapoe)
        f = torch.where(jj == 0, -(gapoe + gapoe + gape * ii), f)
        qd = q.gather(1, jj.clamp(0, Q - 1).to(torch.int64).expand(B, T))
        sub = torch.where((t >= 4) | (qd >= 4), 0,
                          torch.where(t == qd, a, b))
        hdiag = hd + sub
        code = torch.where(hdiag >= e, 0, 1)
        h = torch.maximum(hdiag, e)
        code = torch.where(h >= f, code, 2)
        h = torch.maximum(h, f)
        hh = h - gapoe
        code = code | (((e - gape) > hh).to(i32) << 3)
        code = code | (((f - gape) > hh).to(i32) << 4)
        zdiag[:, d, :] = torch.where(inb, code, 0).to(torch.uint8)
        h = torch.where(inb, h, NEG_INF)
        e = torch.where(inb, e, NEG_INF)
        f = torch.where(inb, f, NEG_INF)
        is_final = (ii == tl - 1) & (jj == ql - 1)
        score = torch.where(is_final.any(1),
                            torch.where(is_final, h, NEG_INF).amax(1), score)
        H2, H1, E1, F1 = H1, h, e, f

    rows = torch.arange(B, device=dev)
    i = tlens.to(torch.int64) - 1
    j = qlens.to(torch.int64) - 1
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    done = (tlens <= 0) | (qlens <= 0)
    ops_rev = torch.full((B, T + Q), 3, dtype=torch.uint8, device=dev)
    nsteps = int((tlens + qlens).max()) if B else 0
    for step in range(nsteps):
        active = ~done
        ic = i.clamp(min=0)
        jc = j.clamp(min=0)
        code = zdiag[rows, ic + jc, ic].to(torch.int64)
        cont = (code >> (state + 2)) & 1
        s1 = torch.where(state == 0, code & 7,
                         torch.where(cont == 0, 0, state))
        s2 = torch.where(s1 == 0, code & 7, s1)
        ops_rev[:, step] = torch.where(active, s2, 3).to(torch.uint8)
        di = ((s2 == 0) | (s2 == 1)).to(torch.int64)
        dj = ((s2 == 0) | (s2 == 2)).to(torch.int64)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        done = done | (i < 0) | (j < 0)
        state = s2
    return score, ops_rev, i.to(i32), j.to(i32)


_OPCHARS = 'MDI'


def _cigars_from_ops_batch(ops_np, exit_i_np, exit_j_np):
    """Vectorised host assembly of a whole batch's CIGARs (a copy of
    ``kevlar_tpu.ops.align_ops._cigars_from_ops_batch``).

    Run-length encodes each row with numpy (op codes are monotone-inactive
    after the walk ends, so the first ``3`` bounds the row) and only loops
    Python over *runs* (a CIGAR has a handful) instead of *steps* (T+Q per
    pair)."""
    B, S = ops_np.shape
    exit_i_np = np.asarray(exit_i_np)
    exit_j_np = np.asarray(exit_j_np)
    # one global RLE over the row-flattened matrix (a 255 sentinel column
    # separates rows); Python then only touches real runs, of which a
    # CIGAR has a handful
    padded = np.concatenate(
        [ops_np, np.full((B, 1), 255, np.uint8)], axis=1).ravel()
    cuts = np.flatnonzero(padded[1:] != padded[:-1]) + 1
    starts = np.concatenate(([0], cuts))
    ends = np.concatenate((cuts, [padded.size]))
    vals = padded[starts]
    keep = vals < 3                       # drop inactive tails + sentinels
    starts, ends, vals = starts[keep], ends[keep], vals[keep]
    rows = starts // (S + 1)
    counts = ends - starts
    run_of_row = np.split(np.arange(starts.size),
                          np.searchsorted(rows, np.arange(1, B)))
    out = []
    for b in range(B):
        parts = [[_OPCHARS[vals[r]], int(counts[r])] for r in run_of_row[b]]
        ei = int(exit_i_np[b])
        ej = int(exit_j_np[b])
        if ei >= 0:
            if parts and parts[-1][0] == 'D':
                parts[-1][1] += ei + 1
            else:
                parts.append(['D', ei + 1])
        if ej >= 0:
            if parts and parts[-1][0] == 'I':
                parts[-1][1] += ej + 1
            else:
                parts.append(['I', ej + 1])
        parts.reverse()
        out.append(''.join('{}{}'.format(n, c) for c, n in parts))
    return out


def _chunks(tlens, qlens, budget):
    """Index lists that split a batch for dispatch: pairs sorted by target
    length (longest first), a new chunk whenever the target length halves
    (so short pairs do not pay a long pair's padding) or the direction
    codes would outgrow ``budget``: the plain version's padded [B, T+Q-1,
    T] tensor, or the kernel's :func:`z_bytes` a pair, whichever is
    larger."""
    chunk = []
    tmax = qmax = 0
    for k in np.argsort(-tlens, kind='stable'):
        t = max(int(tlens[k]), 1)
        q = max(int(qlens[k]), 1)
        nq = max(qmax, q)
        if chunk and (2 * t < tmax or (len(chunk) + 1) * max(
                (tmax + nq - 1) * tmax, int(z_bytes(tmax, nq))) > budget):
            yield chunk
            chunk, tmax, nq = [], 0, q
        chunk.append(int(k))
        tmax, qmax = max(tmax, t), nq
    if chunk:
        yield chunk


def align_batch(target_seqs, query_seqs, match=1, mismatch=2, gapopen=5,
                gapextend=0, device='cuda'):
    """Align many (target, query) string pairs with exact ksw2 semantics on
    ``device``; returns ``[(cigar, score), ...]`` in input order."""
    B = len(target_seqs)
    if len(query_seqs) != B:
        raise ValueError('{} targets but {} queries'.format(
            B, len(query_seqs)))
    device = torch.device(device)
    tl_all = np.array([len(s) for s in target_seqs], dtype=np.int64)
    ql_all = np.array([len(s) for s in query_seqs], dtype=np.int64)
    results = [None] * B
    for idx in _chunks(tl_all, ql_all, ZDIAG_BUDGET_BYTES):
        T = max(int(tl_all[idx].max()), 1)
        Q = max(int(ql_all[idx].max()), 1)
        targets, tlens = dna.encode_batch([target_seqs[k] for k in idx],
                                          pad_to=T)
        queries, qlens = dna.encode_batch([query_seqs[k] for k in idx],
                                          pad_to=Q)
        scores, ops_rev, exit_i, exit_j = ksw_extz(
            torch.from_numpy(targets).to(device),
            torch.from_numpy(tlens).to(device),
            torch.from_numpy(queries).to(device),
            torch.from_numpy(qlens).to(device),
            match=match, mismatch=mismatch, gapopen=gapopen,
            gapextend=gapextend)
        cigars = _cigars_from_ops_batch(ops_rev.cpu().numpy(),
                                        exit_i.cpu().numpy(),
                                        exit_j.cpu().numpy())
        for k, cigar, score in zip(idx, cigars, scores.cpu().tolist()):
            results[k] = (cigar, score)
    return results
