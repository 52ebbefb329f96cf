"""The port's batched ksw2 aligner against the JAX package.

Tolerance: none.  The DP is integer arithmetic, so scores, CIGARs, op
streams and exit cells must be identical.  On the CPU the port's wrapper
runs the plain PyTorch version of the kernel; the CUDA kernel itself is
checked against that plain version by the ``cuda``-marked tests
(skipped without a card) and by ``chip_smoke.py`` on the GPU.

The JAX package is imported inside the tests that compare with it, so the
``cuda`` tests also run where JAX is absent (the machine with the card):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_align.py
"""

import numpy as np
import pytest
import torch

from kevlar_tpu_torch import dna
from kevlar_tpu_torch.ops import align_cuda
from kevlar_tpu_torch.ops.align import (
    NEG_INF, align, align_both_strands, align_both_strands_batch,
    align_numpy, align_scalar)

GAPS = [(5, 0), (5, 2), (3, 1)]


def _rand(rng, n, nfrac=0.0):
    seq = np.frombuffer(b'ACGT', np.uint8)[rng.integers(0, 4, n)].copy()
    seq[rng.random(n) < nfrac] = ord('N')
    return seq.tobytes().decode()


def _pairs(seed, n, tmax, qmax):
    """Seeded pairs: a query cut from its target and edited (SNVs, N,
    short indels), unrelated pairs, and tandem repeats with a unit
    dropped (equal-score placements that only the tie-breaks decide)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        tlen = int(rng.integers(tmax // 2, tmax + 1))
        t = _rand(rng, tlen, nfrac=0.02)
        if k % 4 == 3:
            pairs.append((t, _rand(rng, int(rng.integers(1, qmax + 1)))))
            continue
        qlen = int(rng.integers(qmax // 2, min(qmax, tlen) + 1))
        start = int(rng.integers(0, tlen - qlen + 1))
        q = list(t[start:start + qlen])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(q)))
            edit = int(rng.integers(0, 3))
            if edit == 0:
                q[p] = 'ACGTN'[int(rng.integers(0, 5))]
            elif edit == 1:
                q[p:p] = _rand(rng, int(rng.integers(1, 8)))
            else:
                del q[p:p + int(rng.integers(1, 8))]
        pairs.append((t, ''.join(q) or 'A'))
    for unit, copies, drop in (('A', 12, 2), ('AC', 8, 1), ('GTT', 5, 2)):
        left, right = _rand(rng, 20), _rand(rng, 20)
        pairs.append((left + unit * copies + right,
                      left + unit * (copies - drop) + right))
    return pairs


def _plain(pairs, gapopen, gapextend):
    return align_cuda.align_batch([p[0] for p in pairs],
                                  [p[1] for p in pairs], gapopen=gapopen,
                                  gapextend=gapextend, device='cpu')


@pytest.mark.parametrize('gapopen,gapextend', GAPS)
def test_plain_matches_pallas_kernel(gapopen, gapextend):
    """The Pallas kernel in interpret mode, as tests/test_align_pallas.py
    runs it: 16 pairs of length <= 256."""
    from kevlar_tpu.ops.align_pallas import align_batch_pallas
    pairs = _pairs(11 + gapopen + gapextend, 13, 256, 200)
    assert len(pairs) == 16
    want = align_batch_pallas([p[0] for p in pairs], [p[1] for p in pairs],
                              gapopen=gapopen, gapextend=gapextend,
                              interpret=True)
    assert _plain(pairs, gapopen, gapextend) == want


@pytest.mark.parametrize('gapopen,gapextend', GAPS)
def test_plain_matches_scalar_and_xla_wavefront(gapopen, gapextend):
    from kevlar_tpu.ops import align_ops as jax_align_ops
    pairs = _pairs(23 + gapopen, 10, 90, 70)
    got = _plain(pairs, gapopen, gapextend)
    assert got == [align_scalar(t, q, gapopen=gapopen, gapextend=gapextend)
                   for t, q in pairs]
    assert got == jax_align_ops.align_batch(
        [p[0] for p in pairs], [p[1] for p in pairs], gapopen=gapopen,
        gapextend=gapextend)


def test_plain_matches_xla_wavefront_above_512():
    """Lengths above the Pallas kernel's 512 cap (the port has none)."""
    from kevlar_tpu.ops import align_ops as jax_align_ops
    pairs = _pairs(5, 3, 700, 560) + [(_rand(np.random.default_rng(2), 530),
                                       'ACGTTGCA' * 15)]
    got = _plain(pairs, 5, 2)
    assert max(len(t) for t, _ in pairs) > 512
    assert got == jax_align_ops.align_batch(
        [p[0] for p in pairs], [p[1] for p in pairs], gapopen=5,
        gapextend=2)
    assert got[-1] == align_scalar(*pairs[-1], gapopen=5, gapextend=2)


def test_plain_tensors_match_xla_wavefront_and_traceback():
    """Tensor level, with empty rows: a length-0 target or query scores
    NEG_INF and its walk is inactive from the start."""
    from kevlar_tpu import dna as jax_dna
    from kevlar_tpu.ops import align_ops as jax_align_ops
    pairs = _pairs(8, 5, 60, 50) + [('', 'ACGT'), ('ACGTAC', ''), ('', '')]
    T, Q = 64, 64
    targets, tlens = jax_dna.encode_batch([p[0] for p in pairs], pad_to=T)
    queries, qlens = jax_dna.encode_batch([p[1] for p in pairs], pad_to=Q)
    scores, zdiag = jax_align_ops._align_wavefront_batch(
        targets, tlens, queries, qlens, T=T, Q=Q, gapopen=3, gapextend=1)
    ops_rev, exit_i, exit_j = jax_align_ops._traceback_batch(
        zdiag, tlens, qlens, T=T, Q=Q)
    got = align_cuda.ksw_extz(
        torch.from_numpy(targets), torch.from_numpy(tlens),
        torch.from_numpy(queries), torch.from_numpy(qlens), gapopen=3,
        gapextend=1)
    for mine, theirs in zip(got, (scores, ops_rev, exit_i, exit_j)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert (got[0][-3:] == NEG_INF).all()
    assert (got[1][-3:] == 3).all()


def test_both_strand_tie_keeps_forward():
    from kevlar_tpu.dna import revcom as jax_revcom
    from kevlar_tpu.ops import align as jax_align
    rng = np.random.default_rng(3)
    target = _rand(rng, 120)
    palindrome = 'ACGTTAACGT'          # its own reverse complement
    pairs = [(target, target[30:90]),                        # forward wins
             (target, jax_revcom(target[20:100])),        # reverse wins
             (target[:40] + palindrome + target[40:], palindrome),  # tie
             ('ACGTACGT', 'ACGTACGT'[::-1])]
    got = align_both_strands_batch(pairs, device='cpu')
    want = [jax_align.align_both_strands(t, q) for t, q in pairs]
    assert got == want
    assert [align_both_strands(t, q) for t, q in pairs] == want
    assert got[0][2] == 1 and got[1][2] == -1 and got[2][2] == 1
    assert got[2][0] == align_scalar(pairs[2][0], palindrome)[1]


@pytest.mark.parametrize('gapopen,gapextend', GAPS)
def test_single_pair_aligner_matches_jax_native(gapopen, gapextend,
                                                monkeypatch):
    """``ops.align.align`` (the C++ copy, ``native.align``) and
    ``align_both_strands`` against ``kevlar_tpu``'s native aligner, and
    against the numpy wavefront, their plain twin."""
    import time
    from kevlar_tpu import native as jax_native
    from kevlar_tpu.ops import align as jax_align
    deadline = time.time() + 300
    while jax_native.load() is None:      # another worker may be building
        assert time.time() < deadline, 'kevlar_tpu native library missing'
        time.sleep(2)
    monkeypatch.setattr(jax_align, 'align', jax_native.align)
    pairs = _pairs(31 + gapopen + gapextend, 24, 300, 200)
    for t, q in pairs:
        kw = dict(gapopen=gapopen, gapextend=gapextend)
        got = align(t, q, **kw)
        assert got == jax_native.align(t, q, **kw)
        assert got == align_numpy(t, q, 1, 2, gapopen, gapextend)
        assert align_both_strands(t, q, **kw) == \
            jax_align.align_both_strands(t, q, **kw)


def test_cigar_rle_matches_jax():
    from kevlar_tpu.ops import align_ops as jax_align_ops
    rng = np.random.default_rng(17)
    B, S = 40, 50
    ops = rng.integers(0, 3, (B, S)).astype(np.uint8)
    for b, stop in enumerate(rng.integers(0, S + 1, B)):
        ops[b, stop:] = 3                # walks end at different steps
    # runs that meet the leading gap run, and all-inactive rows
    ops[0, :] = 3
    ops[1, :5] = 1
    ops[1, 5:] = 3
    exit_i = rng.integers(-1, 4, B)
    exit_j = rng.integers(-1, 4, B)
    got = align_cuda._cigars_from_ops_batch(ops, exit_i, exit_j)
    assert got == jax_align_ops._cigars_from_ops_batch(ops, exit_i, exit_j)
    assert got == [jax_align_ops._cigar_from_ops(ops[b], exit_i[b],
                                                 exit_j[b])
                   for b in range(B)]


def test_chunked_dispatch_keeps_order(monkeypatch):
    """A tiny direction budget splits the batch into many chunks (and the
    halving rule splits it by target length); results stay in input
    order and identical."""
    pairs = _pairs(31, 12, 80, 60) + [('ACGTTGACCA' * 30, 'ACGTTGACCA')]
    whole = _plain(pairs, 5, 0)
    chunks = list(align_cuda._chunks(
        np.array([len(t) for t, _ in pairs]),
        np.array([len(q) for _, q in pairs]), 20000))
    assert len(chunks) > 3
    assert sorted(k for c in chunks for k in c) == list(range(len(pairs)))
    monkeypatch.setattr(align_cuda, 'ZDIAG_BUDGET_BYTES', 20000)
    assert _plain(pairs, 5, 0) == whole


def test_wrapper_checks_its_inputs():
    t = torch.zeros((2, 8), dtype=torch.uint8)
    tl = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match='targets'):
        align_cuda.ksw_extz(t.to(torch.int32), tl, t, tl)
    with pytest.raises(ValueError, match='contiguous'):
        align_cuda.ksw_extz(t.t(), tl, t, tl)
    with pytest.raises(ValueError, match='batch sizes'):
        align_cuda.ksw_extz(t, tl, t[:1], tl[:1])
    with pytest.raises(ValueError, match='lengths'):
        align_cuda.ksw_extz(t, tl + 1, t, tl)
    with pytest.raises(ValueError, match='no ksw_extz engine'):
        align_cuda.ksw_extz(t.to('meta'), tl.to('meta'), t.to('meta'),
                            tl.to('meta'))
    launches = align_cuda.launches
    align_cuda.ksw_extz(t, tl, t, tl)
    assert align_cuda.launches == launches   # CPU tensors: plain version


def _emulate_kernel(tcodes, qcodes, match=1, mismatch=2, gapopen=5,
                    gapextend=0):
    """The schedule of ``csrc/align.cu`` for one pair, in Python integers,
    with the wrapper's constants: a DP by 32 lanes, lane l on a strip of
    ``strip_width(qlen)`` columns and one row behind lane l-1, H - gapoe and
    F - gape handed to the right neighbour a step later, passes of 32
    strips with the right edge parked per row, the direction codes stored
    where the kernel stores them; then the traceback over 8-row x 4-word
    tiles addressed by ``z_word_index``.  Returns (score, ops, exit_i,
    exit_j)."""
    NEG = int(NEG_INF)
    tlen, qlen = len(tcodes), len(qcodes)
    if tlen == 0 or qlen == 0:
        return NEG, [], tlen - 1, qlen - 1
    a, b = match, (mismatch if mismatch < 0 else -mismatch)
    gapoe, gape = gapopen + gapextend, gapextend
    lanes = align_cuda.LANES
    C = align_cuda.strip_width(qlen)
    W = C // 4
    npass = -(-qlen // (lanes * C))
    nsteps = tlen + lanes - 1
    z = bytearray(align_cuda.z_bytes(tlen, qlen))
    assert len(z) == npass * nsteps * W * lanes * 4
    sub_of = {True: a + gapoe, False: b + gapoe}
    edge_h, edge_f = [None] * tlen, [None] * tlen
    score = NEG
    for p in range(npass):
        j0 = [(p * lanes + l) * C for l in range(lanes)]
        hh = [[-(gapoe + gape * (j0[l] + c)) - gapoe for c in range(C)]
              for l in range(lanes)]
        e1 = [[NEG] * C for _ in range(lanes)]
        diag = [(0 if j0[l] == 0 else -(gapoe + gape * (j0[l] - 1))) - gapoe
                for l in range(lanes)]
        out = [(0, 0)] * lanes                 # what each lane hands on
        zbase = p * nsteps * W * lanes
        for s in range(nsteps):
            handed = [None] + out[:-1]         # the shuffle, before any
            new_out = list(out)                # lane writes this step
            for l in range(lanes):
                i = s - l
                if j0[l] >= qlen or not 0 <= i < tlen:
                    continue
                if l == 0:
                    hl, fl = ((-(gapoe + gape * i) - gapoe, NEG) if p == 0
                              else (edge_h[i], edge_f[i]))
                else:
                    hl, fl = handed[l]
                tc = tcodes[i]
                hd, diag[l] = diag[l], hl
                hleft, f1 = hl, fl
                for c in range(C):
                    j = j0[l] + c
                    qc = qcodes[j] if j < qlen else 4
                    sub = gapoe if tc >= 4 or qc >= 4 else sub_of[tc == qc]
                    hdiag = hd + sub
                    up = hh[l][c]
                    e = max(e1[l][c], up)
                    f = max(f1, hleft)
                    code = 0 if hdiag >= e else 1
                    h = max(hdiag, e)
                    code = code if h >= f else 2
                    h = max(h, f)
                    hcur, en, fn = h - gapoe, e - gape, f - gape
                    code |= (8 if en > hcur else 0) | (16 if fn > hcur else 0)
                    z[4 * (zbase + (s * W + c // 4) * lanes + l) + c % 4] = \
                        code
                    hd, hh[l][c], e1[l][c], hleft, f1 = up, hcur, en, hcur, fn
                new_out[l] = (hleft, f1)
                if l == lanes - 1 and p + 1 < npass:
                    edge_h[i], edge_f[i] = hleft, f1
            out = new_out
        for l in range(lanes):
            if j0[l] <= qlen - 1 < j0[l] + C:
                score = hh[l][qlen - 1 - j0[l]] + gapoe

    i, j, state, ops = tlen - 1, qlen - 1, 0, []
    while i >= 0 and j >= 0:
        i0, w0 = i, j >> 2
        tile = {}
        for r in range(lanes):                 # one load, a word a lane
            ri, wq = i0 - (r >> 2), w0 - (r & 3)
            if ri >= 0 and wq >= 0:
                word, byte = align_cuda.z_word_index(tlen, qlen, ri, 4 * wq)
                assert byte == 0
                tile[r] = z[4 * word:4 * word + 4]
        r, cw, jb = 0, 0, j & 3               # rows above i0, words left
        while True:
            code = tile[(r << 2) | cw][jb]
            # a gap state goes on while its continuation bit is set (state
            # 0 reads bit 2, which no code has)
            if not (code >> (state + 2)) & 1:
                state = code & 7
            ops.append(state)
            di, dj = state != 2, state != 1
            i, r, j, jb = i - di, r + di, j - dj, jb - dj
            if jb < 0:
                jb, cw = 3, cw + 1
            if not (r < 8 and cw < 4 and i >= 0 and j >= 0):
                break
    return score, ops, i, j


def _emulation_cases():
    rng = np.random.default_rng(77)
    cases = {
        'ragged': _pairs(61, 9, 70, 60),
        'ties': [p for p in _pairs(62, 1, 50, 40)[-3:]] +
                [('AAAAAAAAAACCCC', 'AAAAAAACCCC'), ('ACACACACAC', 'ACACAC')],
        'narrow': [(_rand(rng, 40), 'ACG'), (_rand(rng, 9), 'A'),
                   ('ACGTACGTAC', 'ACGTTACG')],
        'odd-width': [(_rand(rng, 60), _rand(rng, 131)),
                      (_rand(rng, 45, 0.05), _rand(rng, 257, 0.05))],
        'two-passes': [(_rand(rng, 37), _rand(rng, 1030)),
                       (_rand(rng, 20, 0.1), _rand(rng, 2051, 0.02))],
        'one-row': [('A', 'ACGT'), ('G', _rand(rng, 150)), ('N', 'N')],
    }
    t = _rand(rng, 90)
    cases['two-passes'].append((t[:40], t[:15] + _rand(rng, 1100) + t[15:40]))
    return cases


@pytest.mark.parametrize('case', sorted(_emulation_cases()))
@pytest.mark.parametrize('gapopen,gapextend', GAPS)
def test_kernel_schedule_emulation_matches_plain(case, gapopen, gapextend):
    """The kernel's schedule and direction layout, emulated in Python
    integers, against the plain version: scores, op streams and exit cells
    identical on ragged pairs, tie pairs, qlen < C, qlen not a multiple of
    C, qlen > 32 C, tlen = 1 and empty rows."""
    pairs = _emulation_cases()[case] + [('', 'ACGT'), ('ACGT', '')]
    targets, tlens = dna.encode_batch([p[0] for p in pairs])
    queries, qlens = dna.encode_batch([p[1] for p in pairs])
    scores, ops_rev, exit_i, exit_j = (x.numpy() for x in align_cuda.ksw_extz(
        *(torch.from_numpy(x) for x in (targets, tlens, queries, qlens)),
        gapopen=gapopen, gapextend=gapextend))
    for n in range(len(pairs)):
        got = _emulate_kernel(targets[n, :tlens[n]].tolist(),
                              queries[n, :qlens[n]].tolist(),
                              gapopen=gapopen, gapextend=gapextend)
        walk = ops_rev[n][ops_rev[n] < 3].tolist()
        assert got == (int(scores[n]), walk, int(exit_i[n]), int(exit_j[n]))


def test_kernel_schedule_emulation_matches_jax():
    """The same emulation against ``kevlar_tpu``'s aligner as its own tests
    run it on the CPU: the XLA wavefront, and the Pallas kernel in interpret
    mode (CIGARs and scores)."""
    from kevlar_tpu.ops import align_ops as jax_align_ops
    from kevlar_tpu.ops.align_pallas import align_batch_pallas
    pairs = _pairs(63, 5, 120, 100) + _emulation_cases()['narrow']
    targets, tlens = dna.encode_batch([p[0] for p in pairs])
    queries, qlens = dna.encode_batch([p[1] for p in pairs])
    got = []
    for n in range(len(pairs)):
        score, ops, ei, ej = _emulate_kernel(
            targets[n, :tlens[n]].tolist(), queries[n, :qlens[n]].tolist(),
            gapopen=5, gapextend=2)
        row = np.full((1, tlens[n] + qlens[n]), 3, np.uint8)
        row[0, :len(ops)] = ops
        got.append((align_cuda._cigars_from_ops_batch(
            row, np.array([ei]), np.array([ej]))[0], score))
    ts, qs = [p[0] for p in pairs], [p[1] for p in pairs]
    assert got == jax_align_ops.align_batch(ts, qs, gapopen=5, gapextend=2)
    assert got == align_batch_pallas(ts, qs, gapopen=5, gapextend=2,
                                     interpret=True)


def test_direction_layout_is_a_bijection_and_coalesced():
    """``z_word_index`` sends the cells of a pair to distinct bytes inside
    ``z_bytes``, and the 32 lanes' words of one step and plane are 128
    consecutive bytes; ``strip_width`` and ``z_bytes`` agree on arrays
    and ints."""
    for tlen, qlen in ((7, 1), (5, 129), (3, 1024), (4, 1025), (2, 2100)):
        C = align_cuda.strip_width(qlen)
        assert C % 4 == 0 and 4 <= C <= 32
        assert 32 * C >= min(qlen, 1024) and (C == 4 or 32 * (C - 4) < qlen)
        seen = set()
        for i in range(tlen):
            for j in range(qlen):
                word, byte = align_cuda.z_word_index(tlen, qlen, i, j)
                seen.add(4 * word + byte)
        assert len(seen) == tlen * qlen
        assert max(seen) < align_cuda.z_bytes(tlen, qlen)
        # step s = 3 of pass 0: lane l is on row 3 - l
        words = [align_cuda.z_word_index(tlen + 40, qlen, 3 - l, l * C)[0]
                 for l in range(min(4, -(-qlen // C)))]
        assert words == list(range(words[0], words[0] + len(words)))
    tl = np.array([7, 0, 4, 5], dtype=np.int64)
    ql = np.array([1, 9, 1025, 0], dtype=np.int64)
    assert align_cuda.strip_width(ql).tolist() == [
        align_cuda.strip_width(int(q)) for q in ql]
    assert align_cuda.z_bytes(tl, ql).tolist() == [
        align_cuda.z_bytes(int(t), int(q)) for t, q in zip(tl, ql)]
    assert align_cuda.z_bytes(0, 9) == 0 and align_cuda.z_bytes(5, 0) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('gapopen,gapextend', GAPS)
def test_kernel_matches_plain_on_card(cuda_device, gapopen, gapextend):
    pairs = _pairs(41, 40, 1500, 900) + [('', 'ACGT'), ('ACGT', '')]
    targets, tlens = dna.encode_batch([p[0] for p in pairs])
    queries, qlens = dna.encode_batch([p[1] for p in pairs])
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (targets, tlens, queries, qlens)]
    launches = align_cuda.launches
    got = align_cuda.ksw_extz(*args, gapopen=gapopen, gapextend=gapextend)
    torch.cuda.synchronize()
    assert align_cuda.launches == launches + 1
    want = align_cuda.ksw_extz_plain(*args, gapopen=gapopen,
                                     gapextend=gapextend)
    for mine, ref in zip(got, want):
        assert torch.equal(mine, ref)


@pytest.mark.cuda
def test_kernel_align_batch_matches_scalar_on_card(cuda_device):
    pairs = _pairs(43, 6, 90, 70)
    got = align_cuda.align_batch([p[0] for p in pairs],
                                 [p[1] for p in pairs], gapopen=5,
                                 gapextend=2, device=cuda_device)
    assert got == [align_scalar(t, q, gapopen=5, gapextend=2)
                   for t, q in pairs]
    assert align_both_strands_batch(pairs, device=cuda_device) == \
        align_both_strands_batch(pairs, device='cpu')


@pytest.mark.cuda
def test_kernel_multi_pass_matches_plain_on_card(cuda_device):
    """Queries wider than one pass of the kernel (edge state in shared
    memory), a target long enough to move it to global memory, and strips
    of every width."""
    rng = np.random.default_rng(47)
    t = _rand(rng, 1400)
    pairs = [(t[:300], t[:100] + _rand(rng, 1100) + t[100:300]),
             (_rand(rng, 200), _rand(rng, 2500))]
    pairs += [(_rand(rng, 150), _rand(rng, q)) for q in range(3, 1100, 97)]
    for chunk in (pairs, pairs[:2] + [(_rand(rng, 7000), t[:1300])]):
        targets, tlens = dna.encode_batch([p[0] for p in chunk])
        queries, qlens = dna.encode_batch([p[1] for p in chunk])
        args = [torch.from_numpy(x).to(cuda_device)
                for x in (targets, tlens, queries, qlens)]
        # the second scoring is too wide for the kernel's byte lookup
        for kw in (dict(gapopen=5, gapextend=1),
                   dict(match=3, mismatch=300, gapopen=260, gapextend=1)):
            got = align_cuda.ksw_extz(*args, **kw)
            torch.cuda.synchronize()
            want = align_cuda.ksw_extz_plain(*args, **kw)
            for mine, ref in zip(got, want):
                assert torch.equal(mine, ref)
