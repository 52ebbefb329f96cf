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
    NEG_INF, align_both_strands, align_both_strands_batch, align_scalar)

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
