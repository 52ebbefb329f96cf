"""Batched trio likelihood scoring on the device: (call, k-mer, scenario)
tensors (B8).

The ``simlike`` likelihood model (reference kevlar/simlike.py:99-191)
evaluated for every call at once: per-k-mer genotype log-probabilities
(log-binomial via ``lgamma`` for absent, normal logpdf for het/hom), the
three composite likelihoods, and the 11-scenario inheritance max, over an
``[N, K]`` bundle tensor with a mask for the k-mers each call lacks.

A port of ``kevlar_tpu.ops.simlike_ops``, in float32 as there: the host
functions of :mod:`kevlar_tpu_torch.simlike` remain the golden reference
(exact float64 ``math.lgamma``), and this path, opt-in through
``KEVLAR_SIMLIKE_DEVICE=1``, agrees with them to ~1e-6 relative.
Elementwise ops and small reductions, so plain torch: no hand kernel.
"""

from math import log, pi

import numpy as np
import torch

# (child, mother, father) genotype index per inheritance scenario
# (reference simlike.py:162-191; same order as simlike.INHERITANCE_SCENARIOS)
_SCENARIOS = np.array([
    (1, 0, 1), (1, 0, 2),
    (1, 1, 0), (1, 1, 1), (1, 1, 2),
    (1, 2, 0), (1, 2, 1),
    (2, 1, 1), (2, 1, 2),
    (2, 2, 1), (2, 2, 2),
], dtype=np.int64)

# calls of _score_bundles (each one pass of torch ops over the bundles)
launches = 0


def _lp_abs(a, refrc, mean, error):
    """Genotype-0 (absent) log-binomial; refrc == 0 means INDEL mode
    (refrabund=1, error*0.01) — reference simlike.py:115-128.  This holds
    for an SNV k-mer whose reference copy number is 0, too."""
    indel = refrc == 0
    r = torch.where(indel, torch.ones_like(refrc), refrc)
    err = torch.where(indel, torch.full_like(refrc, error * 0.01),
                      torch.full_like(refrc, error))
    sm = mean * r
    ac = torch.minimum(a, sm)
    nck = (torch.lgamma(sm + 1.0) - torch.lgamma(ac + 1.0)
           - torch.lgamma(sm - ac + 1.0))
    return nck + ac * torch.log(err) + (sm - ac) * torch.log1p(-err)


def _lp_norm(a, mu, sd):
    z = (a - mu) / sd
    return -0.5 * z * z - log(sd) - 0.5 * log(2.0 * pi)


def _score_bundles(case, ctrls, refrc, mask, mean, sd, error):
    """case [N,K]; ctrls [C,N,K]; refrc [N,K] (0 = indel mode);
    mask [N,K] bool -> (lldn, llfp, llih) each [N] float32."""
    global launches
    launches += 1
    m = mask.to(case.dtype)
    nonempty = m.sum(-1) > 0

    # LLDN: case het + every control absent (simlike.py:135-148)
    lldn = (_lp_norm(case, mean / 2, sd / 2) * m).sum(-1)
    abs_ctrl = (_lp_abs(ctrls, refrc[None], mean, error) * m[None]).sum(-1)
    lldn = lldn + abs_ctrl.sum(0)
    lldn = torch.where(nonempty, lldn, torch.zeros_like(lldn))

    # LLFP: all samples absent (simlike.py:151-159)
    llfp = (_lp_abs(case, refrc, mean, error) * m).sum(-1) + abs_ctrl.sum(0)
    llfp = torch.where(nonempty, llfp, torch.zeros_like(llfp))

    # LLIH: per-k-mer max over the 11 scenarios; the inheritance scan
    # never passes refrabund (INDEL mode everywhere, simlike.py:162-191)
    people = torch.cat([case[None], ctrls], 0)  # [3, N, K]
    zero_refr = torch.zeros_like(refrc)
    lp = torch.stack([
        _lp_abs(people, zero_refr[None], mean, error),
        _lp_norm(people, mean / 2, sd / 2),
        _lp_norm(people, mean, sd),
    ], 1)  # [3 people, 3 genotypes, N, K]
    scen = torch.from_numpy(_SCENARIOS).to(case.device)
    totals = (lp[0, scen[:, 0]] + lp[1, scen[:, 1]] + lp[2, scen[:, 2]]
              + log(1.0 / 15.0))  # [S, N, K]
    best = totals.max(0).values  # [N, K]
    prior = log(15.0 / 11.0)
    llih = (best * m).sum(-1) + prior
    llih = torch.where(nonempty, llih, torch.full_like(llih, prior))
    return lldn, llfp, llih


def bundle_tensors(bundles, device='cuda'):
    """``(case [N, K], ctrls [2, N, K], refrc [N, K], mask [N, K])`` of
    trio bundles on ``device``, K the longest bundle (at least 1);
    ``refrc`` is 0 where a bundle has no reference copy number."""
    N = len(bundles)
    K = max(max((len(b.case) for b in bundles), default=1), 1)
    case = np.zeros((N, K), np.float32)
    ctrls = np.zeros((2, N, K), np.float32)
    refrc = np.zeros((N, K), np.float32)
    mask = np.zeros((N, K), bool)
    for i, b in enumerate(bundles):
        k = len(b.case)
        if k == 0:
            continue
        case[i, :k] = b.case
        for c in range(2):
            ctrls[c, i, :k] = b.controls[c]
        refrc[i, :k] = [0.0 if x is None else float(x)
                        for x in b.refrcopies]
        mask[i, :k] = True
    return tuple(torch.from_numpy(x).to(device)
                 for x in (case, ctrls, refrc, mask))


def score_bundles(bundles, mean=30.0, sd=8.0, error=0.001, device='cuda'):
    """Score a list of ``_AbundanceBundle``s on ``device`` in one pass.

    Trio-shaped bundles only (two controls — the inheritance model is
    trio-specific, like the reference's).  Returns float lists
    (lldn, llfp, llih) aligned with ``bundles``.
    """
    if not bundles:
        return [], [], []
    out = _score_bundles(*bundle_tensors(bundles, device), float(mean),
                         float(sd), float(error))
    return tuple(x.cpu().tolist() for x in out)
