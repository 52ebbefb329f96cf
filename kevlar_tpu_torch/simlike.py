"""``simlike`` stage: trio likelihood scoring of variant calls.

Port of ``kevlar_tpu.simlike`` (a copy with the imports rewritten).
``KEVLAR_SIMLIKE_BATCH=1`` gathers every call's window counts in a few
``Sketch.query_batch`` calls on the device (K1, K2) instead of per-call host
gathers, and ``KEVLAR_SIMLIKE_DEVICE=1`` adds float32 scoring on the device
(:mod:`kevlar_tpu_torch.ops.simlike_ops`); both are off by default, but the
batched gather is on by itself when a sketch is mesh-sharded
(:class:`kevlar_tpu_torch.parallel.ShardedSketch`), as in ``kevlar_tpu``.
For each call, the abundances of every variant-spanning (ALTWINDOW) k-mer in
case/controls form a columnar bundle (k-mers already present in the
reference genome are masked out); three log-likelihood models score the
bundle and LIKESCORE = LLDN - max(LLFP, LLIH):

- genotype 0 -> log-binomial(scaledmean = mean*refrabund, error); indels
  use refrabund=1 and error*0.01; abundance clamped at scaledmean; log
  C(n,k) via lgamma (exact for integral n, well-defined for fractional
  scaled means where scipy's exact-mode comb silently floors)
- genotype 1 -> Normal(mean/2, sd/2) logpdf; genotype 2 -> Normal(mean, sd)
- LLDN = case het + controls absent; LLFP = all absent; LLIH = per-k-mer
  max over the 11 trio inheritance scenarios + log(15/11) correction

Heuristic filters ride the same bundle (PassengerVariant, CaseAbundance on
a run of low case k-mers, ControlAbundance on too many high control
k-mers, window sanity); per partition only max-scoring PASS calls keep
CALLCLASS (ties beyond ``ambigthresh`` become AmbiguousCall) and output
sorts by LIKESCORE descending. Behavioral contract: reference
kevlar/simlike.py:22-384, golden likelihood values pinned in
tests/test_simlike.py.
"""

from collections import defaultdict
import functools
from math import log, lgamma, pi, isclose, inf

import numpy as np

import kevlar_tpu_torch
from kevlar_tpu_torch.vcf import VariantFilter as vf


class KevlarSampleLabelingError(ValueError):
    pass


LOG_2PI = log(2.0 * pi)

INHERITANCE_SCENARIOS = [
    (1, 0, 1), (1, 0, 2),
    (1, 1, 0), (1, 1, 1), (1, 1, 2),
    (1, 2, 0), (1, 2, 1),
    (2, 1, 1), (2, 1, 2),
    (2, 2, 1), (2, 2, 2),
]


# ---------------------------------------------------------------------------
# scalar likelihood reference (golden-value-pinned)
# ---------------------------------------------------------------------------

def norm_logpdf(x, mu, sd):
    z = (x - mu) / sd
    return -0.5 * z * z - log(sd) - 0.5 * LOG_2PI


def log_choose(n, k):
    """log C(n, k) via lgamma; n may be fractional (scaled means)."""
    if k < 0 or k > n:
        return -inf
    return lgamma(n + 1.0) - lgamma(k + 1.0) - lgamma(n - k + 1.0)


def abund_log_prob(genotype, abundance, refrabund=None, mean=30.0, sd=8.0,
                   error=0.001):
    """log P(abundance | genotype in {0, 1, 2})."""
    if genotype == 0:
        if not refrabund:  # INDEL mode
            refrabund = 1
            error *= 0.01
        scaledmean = mean * refrabund
        abundance = min(abundance, scaledmean)
        return (log_choose(scaledmean, abundance)
                + (abundance * log(error))
                + ((scaledmean - abundance) * log(1.0 - error)))
    if genotype == 1:
        return norm_logpdf(abundance, mean / 2, sd / 2)
    if genotype == 2:
        return norm_logpdf(abundance, mean, sd)


# ---------------------------------------------------------------------------
# vectorised likelihood sums: identical math to abund_log_prob evaluated
# across all k-mers at once (tests check them against the scalar form)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1 << 16)
def _lgamma_cached(x):
    return lgamma(x)


_lgamma_vec = np.vectorize(_lgamma_cached, otypes=[float])


def _lp0_vec(abunds, refrabunds, mean, error):
    """Vectorised genotype-0 log-probabilities; refrabund entries of
    None/0 trigger INDEL mode (refrabund=1, error*0.01) per element."""
    a = np.asarray(abunds, dtype=float)
    r = np.array([0.0 if x is None else float(x) for x in refrabunds])
    indel = r == 0.0
    r = np.where(indel, 1.0, r)
    err = np.where(indel, error * 0.01, error)
    scaledmean = mean * r
    a = np.minimum(a, scaledmean)
    nck = (_lgamma_vec(scaledmean + 1.0) - _lgamma_vec(a + 1.0)
           - _lgamma_vec(scaledmean - a + 1.0))
    return nck + a * np.log(err) + (scaledmean - a) * np.log(1.0 - err)


def _lp_het_vec(abunds, mean, sd):
    a = np.asarray(abunds, dtype=float)
    z = (a - mean / 2) / (sd / 2)
    return -0.5 * z * z - np.log(sd / 2) - 0.5 * LOG_2PI


def _lp_hom_vec(abunds, mean, sd):
    a = np.asarray(abunds, dtype=float)
    z = (a - mean) / sd
    return -0.5 * z * z - np.log(sd) - 0.5 * LOG_2PI


def likelihood_denovo(abunds, refrabunds, mean=30.0, sd=8.0, error=0.001):
    assert len(abunds[1]) == len(refrabunds)
    assert len(abunds[2]) == len(refrabunds)
    if len(abunds[0]) == 0:
        return 0.0
    logsum = float(np.sum(_lp_het_vec(abunds[0], mean, sd)))
    for altabunds in abunds[1:]:
        logsum += float(np.sum(_lp0_vec(altabunds, refrabunds, mean, error)))
    return logsum


def likelihood_false(abunds, refrabunds, mean=30.0, error=0.001):
    assert len(abunds[1]) == len(refrabunds)
    assert len(abunds[2]) == len(refrabunds)
    logsum = 0.0
    for altabunds in abunds:
        if len(altabunds):
            logsum += float(np.sum(_lp0_vec(altabunds, refrabunds, mean,
                                            error)))
    return logsum


def likelihood_inherited(abunds, mean=30.0, sd=8.0, error=0.001):
    """Max-likelihood inheritance scenario per k-mer (trios only),
    vectorised over (k-mer, scenario)."""
    K = len(abunds[0])
    if K == 0:
        return log(15.0 / 11.0)
    per_person = []
    for a in (abunds[0], abunds[1], abunds[2]):
        # genotype 0 with no refrabund = the scalar code's "INDEL mode"
        # (refrabund=1, error*0.01) — parity with the reference, which
        # never passes refrabund in the inheritance scan
        none_refr = [None] * len(a)
        per_person.append(np.stack([
            _lp0_vec(a, none_refr, mean, error),
            _lp_het_vec(a, mean, sd),
            _lp_hom_vec(a, mean, sd),
        ]))
    scen = np.asarray(INHERITANCE_SCENARIOS)  # [S, 3]
    totals = (per_person[0][scen[:, 0]] + per_person[1][scen[:, 1]]
              + per_person[2][scen[:, 2]]) + log(1.0 / 15.0)  # [S, K]
    return log(15.0 / 11.0) + float(np.sum(np.max(totals, axis=0)))


# ---------------------------------------------------------------------------
# per-call abundance bundles (columnar)
# ---------------------------------------------------------------------------

class _AbundanceBundle:
    """Variant-spanning k-mer abundances for one call, reference-masked.

    ``case``/``controls`` are numpy vectors over the surviving k-mers;
    ``refrcopies`` is the per-k-mer REF-allele genome copy number (None
    entries for indels); ``ndropped`` counts masked/outlier k-mers.
    """

    __slots__ = ('case', 'controls', 'refrcopies', 'ndropped')

    def __init__(self, case, controls, refrcopies, ndropped):
        self.case = case
        self.controls = controls
        self.refrcopies = refrcopies
        self.ndropped = ndropped

    @classmethod
    def gather(cls, altseq, refrseq, casecounts, ctrlcounts, refrcounts,
               dropoutliers=False, sharedmin=0):
        """Mask out k-mers present in the reference genome; optionally drop
        per-sample outliers (> 20 from the sample mean)."""
        raw = np.asarray(casecounts.get_kmer_counts(altseq))
        novel = np.asarray(refrcounts.get_kmer_counts(altseq)) == 0
        case = raw[novel]
        controls = [np.asarray(c.get_kmer_counts(altseq))[novel]
                    for c in ctrlcounts]
        keep = cls._family_background_mask(controls, sharedmin)
        if len(altseq) == len(refrseq):  # SNV/MNV: per-k-mer copy number
            refrcopies = np.asarray(
                refrcounts.get_kmer_counts(refrseq))[novel]
            if keep is not None:
                refrcopies = refrcopies[keep]
            refrcopies = list(refrcopies)
        else:  # indel: alleles differ in length, copy number undefined
            refrcopies = [None] * (len(case) if keep is None
                                   else int(keep.sum()))
        if keep is not None:
            case = case[keep]
            controls = [c[keep] for c in controls]
        if dropoutliers:
            case = cls._drop_outliers(case)
            controls = [cls._drop_outliers(c) for c in controls]
        return cls(case, controls, refrcopies, int(len(raw) - len(case)))

    @staticmethod
    def _drop_outliers(abunds):
        if len(abunds) == 0:
            return abunds
        return abunds[np.abs(abunds - abunds.mean()) < 20]

    @staticmethod
    def _family_background_mask(controls, minabund, maxfrac=0.34):
        """Keep-mask dropping k-mers abundant in EVERY control.

        Such k-mers are family background — an inherited allele or repeat
        context overlapping the ALT window — and cannot carry de novo
        evidence; the de novo model's expectation of ~zero control
        abundance lets a single one swing LLDN below LLIH for an
        otherwise decisive call (the dominant negative-LIKESCORE
        false-negative mode in bigsim forensics).  Only a minority
        (<= maxfrac) of the window may be masked: a window that is mostly
        background keeps it and scores inherited, as it should.
        Deviation from the reference (docs/migrating.md): the reference
        only masks REFERENCE-genome k-mers (simlike.py:51-96), which
        cannot catch indel-window background.  ``minabund=0`` disables.
        Returns None when nothing is masked."""
        if not minabund or len(controls) < 2 or len(controls[0]) == 0:
            return None
        shared = np.ones(len(controls[0]), dtype=bool)
        for c in controls:
            shared &= np.asarray(c) >= minabund
        n = int(shared.sum())
        if n == 0 or n > maxfrac * len(shared):
            return None
        return ~shared

    def aslists(self):
        return [list(map(int, self.case))] + \
            [list(map(int, c)) for c in self.controls]

    # -- heuristic screens ---------------------------------------------------

    def no_spanning_novel_kmer(self, casemin):
        return not bool((self.case >= casemin).any())

    def case_low_run(self, casemin, runlength):
        """True when `runlength` consecutive case k-mers sit below casemin."""
        low = self.case < casemin
        run = 0
        for flag in low:
            run = run + 1 if flag else 0
            if run >= runlength:
                return True
        return False

    def control_high_count(self, ctrlmax, limit):
        return any(int((ctrl > ctrlmax).sum()) > limit
                   for ctrl in self.controls)


def _use_batched_gather(case, controls, refr):
    """Whether to batch every call's window queries into device calls.

    Default: only when a sketch is mesh-sharded (its point queries are
    device calls, so per-call gathers would pay one per call).
    ``KEVLAR_SIMLIKE_BATCH=1/0`` forces/disables.
    ``KEVLAR_SIMLIKE_DEVICE=1`` implies batch mode (device scoring rides
    the batched-gather path; without this it would be silently inert).
    """
    import os
    forced = os.environ.get('KEVLAR_SIMLIKE_BATCH')
    if forced is not None:
        return forced == '1'
    if os.environ.get('KEVLAR_SIMLIKE_DEVICE') == '1':
        return True
    from kevlar_tpu_torch.parallel import ShardedSketch
    return any(isinstance(s, ShardedSketch)
               for s in [case] + list(controls) + [refr])


def gather_bundles_batched(windowpairs, case, controls, refr,
                           dropoutliers=False, sharedmin=0):
    """One :class:`_AbundanceBundle` per (altseq, refrseq) pair, with every
    sample's window queries batched into bucketed device calls.

    The columnar (call x k-mer) counts come from one ``query_batch`` (K1,
    then K2, on the sketch's device) per (sample, length bucket) instead of
    per-call point gathers.  Bit-equal to per-call
    ``_AbundanceBundle.gather`` (pinned in tests/test_torch_simlike.py).
    Reference semantics: simlike.py:51-96.
    """
    from kevlar_tpu_torch import dna
    from kevlar_tpu_torch.batch import bucket_length

    k = case.ksize()
    samples = [case] + list(controls)
    bundles = [None] * len(windowpairs)

    def batched_counts(sketch, rows, bucket):
        # query_batch's counts are 0 at invalid windows already
        bases, _ = dna.encode_batch(rows, pad_to=bucket)
        counts, _ = sketch.query_batch(bases)
        return counts.cpu().numpy().astype(np.int64)

    groups = {}
    for i, (alt, _refrseq) in enumerate(windowpairs):
        groups.setdefault(bucket_length(len(alt)), []).append(i)
    for bucket, idxs in sorted(groups.items()):
        alts = [windowpairs[i][0] for i in idxs]
        percounts = [batched_counts(s, alts, bucket) for s in samples]
        refrcnt = batched_counts(refr, alts, bucket)
        # SNV/MNV rows additionally query the REF window for copy numbers
        snv = [i for i in idxs
               if len(windowpairs[i][1]) == len(windowpairs[i][0])]
        refrwin_counts = {}
        if snv:
            rbucket = max(bucket_length(len(windowpairs[i][1]))
                          for i in snv)
            rc = batched_counts(refr, [windowpairs[i][1] for i in snv],
                                rbucket)
            refrwin_counts = {i: rc[j] for j, i in enumerate(snv)}
        for j, i in enumerate(idxs):
            alt, refrseq = windowpairs[i]
            P = len(alt) - k + 1
            novel = refrcnt[j][:P] == 0
            casevec = percounts[0][j][:P][novel]
            ctrlvecs = [percounts[1 + c][j][:P][novel]
                        for c in range(len(controls))]
            keep = _AbundanceBundle._family_background_mask(
                ctrlvecs, sharedmin)
            if len(alt) == len(refrseq):
                refrcopies = refrwin_counts[i][:P][novel]
                if keep is not None:
                    refrcopies = refrcopies[keep]
                refrcopies = list(refrcopies)
            else:
                refrcopies = [None] * (len(casevec) if keep is None
                                       else int(keep.sum()))
            if keep is not None:
                casevec = casevec[keep]
                ctrlvecs = [c[keep] for c in ctrlvecs]
            if dropoutliers:
                casevec = _AbundanceBundle._drop_outliers(casevec)
                ctrlvecs = [_AbundanceBundle._drop_outliers(c)
                            for c in ctrlvecs]
            bundles[i] = _AbundanceBundle(casevec, ctrlvecs, refrcopies,
                                          P - len(casevec))
    return bundles


def spanning_kmer_abundances(altseq, refrseq, case, controls, refr,
                             dropoutliers=False):
    """Abundances of variant-spanning k-mers, dropping k-mers present in
    the reference genome. Returns (list-of-lists abundances, refr copy
    numbers, number dropped) — contract: reference simlike.py:51-96."""
    bundle = _AbundanceBundle.gather(
        altseq, refrseq, case, controls, refr, dropoutliers=dropoutliers)
    return bundle.aslists(), bundle.refrcopies, bundle.ndropped


def joinlist(values):
    return ','.join(str(v) for v in values) if len(values) else '.'


def default_sample_labels(nsamples):
    return ['Case'] + ['Control{:d}'.format(i) for i in range(1, nsamples)]


# ---------------------------------------------------------------------------
# per-call scoring and partition ranking
# ---------------------------------------------------------------------------

def _defective_window(call, ksize):
    """Missing or sub-k windows make likelihoods undefined."""
    for span in (call.window, call.refrwindow):
        if span is None or len(span) < ksize:
            if call.filterstr == 'PASS':
                kevlar_tpu_torch.plog(
                    '[kevlar::simlike] WARNING: stubbornly refusing to '
                    'compute likelihood for', str(call))
            return True
    return False


def _screen(call, bundle, casemin, ctrlmax, caseabundlow, ctrlabundhigh):
    if bundle.no_spanning_novel_kmer(casemin):
        call.filter(vf.PassengerVariant)
    if caseabundlow and caseabundlow > 0 and \
            bundle.case_low_run(casemin, caseabundlow):
        call.filter(vf.CaseAbundance)
    if ctrlabundhigh and ctrlabundhigh > 0 and \
            bundle.control_high_count(ctrlmax, ctrlabundhigh):
        call.filter(vf.ControlAbundance)


def _score(call, bundle, mu, sigma, epsilon, precomputed=None):
    if precomputed is not None:
        lldn, llfp, llih = precomputed
    else:
        abunds = bundle.aslists()
        lldn = likelihood_denovo(abunds, bundle.refrcopies, mean=mu,
                                 sd=sigma, error=epsilon)
        llfp = likelihood_false(abunds, bundle.refrcopies, mean=mu,
                                error=epsilon)
        llih = likelihood_inherited(abunds, mean=mu, sd=sigma, error=epsilon)
    call.annotate('LLDN', lldn)
    call.annotate('LLFP', llfp)
    call.annotate('LLIH', llih)
    call.annotate('LIKESCORE', lldn - max(llfp, llih))


def _use_device_scoring(controls):
    """Device tensor scoring (ops/simlike_ops.py) is opt-in: the host
    numpy path is exact float64 ``math.lgamma`` and already cheap, so
    float32 device math only pays off when the pipeline is device-resident
    end-to-end.  Trios only (the inheritance model is trio-specific)."""
    import os
    return os.environ.get('KEVLAR_SIMLIKE_DEVICE') == '1' \
        and len(controls) == 2


def _annotate_sample_data(call, bundle, samplelabels):
    if bundle.refrcopies and None not in bundle.refrcopies:
        call.annotate('REFRCOPYNUM', ','.join(map(str, bundle.refrcopies)))
    for label, abunds in zip(samplelabels, bundle.aslists()):
        call.format(label, 'ALTABUND', joinlist(abunds))


def _rank_partition(partitionid, calls, ambigthresh=10):
    """Only the top-scoring PASS calls represent a partition: they keep
    CALLCLASS (or become AmbiguousCall when too many tie); the rest get
    PartitionScore."""
    top = max((c.attribute('LIKESCORE') for c in calls
               if c.filterstr == 'PASS'), default=None)
    if top is None:
        return
    winners = []
    for call in calls:
        if call.filterstr == 'PASS' and \
                isclose(call.attribute('LIKESCORE'), top):
            winners.append(call)
        else:
            call.filter(vf.PartitionScore)
    ambiguous = ambigthresh and len(winners) > ambigthresh
    for call in winners:
        if ambiguous:
            call.filter(vf.AmbiguousCall)
        else:
            call.annotate('CALLCLASS', partitionid)


def simlike(variants, case, controls, refr, mu=30.0, sigma=8.0, epsilon=0.001,
            casemin=6, ctrlmax=1, caseabundlow=5, ctrlabundhigh=4,
            samplelabels=None, fastmode=False, minlikescore=0.0,
            dropoutliers=False, ambigthresh=10, caseabundgate=300.0,
            sharedkmermin=None, device='cuda'):
    """Score, filter and rank ``variants``; ``device`` is where
    ``KEVLAR_SIMLIKE_DEVICE=1`` scores (the batched gather queries each
    sketch on its own device)."""
    if sharedkmermin is None:
        sharedkmermin = casemin  # family-background bar: solidly present
    if samplelabels is None:
        samplelabels = default_sample_labels(len(controls) + 1)
    by_partition = defaultdict(list)

    def park(call):
        call.annotate('LIKESCORE', float('-inf'))
        by_partition[call.attribute('PART')].append(call)

    def process(call, bundle, precomputed=None):
        call.annotate('DROPPED', bundle.ndropped)
        _screen(call, bundle, casemin, ctrlmax, caseabundlow, ctrlabundhigh)
        if fastmode and call.filterstr != 'PASS':
            park(call)
            return
        _score(call, bundle, mu, sigma, epsilon, precomputed=precomputed)
        # Likelihood-gated heuristic override (deviation from the
        # reference, docs/migrating.md): the CaseAbundance run-length
        # heuristic (kevlar/simlike.py:284-290) kills real heterozygous
        # indels whose ALT coverage dips below casemin through a local
        # trough, and the score-blind Homopolymer flank check
        # (kevlar/varmap.py:163-173) kills real large indels whose right
        # flank merely opens with a base run — both even when the
        # likelihood model finds decisive de novo evidence.  When those
        # heuristics are the ONLY filters and LIKESCORE clears the gate,
        # the likelihood verdict wins.  caseabundgate=0 restores exact
        # reference semantics (measured: recovers 2/3 of all bigsim false
        # negatives at FDR far below the reference's operating point —
        # tools/miss_forensics.py).
        gate_eligible = frozenset({vf.CaseAbundance, vf.Homopolymer})
        if caseabundgate and caseabundgate > 0 and call.filters and \
                call.filters <= gate_eligible and \
                call.attribute('LIKESCORE') > caseabundgate:
            for filt in gate_eligible:
                call.unfilter(filt)
        _annotate_sample_data(call, bundle, samplelabels)
        by_partition[call.attribute('PART')].append(call)

    if _use_batched_gather(case, controls, refr):
        # device-batch path: every scoreable call's window queries ride a
        # handful of bucketed query_batch calls
        calls = list(variants)
        slots = []
        pairs = []
        for call in calls:
            if (fastmode and call.filterstr != 'PASS') or \
                    _defective_window(call, case.ksize()):
                slots.append(None)
            else:
                slots.append(len(pairs))
                pairs.append((call.window, call.refrwindow))
        bundles = gather_bundles_batched(pairs, case, controls, refr,
                                         dropoutliers=dropoutliers,
                                         sharedmin=sharedkmermin)
        scores = None
        if _use_device_scoring(controls):
            from kevlar_tpu_torch.ops import simlike_ops
            lldn, llfp, llih = simlike_ops.score_bundles(
                bundles, mean=mu, sd=sigma, error=epsilon, device=device)
            scores = list(zip(lldn, llfp, llih))
        for call, slot in zip(calls, slots):
            if slot is None:
                park(call)
            else:
                process(call, bundles[slot],
                        precomputed=scores[slot] if scores else None)
    else:
        for call in variants:
            if (fastmode and call.filterstr != 'PASS') or \
                    _defective_window(call, case.ksize()):
                park(call)
                continue
            process(call, _AbundanceBundle.gather(
                call.window, call.refrwindow, case, controls, refr,
                dropoutliers=dropoutliers, sharedmin=sharedkmermin))

    ranked = []
    for partitionid, calls in by_partition.items():
        _rank_partition(partitionid, calls, ambigthresh=ambigthresh)
        ranked += calls
    ranked.sort(key=lambda c: c.attribute('LIKESCORE'), reverse=True)
    for call in ranked:
        if call.attribute('LIKESCORE') < minlikescore:
            call.filter(vf.LikelihoodFail)
        yield call


def main(args):
    from kevlar_tpu_torch import sketch
    from kevlar_tpu_torch import vcf
    nsamples = len(args.controls) + 1
    if args.sample_labels:
        if len(args.sample_labels) != nsamples:
            raise KevlarSampleLabelingError(
                'provided {:d} labels but {:d} samples'.format(
                    len(args.sample_labels), nsamples))
        labels = args.sample_labels
    else:
        labels = default_sample_labels(nsamples)

    kevlar_tpu_torch.plog('[kevlar::simlike] Loading k-mer counts for each '
                          'sample')
    # host-backend (copy-on-write mmap) loads: simlike only point-queries
    # a few thousand windows, so shipping full multi-GB tables to the
    # device (and the np.load memcpy itself) would dominate the stage
    # wall.  Device/batched scoring modes need tables on --device.
    import os
    want_device = (os.environ.get('KEVLAR_SIMLIKE_BATCH') == '1'
                   or os.environ.get('KEVLAR_SIMLIKE_DEVICE') == '1')
    backend = 'device' if want_device else 'host'

    def load_ct(spec):
        # comma-separated per-band tables (count --num-bands) score
        # through the host BandedSketchView — each k-mer is answered by
        # its owning band's (mmapped) table
        if ',' in spec:
            return sketch.BandedSketchView.load(spec.split(','))
        return sketch.load(spec, backend=backend, device=args.device)

    case = load_ct(args.case)
    controls = [load_ct(c) for c in args.controls]
    refr = load_ct(args.refr)

    outstream = kevlar_tpu_torch.open(args.out, 'w')
    writer = vcf.VCFWriter(outstream, source='kevlar::simlike')
    for label in labels:
        writer.register_sample(label)
    writer.write_header()

    kevlar_tpu_torch.plog('[kevlar::simlike] Computing likelihood scores '
                          'for preliminary variant calls')
    calls = simlike(
        vcf.vcfstream(args.vcf), case, controls, refr, mu=args.mu,
        sigma=args.sigma, epsilon=args.epsilon, casemin=args.case_min,
        ctrlmax=args.ctrl_max, caseabundlow=args.case_abund_low,
        ctrlabundhigh=args.ctrl_abund_high, samplelabels=labels,
        fastmode=args.fast_mode, minlikescore=args.min_like_score,
        dropoutliers=args.drop_outliers, ambigthresh=args.ambig_thresh,
        caseabundgate=args.case_abund_gate,
        sharedkmermin=args.shared_kmer_min, device=args.device)
    try:
        for call in calls:
            writer.write(call)
    finally:
        if args.out not in (None, '-'):
            outstream.close()
