"""The port's ``simlike`` and ``varfilter`` subcommands against
``kevlar_tpu``'s.

Tolerance: none — both write the VCF text from float64 host arithmetic, so
the text must be identical (date line included: both write the same
day's); the batched gather (``KEVLAR_SIMLIKE_BATCH=1``) too.  Only the
float32 device scoring (``KEVLAR_SIMLIKE_DEVICE=1``, ``score_bundles``) has
one: JAX's own, rel 2e-5 and abs 2e-3 on the likelihoods, rel 1e-4 and
abs 1e-2 on LIKESCORE.  ``simlike`` is covered with the default flags,
``--case-abund-gate 0 --shared-kmer-min 0`` (the reference's semantics),
``--drop-outliers``, ``--fast-mode``, ``--sample-labels`` and per-band
case tables; ``varfilter`` on a BED over some of the calls.  The input is
``kevlar_tpu``'s own call set on a seeded 20 kb trio.
"""

import pytest

import kevlar_tpu_torch
from kevlar_tpu import cli as jax_cli
from kevlar_tpu_torch import cli

from .test_torch_filter import KSIZE, make_novel_case


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def called(tmp_path_factory):
    """``kevlar_tpu``'s filter -> partition -> alac on a seeded trio, plus
    the count tables simlike reads: {'vcf', 'case', 'mother', 'father',
    'refr_counts', 'bands', ...}."""
    workdir = tmp_path_factory.mktemp('simlike')
    case = make_novel_case(workdir, seed=91)

    def path(name):
        return str(workdir / name)

    jax_cli.main(['filter', '--case-min', '5', '--mask', case['mask'],
                  '-o', path('filtered.augfastq'), case['novel']])
    jax_cli.main(['partition', '-o', path('part.augfastq'),
                  path('filtered.augfastq')])
    case['vcf'] = path('calls.vcf')
    jax_cli.main(['alac', '-k', str(KSIZE), '-o', case['vcf'],
                  path('part.augfastq'), case['refr']])
    case['case'] = path('case.ct')
    jax_cli.main(['count', '-k', str(KSIZE), '-M', '200K', '--max-fpr',
                  '1.0', case['case'], case['proband.fq']])
    case['refr_counts'] = path('refr.sct')
    jax_cli.main(['count', '-k', str(KSIZE), '-c', '4', '-M', '100K',
                  '--max-fpr', '1.0', case['refr_counts'], case['refr']])
    bands = []
    for band in (1, 2):
        bands.append(path('case.band{}.ct'.format(band)))
        jax_cli.main(['count', '-k', str(KSIZE), '-M', '200K', '--max-fpr',
                      '1.0', '--num-bands', '2', '--band', str(band),
                      bands[-1], case['proband.fq']])
    case['bands'] = ','.join(bands)
    return case


def _rows(text):
    return [line for line in text.split('\n')
            if line and not line.startswith('#')]


@pytest.mark.parametrize('flags', [
    [], ['--case-abund-gate', '0', '--shared-kmer-min', '0'],
    ['--drop-outliers'], ['--fast-mode'],
    ['--sample-labels', 'Kid', 'Mom', 'Dad', '--mu', '12', '--sigma', '4'],
    ['--case-min', '3', '--ctrl-max', '0', '--min-like-score', '10',
     '--ambig-thresh', '1'],
    'banded'], ids=['default', 'reference-semantics', 'drop-outliers',
                    'fast-mode', 'labels', 'thresholds', 'banded'])
def test_simlike_matches_jax(called, tmp_path, flags):
    casetable = called['case']
    if flags == 'banded':
        casetable, flags = called['bands'], []
    args = ['--case', casetable, '--controls', called['mother'],
            called['father'], '--refr', called['refr_counts']] + flags
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    jax_cli.main(['simlike'] + args + ['-o', want, called['vcf']])
    cli.main(['simlike'] + args + ['-o', got, called['vcf']])
    with open(want) as fh:
        expected = fh.read()
    with open(got) as fh:
        assert fh.read() == expected
    assert len(_rows(expected)) >= 4
    assert 'LIKESCORE=' in expected


def test_simlike_refuses_wrong_label_count(called, tmp_path):
    from kevlar_tpu_torch.simlike import KevlarSampleLabelingError
    with pytest.raises(SystemExit):
        cli.main(['simlike', '--case', called['case'], '--controls',
                  called['mother'], called['father'], '--refr',
                  called['refr_counts'], '--sample-labels', 'A', 'B',
                  '-o', str(tmp_path / 'x.vcf'), called['vcf']])
    assert issubclass(KevlarSampleLabelingError, ValueError)


def test_varfilter_matches_jax(called, tmp_path):
    positions = [line.split('\t')[1] for line in _rows(open(
        called['vcf']).read())]
    bed = tmp_path / 'regions.bed'
    bed.write_text('# regions to drop\nchr1\t{}\t{}\tfirst\n\nchr1\t{}\t{}\n'
                   'chr2\t1\t100000\n'.format(
                       int(positions[0]) - 5, int(positions[0]) + 5,
                       int(positions[-1]) - 1, int(positions[-1])))
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    jax_cli.main(['varfilter', '-o', want, str(bed), called['vcf']])
    cli.main(['varfilter', '-o', got, str(bed), called['vcf']])
    with open(want) as fh:
        expected = fh.read()
    with open(got) as fh:
        assert fh.read() == expected
    assert 'UserFilter' in expected


def test_vcf_reader_and_bed_parser_match_jax(called):
    import kevlar_tpu
    from kevlar_tpu import vcf as jax_vcf
    from kevlar_tpu_torch import vcf
    want = [(c.seqid, c.position, c._refr, c._alt, c.filterstr,
             sorted(c.info.items())) for c in jax_vcf.vcfstream(
                 [called['vcf']])]
    got = [(c.seqid, c.position, c._refr, c._alt, c.filterstr,
            sorted(c.info.items())) for c in vcf.vcfstream([called['vcf']])]
    assert got == want and got
    bedtext = ['chr1 10 20 a b\n', '#x\n', '\n', 'chr2\t5\t9\n']
    assert list(kevlar_tpu_torch.parse_bed(bedtext)) == \
        list(kevlar_tpu.parse_bed(bedtext))


def _bundle_rows(bundles):
    return [(b.case.tolist(), [c.tolist() for c in b.controls],
             [None if r is None else int(r) for r in b.refrcopies],
             b.ndropped) for b in bundles]


@pytest.mark.parametrize('dropoutliers,sharedmin', [(False, 0), (True, 0),
                                                    (False, 6)])
def test_batched_gather_equals_per_call_gather(called, dropoutliers,
                                               sharedmin):
    from kevlar_tpu_torch import sketch, vcf
    from kevlar_tpu_torch.simlike import (_AbundanceBundle,
                                          gather_bundles_batched)
    case, mom, dad, refr = (
        sketch.load(called[name], device='cpu', cache=False)
        for name in ('case', 'mother', 'father', 'refr_counts'))
    pairs = [(c.window, c.refrwindow) for c in vcf.vcfstream([called['vcf']])
             if c.window and c.refrwindow]
    assert len(pairs) >= 4
    assert any(len(a) != len(r) for a, r in pairs)  # an indel window too
    want = [_AbundanceBundle.gather(alt, ref, case, [mom, dad], refr,
                                    dropoutliers=dropoutliers,
                                    sharedmin=sharedmin)
            for alt, ref in pairs]
    got = gather_bundles_batched(pairs, case, [mom, dad], refr,
                                 dropoutliers=dropoutliers,
                                 sharedmin=sharedmin)
    assert _bundle_rows(got) == _bundle_rows(want)


def _calls(text):
    """{(chrom, pos, ref, alt): (FILTER, LIKESCORE)} of a VCF's text."""
    out = {}
    for row in _rows(text):
        f = row.split('\t')
        score = [kv.split('=')[1] for kv in f[7].split(';')
                 if kv.startswith('LIKESCORE=')]
        out[tuple(f[:2] + f[3:5])] = (f[6], float(score[0]))
    return out


def _simlike_both(called, tmp_path, flags=()):
    args = ['--case', called['case'], '--controls', called['mother'],
            called['father'], '--refr', called['refr_counts']] + list(flags)
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    jax_cli.main(['simlike'] + args + ['-o', want, called['vcf']])
    cli.main(['simlike', '--device', 'cpu'] + args +
             ['-o', got, called['vcf']])
    with open(want) as fh, open(got) as gh:
        return gh.read(), fh.read()


@pytest.mark.parametrize('flags', [[], ['--case-abund-gate', '0',
                                        '--shared-kmer-min', '0'],
                                   ['--drop-outliers']],
                         ids=['default', 'reference-semantics',
                              'drop-outliers'])
def test_simlike_batched_gather_matches_jax(called, tmp_path, monkeypatch,
                                            flags):
    monkeypatch.setenv('KEVLAR_SIMLIKE_BATCH', '1')
    got, want = _simlike_both(called, tmp_path, flags)
    assert got == want
    assert len(_rows(want)) >= 4
    monkeypatch.delenv('KEVLAR_SIMLIKE_BATCH')
    host, _ = _simlike_both(called, tmp_path, flags)
    assert host == got


def test_simlike_device_scoring_matches_jax_and_host(called, tmp_path,
                                                     monkeypatch):
    """float32 scores: FILTER equal to ``kevlar_tpu``'s under the same
    switch, LIKESCORE within JAX's tolerance of it and of the float64 host
    path.  (Against the host path a FILTER may differ: two calls of one
    partition whose float64 scores tie exactly are no longer ``isclose`` in
    float32, so one of them becomes PartitionScore, as in JAX.)"""
    host, _ = _simlike_both(called, tmp_path)
    monkeypatch.setenv('KEVLAR_SIMLIKE_DEVICE', '1')
    got, want = _simlike_both(called, tmp_path)
    got, want, host = _calls(got), _calls(want), _calls(host)
    assert set(got) == set(want) == set(host)
    assert {key: filt for key, (filt, _) in got.items()} == \
        {key: filt for key, (filt, _) in want.items()}
    assert any(filt == 'PASS' for filt, _ in got.values())
    for other in (want, host):
        for key, (_, score) in got.items():
            assert score == pytest.approx(other[key][1], rel=1e-4, abs=1e-2)


def _random_bundles(seed=77, n=50, kmax=40):
    """tests/test_simlike.py:301's bundles: K 0-40, half SNV mode (copy
    numbers 0-4), half indel mode."""
    import random
    import numpy as np
    from kevlar_tpu_torch.simlike import _AbundanceBundle
    rng = random.Random(seed)
    bundles = []
    for _ in range(n):
        K = rng.randint(0, kmax)
        case = np.array([rng.randint(0, 40) for _ in range(K)])
        mom = np.array([rng.randint(0, 6) for _ in range(K)])
        dad = np.array([rng.randint(0, 6) for _ in range(K)])
        if rng.random() < 0.5:
            refr = [rng.randint(0, 4) for _ in range(K)]
        else:
            refr = [None] * K
        bundles.append(_AbundanceBundle(case, [mom, dad], refr, 0))
    return bundles


def test_score_bundles_matches_jax_and_host():
    import numpy as np
    from kevlar_tpu.ops import simlike_ops as jax_simlike_ops
    from kevlar_tpu_torch.ops import simlike_ops
    from kevlar_tpu_torch.simlike import (likelihood_denovo,
                                          likelihood_false,
                                          likelihood_inherited)
    bundles = _random_bundles()
    kw = dict(mean=25.0, sd=7.0, error=0.001)
    got = simlike_ops.score_bundles(bundles, device='cpu', **kw)
    want = jax_simlike_ops.score_bundles(bundles, **kw)
    host = [[], [], []]
    for b in bundles:
        abunds = b.aslists()
        host[0].append(likelihood_denovo(abunds, b.refrcopies, **kw))
        host[1].append(likelihood_false(abunds, b.refrcopies, mean=25.0,
                                        error=0.001))
        host[2].append(likelihood_inherited(abunds, **kw))
    for other in (want, host):
        for g, w in zip(got, other):
            assert g == pytest.approx(w, rel=2e-5, abs=2e-3)

    def ranking(scores):
        lldn, llfp, llih = (np.array(x) for x in scores)
        return np.argsort(lldn - np.maximum(llfp, llih))

    assert np.array_equal(ranking(got), ranking(want))
    assert np.array_equal(ranking(got), ranking(host))
    assert simlike_ops.score_bundles([], device='cpu') == ([], [], [])
