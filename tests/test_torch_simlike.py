"""The port's ``simlike`` and ``varfilter`` subcommands against
``kevlar_tpu``'s.

Tolerance: none — both write the VCF text from float64 host arithmetic, so
the text must be identical (date line included: both write the same
day's).  ``simlike`` is covered with the default flags,
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
