"""The port's ``oxli`` engine and call mask against ``kevlar_tpu``'s.

Tolerance: none.  ``make_call_mask`` files, ``alac --gen-mask`` files and
``OxliSketch`` saves must be byte-identical between the packages, and a
file written by either must load in the other with equal tables and
counts.  (The filter with a khmer-format mask is in
``tests/test_torch_filter.py``.)
"""

import numpy as np
import pytest

import kevlar_tpu_torch
from kevlar_tpu import call as jax_call
from kevlar_tpu import cli as jax_cli
from kevlar_tpu import oxli as jax_oxli
from kevlar_tpu import vcf as jax_vcf
from kevlar_tpu_torch import call, cli, oxli, sketch, vcf

from .test_torch_filter import KSIZE, make_novel_case


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def partitioned(tmp_path_factory):
    """Partitioned novel reads of a seeded trio and its reference."""
    workdir = tmp_path_factory.mktemp('oxli')
    case = make_novel_case(workdir, seed=5)
    part = str(workdir / 'part.augfastq')
    jax_cli.main(['filter', '--case-min', '5', '-o',
                  str(workdir / 'filtered.augfastq'), case['novel']])
    jax_cli.main(['partition', '-o', part, str(workdir / 'filtered.augfastq')])
    return case['refr'], part, case


def _bytes(path):
    with open(path, 'rb') as fh:
        return fh.read()


def test_alac_gen_mask_matches_jax(partitioned, tmp_path):
    refr, part, _ = partitioned
    args = ['-k', str(KSIZE), '--mask-mem', '50K', '--mask-max-fpr', '0.5']
    jax_cli.main(['alac'] + args + ['--gen-mask', str(tmp_path / 'jax.nt'),
                                    '-o', str(tmp_path / 'jax.vcf'), part,
                                    refr])
    cli.main(['alac', '--device', 'cpu'] + args + [
        '--gen-mask', str(tmp_path / 'port.nt'), '-o',
        str(tmp_path / 'port.vcf'), part, refr])
    assert _bytes(str(tmp_path / 'port.vcf')) == \
        _bytes(str(tmp_path / 'jax.vcf'))
    mask = _bytes(str(tmp_path / 'jax.nt'))
    assert mask[:4] == b'OXLI'
    assert _bytes(str(tmp_path / 'port.nt')) == mask
    assert oxli.OxliSketch.load(str(tmp_path / 'port.nt')).n_occupied() > 0


@pytest.mark.parametrize('maskmem,maxfpr', [(4000, 0.01), (200000, 0.01)])
def test_make_call_mask_matches_jax(partitioned, tmp_path, capsys, maskmem,
                                    maxfpr):
    refr, part, _ = partitioned
    vcfpath = str(tmp_path / 'calls.vcf')
    jax_cli.main(['alac', '-k', str(KSIZE), '-o', vcfpath, part, refr])
    want, got = str(tmp_path / 'jax.nt'), str(tmp_path / 'port.nt')
    jax_call.make_call_mask(list(jax_vcf.vcfstream([vcfpath])), KSIZE,
                            maskmem, maxfpr, want)
    capsys.readouterr()
    mask = call.make_call_mask(list(vcf.vcfstream([vcfpath])), KSIZE,
                               maskmem, maxfpr, got)
    warned = 'WARNING: mask FPR' in capsys.readouterr().err
    assert warned == (sketch.estimate_fpr(mask) > maxfpr)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize('bits,ext', [(1, '.nt'), (4, '.sct'), (8, '.ct')])
def test_oxli_files_round_trip_between_packages(partitioned, tmp_path, bits,
                                                ext):
    _, _, case = partitioned
    seqs = [line.strip() for line in open(case['proband.fq'])][1::4][:300]
    jsk = jax_oxli.OxliSketch(KSIZE, 9973, 4, counter_bits=bits)
    psk = oxli.OxliSketch(KSIZE, 9973, 4, counter_bits=bits)
    for seq in seqs:
        jsk.consume(seq)
        psk.consume(seq)
    assert psk.n_unique_kmers() == jsk.n_unique_kmers()
    jpath, ppath = str(tmp_path / ('jax' + ext)), str(tmp_path / ('port' +
                                                                 ext))
    jsk.save(jpath)
    psk.save(ppath)
    assert _bytes(ppath) == _bytes(jpath)
    # each package loads the other's file, through sketch.load too
    from_jax = sketch.load(jpath, device='cpu')
    from_port = jax_oxli.OxliSketch.load(ppath)
    assert isinstance(from_jax, oxli.OxliSketch)
    for a, b in zip(from_jax.tables, from_port.tables):
        np.testing.assert_array_equal(a, b)
    again = str(tmp_path / ('again' + ext))
    from_jax.save(again)
    assert _bytes(again) == _bytes(jpath)
    assert from_jax.get_kmer_counts(seqs[0]) == \
        from_port.get_kmer_counts(seqs[0])
    assert oxli.is_oxli_file(jpath) and not oxli.is_oxli_file(case['mask'])
