"""``--shards`` on the port's command line and the workflow's ``shards``
key, against ``kevlar_tpu``'s.

Tolerance: none.  ``count --shards 2`` must save the tables ``kevlar_tpu``'s
sharded count saves (and the unsharded count's: the sharded table is the
same odd size), ``novel --shards 2`` the same augmented FASTQ, ``alac`` and
``call --shards 8`` the same VCF records, ``run_mark1`` with ``shards: 2``
the VCF it writes without.  The port's mesh runs on the CPU (``--device
cpu``); ``kevlar_tpu``'s on its 8 virtual CPU devices (tests/conftest.py),
where ``--shards 2`` is a 4 x 2 mesh (and the alignment batch's 'data' axis
must take all 8).  tests/test_cli_sharded.py is the
model.
"""

import gzip
import random

import numpy as np
import pytest

import kevlar_tpu_torch
from kevlar_tpu import cli as jax_cli
from kevlar_tpu import workflow as jax_workflow
from kevlar_tpu_torch import cli, workflow

from . import simdata
from .test_torch_alac import mini_trio, _jax_native_loaded  # noqa: F401
from .test_torch_cli import _pallas_backend, _records, stages  # noqa: F401
from .test_torch_workflow import _trio, _vcf_body

KSIZE = 25


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def trio_files(tmp_path_factory):
    """tests/test_cli_sharded.py's trio: a 4 kb genome, one SNV in the
    proband at 2,000, 80 bp reads at 12x; and a 1-bit mask of the
    reference."""
    root = tmp_path_factory.mktemp('shardedcli')
    rng = random.Random(77)
    genome = simdata.make_genome(rng, 4000)
    alt = list(genome)
    alt[2000] = 'A' if alt[2000] != 'A' else 'C'
    files = {'refr': str(root / 'refr.fa')}
    simdata.write_fasta({'chr1': genome[:2500]}, files['refr'])
    for name, g in (('proband', ''.join(alt)), ('mother', genome),
                    ('father', genome)):
        reads = simdata.sample_reads(rng, g, readlen=80, coverage=12)
        files[name] = str(root / (name + '.fq'))
        simdata.write_fastq(reads, files[name])
    files['mask'] = str(root / 'mask.nt')
    cli.main(['count', '--device', 'cpu', '-k', str(KSIZE), '-c', '1', '-M',
              '100K', '--max-fpr', '1.0', files['mask'], files['refr']])
    return files


def _tables(path):
    with np.load(path) as data:
        return {name: np.asarray(data[name])
                for name in ('tables', 'ksize', 'tablesize', 'ntables',
                             'counter_bits')}


def _assert_same_sketch(got, want):
    got, want = _tables(got), _tables(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize('counter_size', ['1', '4', '8'])
def test_count_sharded_matches_jax(trio_files, tmp_path, counter_size):
    argv = ['count', '-k', str(KSIZE), '-c', counter_size, '-M', '400K',
            '--max-fpr', '1.0']
    ext = {'1': '.nt', '4': '.sct', '8': '.ct'}[counter_size]
    paths = {name: str(tmp_path / (name + ext))
             for name in ('jax', 'port', 'plain')}
    jax_cli.main(argv + ['--shards', '2', paths['jax'],
                         trio_files['proband']])
    cli.main(argv + ['--shards', '2', '--device', 'cpu', paths['port'],
                     trio_files['proband']])
    cli.main(argv + ['--device', 'cpu', paths['plain'],
                     trio_files['proband']])
    _assert_same_sketch(paths['port'], paths['jax'])
    _assert_same_sketch(paths['port'], paths['plain'])
    assert _tables(paths['port'])['tablesize'] % 2 == 1


@pytest.mark.parametrize('flags', [[], ['--count-masked']],
                         ids=['masked', 'count-masked'])
def test_count_sharded_with_a_mask_matches_jax(trio_files, tmp_path, flags):
    """The mask is re-sharded over the mesh and the consume takes the
    replicate path."""
    argv = ['count', '-k', str(KSIZE), '-M', '400K', '--max-fpr', '1.0',
            '--mask', trio_files['mask'], '--shards', '2'] + flags
    want, got = str(tmp_path / 'jax.ct'), str(tmp_path / 'port.ct')
    jax_cli.main(argv + [want, trio_files['mother']])
    cli.main(argv + ['--device', 'cpu', got, trio_files['mother']])
    _assert_same_sketch(got, want)


@pytest.mark.parametrize('extra,message', [
    (['--num-bands', '2', '--band', '1'], 'supersedes banding'),
    (['--sketch-format', 'khmer'], 'mutually exclusive')],
    ids=['banding', 'khmer'])
def test_count_shards_refusals_like_jax(trio_files, tmp_path, capsys, extra,
                                        message):
    argv = ['count', '-k', str(KSIZE), '-M', '400K', '--shards', '2'] + \
        extra + [str(tmp_path / 'x.ct'), trio_files['proband']]
    for main, more in ((jax_cli.main, []), (cli.main, ['--device', 'cpu'])):
        with pytest.raises(SystemExit) as exit_info:
            main(argv[:1] + more + argv[1:])
        assert exit_info.value.code == 1
        assert message in capsys.readouterr().err


def test_novel_sharded_matches_jax(trio_files, tmp_path):
    """novel --shards 2 over precomputed counttables: the same augfastq as
    ``kevlar_tpu``'s, sharded or not."""
    cts = {}
    for sample in ('proband', 'mother', 'father'):
        cts[sample] = str(tmp_path / (sample + '.ct'))
        cli.main(['count', '--device', 'cpu', '-k', str(KSIZE), '-M', '400K',
                  cts[sample], trio_files[sample]])
    base = ['novel', '-k', str(KSIZE), '--ctrl-max', '0', '--case-min', '5',
            '--case', trio_files['proband'], '--case-counts', cts['proband'],
            '--control-counts', cts['mother'], cts['father']]
    outs = {name: str(tmp_path / (name + '.augfastq'))
            for name in ('jax', 'port', 'plain')}
    jax_cli.main(base + ['--shards', '2', '--out', outs['jax']])
    cli.main(base + ['--shards', '2', '--device', 'cpu', '--out',
                     outs['port']])
    cli.main(base + ['--device', 'cpu', '--out', outs['plain']])
    with open(outs['jax']) as fh:
        want = fh.read()
    assert want.strip(), 'screen found nothing - fixture is broken'
    for name in ('port', 'plain'):
        with open(outs[name]) as fh:
            assert fh.read() == want, name


def test_novel_sharded_fresh_counting_matches_jax(trio_files, tmp_path):
    """novel --shards with FASTQ inputs (the samples counted inside the
    stage, sharded) and --abund-screen."""
    base = ['novel', '-k', str(KSIZE), '-M', '400K', '--ctrl-max', '0',
            '--case-min', '5', '--abund-screen', '3', '--shards', '2',
            '--case', trio_files['proband'], '--control',
            trio_files['mother'], '--control', trio_files['father']]
    want, got = str(tmp_path / 'jax.augfastq'), str(tmp_path / 'port.augfastq')
    jax_cli.main(base + ['--out', want])
    cli.main(base + ['--device', 'cpu', '--out', got])
    with open(want) as fh:
        expected = fh.read()
    assert expected.strip()
    with open(got) as fh:
        assert fh.read() == expected


def test_alac_sharded_matches_jax(mini_trio, tmp_path):
    """The alignment batch cut over 8 devices: ``kevlar_tpu``'s data axis
    must take every one of its 8 virtual devices."""
    refr, reads = mini_trio
    argv = ['alac', '-k', '21', '--shards', '8']
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    jax_cli.main(argv + ['-o', want, reads, refr])
    cli.main(argv + ['--device', 'cpu', '-o', got, reads, refr])
    with open(want) as fh:
        expected = fh.read()
    with open(got) as fh:
        assert fh.read() == expected
    assert '\tPASS\t' in expected


def test_call_sharded_matches_jax(stages, tmp_path):
    refr, _, contigs, cutouts = stages
    argv = ['call', '-k', '21', '--refr', refr, '--shards', '8']
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    plain = str(tmp_path / 'plain.vcf')
    jax_cli.main(argv + ['-o', want, contigs, cutouts])
    cli.main(argv + ['--device', 'cpu', '-o', got, contigs, cutouts])
    cli.main(argv[:-2] + ['--device', 'cpu', '-o', plain, contigs, cutouts])
    assert _records(got) == _records(want) == _records(plain)


def test_run_mark1_shards_matches_unsharded_and_jax(tmp_path):
    config = _trio(tmp_path, seed=8080)
    for sample in [config['case'], config['mask']] + config['controls']:
        sample['memory'] = '1M'
    plain = workflow.run_mark1(dict(config, outdir=str(tmp_path / 'plain'),
                                    device='cpu'))
    got = workflow.run_mark1(dict(config, outdir=str(tmp_path / 'sharded'),
                                  device='cpu', shards=2))
    want = jax_workflow.run_mark1(dict(config, outdir=str(tmp_path / 'jax'),
                                       shards=2))
    assert _vcf_body(got) == _vcf_body(plain) == _vcf_body(want)
    assert any('\tPASS\t' in line for line in _vcf_body(got))
    stages = [s for s, _ in workflow.run_mark1.last_stage_times]
    assert "sharding sketches over mesh {'data': 1, 'shard': 2}" in stages
    # the same stages as JAX's, whose mesh is 4 x 2 on its 8 devices
    assert [s.split(' {')[0] for s in stages] == [
        s.split(' {')[0] for s, _ in jax_workflow.run_mark1.last_stage_times]
    for name in ('case.ct', 'control0.ct', 'control1.ct'):
        _assert_same_sketch(str(tmp_path / 'sharded' / name),
                            str(tmp_path / 'plain' / name))
    with gzip.open(str(tmp_path / 'sharded' / 'novel.augfastq.gz'),
                   'rt') as fh, \
            gzip.open(str(tmp_path / 'plain' / 'novel.augfastq.gz'),
                      'rt') as gh:
        assert fh.read() == gh.read()


def test_sharded_count_file_loads_as_a_single_sketch(trio_files, tmp_path):
    """A sketch file written by a sharded count, read back in the same
    process, is the file's single-device sketch (not the live sharded
    one); the live one answers point queries on its mesh."""
    from kevlar_tpu_torch import count, sketch
    from kevlar_tpu_torch.parallel import ShardedSketch, make_mesh
    path = str(tmp_path / 'proband.ct')
    live = count.load_sample_seqfile(
        [trio_files['proband']], KSIZE, 400000, maxfpr=1.0, outfile=path,
        mesh=make_mesh(n_shard=2, device='cpu'))
    assert isinstance(live, ShardedSketch)
    loaded = sketch.load(path, device='cpu')
    assert isinstance(loaded, sketch.Sketch)
    np.testing.assert_array_equal(loaded._host(), live._host())
    seq = open(trio_files['refr']).read().split('\n')[1][100:300]
    live._invalidate()
    assert live.get_kmer_counts(seq) == loaded.get_kmer_counts(seq)
    assert live._host_tables is None
