"""The port's banded run (``kevlar_tpu_torch.bench.banded``) against the
JAX package's tool (``tools/banded_bench.py``), loaded from its path.

Tolerance: none.  One small run of each whole entry (a 200 kb trio at
15x in two bands; ``filter``'s fixed ``-M 1G`` shrunk to 4M for the CPU
in both) must leave byte-equal files (``##fileDate`` aside), equal band
tables, equal evaluations and the same keys.  JAX's ``main`` always gets
``--out`` under a temporary directory: its default writes into the
repository.
"""

import json
import os

import numpy as np
import pytest
import torch

from kevlar_tpu_torch.bench import banded

# _one_torch_thread: test_torch_bench.py's autouse fixture, one torch
# thread a test
from .test_torch_bench import _one_torch_thread, _repo_files  # noqa: F401
from .test_torch_bigsim import (_jax_main, _jax_tool, _reset_logstreams,
                                _small_filter, _stdout_of, _without_filedate)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_BANDS = 2
SMALL = ['--genome-size', '200000', '--coverage', '15', '--denovo', '8',
         '--inherited', '6', '--num-bands', str(NUM_BANDS)]
SAMPLES = ('proband', 'mother', 'father')
BANDS = range(1, NUM_BANDS + 1)
# the files a run leaves that must be byte-equal (##fileDate aside)
RUN_FILES = (('genome.fa', 'truth.vcf') +
             tuple(who + '.fq' for who in SAMPLES) +
             tuple('novel.b{}.augfastq'.format(b) for b in BANDS) +
             ('novel.augfastq', 'filtered.augfastq', 'partitioned.augfastq',
              'calls.vcf', 'scored.vcf'))
TABLES = tuple('{}.b{}.ct'.format(who, b) for who in SAMPLES for b in BANDS)
# the inputs a run with --skip-sim takes from its work directory
SIM_FILES = ('genome.fa', 'truth.vcf') + tuple(who + '.fq' for who in SAMPLES)


@pytest.fixture(scope='module')
def jax_banded():
    return _jax_tool('banded_bench')


def _port_run(argv):
    """The port's ``main`` from the repository's root, ``filter`` shrunk:
    its result, standard output, whether the repository's files stayed as
    they were, and the working directory after it."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(banded, 'timed_stage',
                       _small_filter(banded.timed_stage))
            before = _repo_files()
            got, lines = _stdout_of(banded.main, argv)
            unchanged = _repo_files() == before
            port_cwd = os.getcwd()
    finally:
        os.chdir(cwd)
        _reset_logstreams()
    return got, lines, unchanged, port_cwd


@pytest.fixture(scope='module')
def runs(jax_banded, tmp_path_factory):
    """One small run of each entry: JAX's with ``--out`` under a temporary
    directory, the port's with no ``--out``."""
    jax_dir = tmp_path_factory.mktemp('jax_banded')
    port_dir = tmp_path_factory.mktemp('port_banded')
    jax_out = jax_dir / 'result.json'
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_banded, 'timed_stage',
                       _small_filter(jax_banded.timed_stage))
            jax_lines = _jax_main(jax_banded, SMALL + [
                '--workdir', jax_dir / 'work', '--out', jax_out])
        got, port_lines, unchanged, port_cwd = _port_run(SMALL + [
            '--device', 'cpu', '--workdir', str(port_dir / 'work')])
    finally:
        torch.set_num_threads(threads)
    with open(jax_out) as fh:
        want = json.load(fh)
    return dict(jax_dir=jax_dir / 'work', port_dir=port_dir / 'work',
                want=want, jax_lines=jax_lines, got=got,
                port_lines=port_lines, repo_unchanged=unchanged,
                port_cwd=port_cwd)


@pytest.mark.parametrize('name', RUN_FILES)
def test_run_files_equal_jax(name, runs):
    got = _without_filedate(os.path.join(runs['port_dir'], name))
    assert got, name
    assert got == _without_filedate(os.path.join(runs['jax_dir'], name))


@pytest.mark.parametrize('name', TABLES)
def test_band_tables_equal_jax(name, runs):
    with np.load(os.path.join(runs['jax_dir'], name)) as want, \
            np.load(os.path.join(runs['port_dir'], name)) as got:
        assert sorted(got.files) == sorted(want.files)
        for member in want.files:
            assert np.array_equal(got[member], want[member]), member
        # a band's table holds about 1/N of the sample's k-mers
        assert 0 < (got['tables'][0] > 0).sum() < got['tables'].shape[1]


def test_run_evaluations_equal_jax(runs):
    got, want = runs['got'], runs['want']
    for key in ('suite', 'backend', 'genome_size', 'coverage', 'num_bands',
                'per_band_memory', 'unbanded_memory_per_sample',
                'repeat_genome', 'evaluation',
                'evaluation_reference_protocol', 'note'):
        assert got[key] == want[key], key
    assert list(got['wall_s']) == list(want['wall_s'])
    assert list(got['wall_s'])[:4] == [
        'simulate', 'count_proband_b1', 'count_proband_b2', 'count_mother_b1']
    mem, want_mem = got['memory'], want['memory']
    assert list(mem) == list(want_mem)
    for key in ('band_table_bytes_per_sample',
                'unbanded_table_bytes_per_sample'):
        assert mem[key] == want_mem[key], key
    assert list(mem['rss_after_count_mb']) == \
        list(want_mem['rss_after_count_mb'])
    # neither CPU backend counts device bytes
    assert 'device_mb_after' not in mem
    assert mem['band_table_bytes_per_sample'] * NUM_BANDS == \
        mem['unbanded_table_bytes_per_sample'] == 2_316_000
    ev = got['evaluation']
    assert ev['total_truth'] == 8 and ev['tp'] > 0
    assert got['backend'] == 'cpu'


def test_run_keys_and_line_equal_jax(runs):
    got, want = runs['got'], runs['want']
    assert list(got) == list(want)
    assert len(runs['port_lines']) == len(runs['jax_lines']) == 1
    last, jax_last = (json.loads(runs['port_lines'][-1]),
                      json.loads(runs['jax_lines'][-1]))
    assert list(last) == list(jax_last) == [
        'metric', 'value', 'unit', 'fdr', 'num_bands', 'total_wall_s']
    assert last['total_wall_s'] == got['total_wall_s']
    last.pop('total_wall_s')
    jax_last.pop('total_wall_s')
    assert last == jax_last
    assert last['metric'] == 'banded_recall'
    assert last['value'] == got['evaluation']['recall']


def test_run_writes_nothing_into_the_repo(runs):
    assert runs['repo_unchanged']
    assert runs['port_cwd'] == REPO
    assert not any(name.endswith('.json')
                   for name in os.listdir(runs['port_dir']))


def test_skip_sim_on_linked_inputs_equals_the_run(runs, tmp_path):
    """chip_smoke's use: ``--skip-sim`` on links to another run's inputs,
    the result written where ``--out`` says and nowhere else."""
    work = tmp_path / 'work'
    work.mkdir()
    for name in SIM_FILES:
        os.symlink(os.path.join(runs['port_dir'], name), work / name)
    out = tmp_path / 'banded.json'
    got, lines, unchanged, cwd = _port_run(SMALL + [
        '--device', 'cpu', '--skip-sim', '--workdir', str(work), '--out',
        str(out)])
    assert unchanged and cwd == REPO
    assert json.loads(out.read_text()) == got
    assert 'simulate' not in got['wall_s']
    assert list(got['wall_s']) == list(runs['got']['wall_s'])[1:]
    for key in ('evaluation', 'evaluation_reference_protocol'):
        assert got[key] == runs['got'][key], key
    assert _without_filedate(work / 'scored.vcf') == _without_filedate(
        os.path.join(runs['port_dir'], 'scored.vcf'))


def test_num_bands_must_be_a_power_of_two(jax_banded, tmp_path):
    argv = ['--num-bands', '3', '--workdir', str(tmp_path / 'work')]
    with pytest.raises(SystemExit) as want:
        _jax_main(jax_banded, argv + ['--out', tmp_path / 'jax.json'])
    with pytest.raises(SystemExit) as got:
        banded.main(argv + ['--device', 'cpu'])
    assert str(got.value) == str(want.value) == \
        '--num-bands must be a power of two'
    assert os.listdir(tmp_path) == []


def test_sizing_equals_jax(jax_banded):
    # --sample-mem goes through the command line's memory parser
    from kevlar_tpu_torch.cli import memory_setting
    for text in ('4G', '64M', '1.5K', '300000', '42900000'):
        assert int(memory_setting(text)) == jax_banded.parse_mem(text)
    assert banded.device_mem_mb(torch.device('cpu')) is None

