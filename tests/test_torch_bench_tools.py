"""The port's bench tools (``kevlar_tpu_torch.bench.verify_e2e``,
``.helium_workflow_only`` and ``.control_plane``) against the JAX
package's (``tools/verify_e2e.py``, ``tools/helium_workflow_only.py``,
``tools/control_plane_stress.py``), each JAX tool loaded from its path.

Tolerance: none.  The tools' data (tiled reads, the trio and its truth
VCF, the synthetic incidence, reads and seed hits) must be byte-equal to
the JAX tools' from the same seeds, and what they find (the PASS set, the
workflow's stage names and PASS calls, the component labels, partitions
and cutouts) equal.  Sizes are cut: the verify drive runs whole (a 20 kb
genome), the workflow on a 40 kb helium draw with 4M sketches, the
control plane at scale 0.02.  JAX's ``control_plane_stress.main`` is never
called (it writes ``CONTROL_PLANE.json`` into the repository): the port's
keys are held to that file's.
"""

import gzip
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch.bench import (control_plane, helium_workflow_only,
                                    sim_trio, verify_e2e)

# _one_torch_thread: test_torch_bench.py's autouse fixture, one torch
# thread a test
from .test_torch_bench import _one_torch_thread, _repo_files  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SCALE = 0.02


@pytest.fixture(autouse=True)
def _reset_logstreams():
    """``cli.parse_args`` of either package binds its log stream to the
    current stderr: keep both test-local."""
    import kevlar_tpu
    yield
    for pkg in (kevlar_tpu, kevlar_tpu_torch):
        pkg.logstream = None
        pkg.teelog = False


def _load_tool(name):
    """``tools/<name>.py`` as a module, with the ``sys.path`` and the
    ``KEVLAR_PLATFORM`` it changes at import restored."""
    path = list(sys.path)
    platform = os.environ.get('KEVLAR_PLATFORM')
    spec = importlib.util.spec_from_file_location(
        name + '_jax', os.path.join(REPO, 'tools', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        if platform is None:
            os.environ.pop('KEVLAR_PLATFORM', None)
        else:
            os.environ['KEVLAR_PLATFORM'] = platform
    return mod


# ------------------------------------------------------------ verify_e2e

def test_verify_drive_equals_tools_verify_e2e(tmp_path, monkeypatch,
                                             capsys):
    import kevlar_tpu.cli as jax_cli
    from kevlar_tpu import gentrio as jax_gentrio
    jax_verify = _load_tool('verify_e2e')
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    before = _repo_files()
    cwd = os.getcwd()
    ret = verify_e2e.main(['--device', 'cpu'])
    assert os.getcwd() == cwd
    assert _repo_files() == before
    out = capsys.readouterr().out.splitlines()
    workdir = ret['workdir']
    try:
        assert out[0] == 'verify workdir: ' + workdir
        assert out[-1] == 'VERIFY_PASS' and ret['ok']
        assert not workdir.startswith(REPO + os.sep)
        assert len(ret['truth_denovo']) == 3
        assert ret['passing'] == ret['truth_denovo']
        assert ret['truth_denovo'] == {
            (c, p, r, a) for c, p, r, a, info in jax_verify.vcf_rows(
                os.path.join(workdir, 'truth.vcf'))
            if 'GT=0/1,0/0,0/0' in info or 'GT=1/0,0/0,0/0' in info}

        # the trio and its truth from kevlar_tpu's gentrio, on the genome
        monkeypatch.chdir(tmp_path)
        shutil.copy(os.path.join(workdir, 'genome.fa'), 'genome.fa')
        jax_gentrio.main(jax_cli.parse_args([
            'gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio', '-i', '3',
            '-d', '3', '--weights', 'snv=1.0', '--seed', '11', 'genome.fa']))
        for name in ['truth.vcf'] + ['trio-{}.fasta'.format(who) for who in
                                     ('proband', 'mother', 'father')]:
            with open(os.path.join(workdir, name), 'rb') as fh:
                assert fh.read() == (tmp_path / name).read_bytes(), name
        # the reads: JAX's tiling of the same haplotypes
        for who in ('proband', 'mother', 'father'):
            jax_verify.tile_reads('trio-{}.fasta'.format(who), who + '.fq')
            with open(os.path.join(workdir, who + '.fq'), 'rb') as fh:
                assert fh.read() == (tmp_path / (who + '.fq')).read_bytes()
    finally:
        shutil.rmtree(workdir)


def test_verify_rows_and_tiling_equal_jax(tmp_path):
    jax_verify = _load_tool('verify_e2e')
    fasta = tmp_path / 'two.fa'
    fasta.write_text('>a\nACGTACGTAC\nGTTT\n>b\nGGGCCC\n>c\nACG\n')
    verify_e2e.tile_reads(str(fasta), str(tmp_path / 'port.fq'), readlen=5,
                          step=2)
    jax_verify.tile_reads(str(fasta), str(tmp_path / 'jax.fq'), readlen=5,
                          step=2)
    assert (tmp_path / 'port.fq').read_bytes() == \
        (tmp_path / 'jax.fq').read_bytes()
    vcf = tmp_path / 'x.vcf'
    vcf.write_text('##x\n#CHROM\nchr1\t5\t.\tA\tG\t.\tPASS\tLIKESCORE=3\n'
                   'chr2\t9\t.\tC\tT\t.\tInheritedFail\tGT=0/1\n')
    for passonly in (False, True):
        assert verify_e2e.vcf_rows(str(vcf), passonly) == \
            jax_verify.vcf_rows(str(vcf), passonly)


# -------------------------------------------------- helium_workflow_only

def _stub_run_mark1(seen, calls):
    """A workflow that records its configuration and writes a final VCF of
    ``calls`` (FILTER values) where the configuration's outdir says."""
    def run_mark1(config):
        seen.append(json.loads(json.dumps(config)))
        os.makedirs(config['outdir'], exist_ok=True)
        path = os.path.join(config['outdir'], 'calls.scored.sorted.vcf.gz')
        with gzip.open(path, 'wt') as fh:
            print('#CHROM\tPOS', file=fh)
            for pos, filt in enumerate(calls, 1):
                print('chr1\t{}\t.\tA\tG\t.\t{}\t.'.format(pos, filt),
                      file=fh)
        return path
    return run_mark1


def test_workflow_only_config_equals_jax(tmp_path, monkeypatch, capsys):
    from kevlar_tpu import workflow as jax_workflow
    from kevlar_tpu_torch import workflow
    jax_tool = _load_tool('helium_workflow_only')
    calls = ['PASS', 'LikelihoodFail', 'PASS', 'PASS']
    jax_seen, port_seen = [], []
    monkeypatch.setattr(jax_workflow, 'run_mark1',
                        _stub_run_mark1(jax_seen, calls))
    monkeypatch.setattr(workflow, 'run_mark1',
                        _stub_run_mark1(port_seen, calls))
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, 'argv', ['helium_workflow_only.py',
                                      str(tmp_path), '25'])
    jax_tool.main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    monkeypatch.chdir(REPO)
    before = _repo_files()
    got = helium_workflow_only.main([str(tmp_path), '25', '--device', 'cpu'])
    assert os.getcwd() == REPO
    assert _repo_files() == before
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1]) == got
    assert '# device: cpu' in err
    assert len(jax_seen) == len(port_seen) == 1
    assert port_seen[0].pop('device') == 'cpu'
    assert port_seen[0] == jax_seen[0]
    assert list(got) == list(want) == ['metric', 'wall_s', 'peak_rss_mb',
                                       'pass_calls', 'stage_wall_s']
    assert got['metric'] == want['metric'] == 'helium_workflow_only'
    assert got['pass_calls'] == want['pass_calls'] == 3


def _helium_draw(workdir, genome_size=40_000, coverage=30, seed=20260818):
    """A small draw of ``sim_trio --preset helium``: genome.fa, the trio's
    reads and the truth VCF in ``workdir``."""
    here = os.getcwd()
    os.chdir(workdir)
    try:
        genome = sim_trio.write_genome('genome.fa', genome_size, seed)
        sim_trio.write_trio(genome, sim_trio.helium_trio(genome, 5, seed),
                            'trio', 'truth.vcf')
        for i, who in enumerate(('proband', 'mother', 'father')):
            sim_trio.simulate_reads('trio-{}.fasta'.format(who), who + '.fq',
                                    coverage, 150, 0.005, seed + 7 * i)
    finally:
        os.chdir(here)


def test_workflow_only_run_equals_jax(tmp_path, monkeypatch, capsys):
    from kevlar_tpu import workflow as jax_workflow
    from kevlar_tpu_torch import workflow
    _helium_draw(str(tmp_path))
    run_mark1 = workflow.run_mark1
    seen = []

    def small_run(config):
        # the helium sketches (500M, a 50M mask) shrunk for the CPU
        config = json.loads(json.dumps(config))
        for sample in [config['case'], config['mask']] + config['controls']:
            sample['memory'] = '4M'
        seen.append(config)
        # run_mark1 sets its stage walls on the module's run_mark1: this
        return run_mark1(config)

    monkeypatch.setattr(workflow, 'run_mark1', small_run)
    got = helium_workflow_only.main([str(tmp_path), '--device', 'cpu'])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    assert seen[0]['simlike'] == {'mu': 30, 'sigma': 9.0, 'epsilon': 0.001}

    monkeypatch.chdir(tmp_path)
    config = {k: v for k, v in seen[0].items() if k != 'device'}
    final = jax_workflow.run_mark1(dict(config, outdir='jax_out'))
    assert list(got['stage_wall_s']) == [
        stage for stage, _ in jax_workflow.run_mark1.last_stage_times]
    assert got['pass_calls'] == helium_workflow_only.count_pass(final) > 0
    assert got['wall_s'] > 0 and got['peak_rss_mb'] > 0


# --------------------------------------------------------- control_plane

@pytest.fixture(scope='module')
def jax_control_plane():
    return _load_tool('control_plane_stress')


@pytest.mark.parametrize('scale', [SMALL_SCALE, 1.0])
def test_control_plane_incidence_and_labels_equal_jax(jax_control_plane,
                                                      scale):
    from kevlar_tpu.ops import cc_ops as jax_cc_ops
    from kevlar_tpu_torch.ops import cc_ops
    got = control_plane.cc_incidence(scale)
    want = jax_control_plane.synth_incidence(
        np.random.default_rng(7), int(1500 * scale), 12, 20)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(g, w)
    reads, kmers, n_reads, n_kmers = got
    host = cc_ops.host_connected_components(reads, kmers, n_reads, n_kmers)
    assert np.array_equal(host, jax_cc_ops.host_connected_components(
        reads, kmers, n_reads, n_kmers))
    assert np.array_equal(host, np.asarray(
        jax_cc_ops.connected_components_bipartite_jit(
            reads, kmers, n_reads=n_reads, n_kmers=n_kmers)))
    assert np.array_equal(host, control_plane.device_labels(
        reads, kmers, n_reads, n_kmers, 'cpu'))


def test_control_plane_stages_equal_jax(jax_control_plane):
    got = control_plane.bench_partition_stage(SMALL_SCALE, 'cpu')
    want = jax_control_plane.bench_partition_stage(SMALL_SCALE)
    assert list(got) == list(want)
    assert (got['reads'], got['partitions_found']) == \
        (want['reads'], want['partitions_found'])
    assert got['partitions_found'] > 0
    got = control_plane.bench_localize_cluster(SMALL_SCALE)
    want = jax_control_plane.bench_localize_cluster(SMALL_SCALE)
    assert list(got) == list(want)
    assert (got['seed_hits'], got['cutouts']) == \
        (want['seed_hits'], want['cutouts']) == (1000, 1000)


def _keys(obj):
    """The keys of a JSON object and of the objects in it, in order."""
    return [(key, _keys(value) if isinstance(value, dict) else None)
            for key, value in obj.items()]


def test_control_plane_main_prints_jax_keys(jax_control_plane, tmp_path,
                                            capsys):
    with open(os.path.join(REPO, 'CONTROL_PLANE.json')) as fh:
        recorded = json.load(fh)
    before = _repo_files()
    cwd = os.getcwd()
    got = control_plane.main(['--device', 'cpu', '--scale', str(SMALL_SCALE)])
    out, err = capsys.readouterr()
    assert _repo_files() == before and os.getcwd() == cwd
    assert json.loads(out) == got
    assert '# wrote' not in err
    assert _keys(got) == _keys(recorded)
    assert (got['suite'], got['scale_vs_bigsim']) == (
        'control_plane_stress', SMALL_SCALE)
    # the bigsim-scale incidence is the same draw whatever the scale
    assert {k: got['cc_bigsim_scale'][k] for k in
            ('incidences', 'reads', 'partitions')} == {
        k: recorded['cc_bigsim_scale'][k] for k in
        ('incidences', 'reads', 'partitions')}
    assert _keys(got['cc_human_scale']) == _keys(
        jax_control_plane.bench_cc(SMALL_SCALE))

    path = tmp_path / 'cp.json'
    again = control_plane.main(['--device', 'cpu', '--scale',
                                str(SMALL_SCALE), '--out', str(path)])
    assert json.loads(path.read_text()) == again
    assert '# wrote ' + str(path) in capsys.readouterr().err
    assert _repo_files() == before
