"""The port's mesh scaling tool (``kevlar_tpu_torch.bench.scaling``)
against the JAX package's (``tools/scaling_bench.py``), loaded from its
path, on the tests' 8 virtual CPU devices (``tests/conftest.py``).

Tolerance: none.  At a small batch (``B_TOTAL`` and ``SHARD_TABLESIZE``
patched in both), each worker must give the same keys and non-timing
values, and its case sketch, controls and screen hits must equal
``kevlar_tpu.parallel``'s after the same consumes of the same draw.  Both
``main``\\ s, their workers stubbed to the same rows, must derive the same
rows and print the same lines (the ``note`` says where the port ran).
One real two-rank gloo worker of the port must count what the one-process
mesh counts.  JAX's ``main`` writes ``SCALING.json`` next to its
``tools/``: its ``REPO`` is pointed at a temporary directory first.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kevlar_tpu_torch.bench import scaling

# _one_torch_thread: test_torch_bench.py's autouse fixture, one torch
# thread a test
from .test_torch_bench import _one_torch_thread, _repo_files  # noqa: F401
from .test_torch_bench_tools import _load_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_READS, SMALL_TABLESIZE = 256, 4096
# a worker's row: its keys in order, and those that are not timings
ROW_KEYS = ['devices', 'n_data', 'n_shard', 'reads_per_rep', 'reps',
            'consume_alltoall_s', 'consume_alltoall_reads_per_s',
            'consume_replicate_s', 'consume_replicate_reads_per_s',
            'screen_s', 'screen_reads_per_s']
COUNTED = ROW_KEYS[:5]
GLOO_TIMEOUT = 180


@pytest.fixture(scope='module')
def jax_scaling():
    return _load_tool('scaling_bench')


@contextlib.contextmanager
def _small(*modules):
    with pytest.MonkeyPatch.context() as mp:
        for mod in modules:
            mp.setattr(mod, 'B_TOTAL', SMALL_READS)
            mp.setattr(mod, 'SHARD_TABLESIZE', SMALL_TABLESIZE)
        yield mp


def _recording(mp, module):
    """Record the sketches ``module``'s worker makes and its last screen."""
    made, screens = [], []
    make, screen = module.ShardedSketch, module.sharded_novel_screen

    def sketch(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    def screened(*args, **kwargs):
        screens[:] = [screen(*args, **kwargs)]
        return screens[0]
    mp.setattr(module, 'ShardedSketch', sketch)
    mp.setattr(module, 'sharded_novel_screen', screened)
    return made, screens


# ---------------------------------------------------------------- worker

@pytest.mark.parametrize('n_data,n_shard', [(1, 8), (8, 1)],
                         ids=['shard_axis', 'data_axis'])
def test_worker_equals_jax(n_data, n_shard, jax_scaling, tmp_path):
    import kevlar_tpu.parallel as jax_parallel
    with _small(jax_scaling, scaling) as mp:
        jax_made, jax_screens = _recording(mp, jax_parallel)
        want = jax_scaling.worker(8, n_data, n_shard,
                                  str(tmp_path / 'jax.json'))
        made, screens = _recording(mp, scaling)
        got = scaling.worker(8, n_data, n_shard, str(tmp_path / 'port.json'),
                             device='cpu')
    assert list(got) == list(want) == ROW_KEYS
    assert {k: got[k] for k in COUNTED} == {k: want[k] for k in COUNTED} == \
        dict(devices=8, n_data=n_data, n_shard=n_shard,
             reads_per_rep=SMALL_READS, reps=2)
    assert json.loads((tmp_path / 'port.json').read_text()) == got
    assert all(got[k] > 0 for k in ROW_KEYS[5:])
    # case, mother, father: every consume of the draw counted alike
    assert len(made) == len(jax_made) == 3
    for mine, theirs in zip(made, jax_made):
        assert mine.mesh.shape == dict(theirs.mesh.shape)
        np.testing.assert_array_equal(mine._host(),
                                      np.asarray(theirs._host()))
    # the case saw 6 consumes of the draw, each control 2
    assert np.array_equal(made[0]._host(), 3 * made[1]._host())
    assert np.array_equal(made[1]._host(), made[2]._host())
    interesting, abunds, discard, _ = (np.asarray(x) for x in jax_screens[0])
    hits, hit_abunds, got_discard = (x.numpy() for x in screens[0])
    want_hits = np.flatnonzero(interesting)
    # casemin 2, ctrlmax 255: every valid window of every read is a hit
    assert len(want_hits) == SMALL_READS * (scaling.READLEN - scaling.KSIZE
                                            + 1)
    np.testing.assert_array_equal(hits, want_hits)
    np.testing.assert_array_equal(
        hit_abunds, abunds.reshape(abunds.shape[0], -1)[:, want_hits])
    np.testing.assert_array_equal(got_discard, discard)


def test_worker_constants_equal_jax(jax_scaling):
    for name in ('B_TOTAL', 'L', 'READLEN', 'KSIZE', 'SHARD_TABLESIZE',
                 'REPS'):
        assert getattr(scaling, name) == getattr(jax_scaling, name), name


# ------------------------------------------------------------------ main

def _row(ndev, n_data, n_shard):
    """A worker row whose walls grow with the mesh, as canned data."""
    cells = n_data * n_shard
    row = dict(devices=ndev, n_data=n_data, n_shard=n_shard,
               reads_per_rep=65536, reps=2)
    for i, key in enumerate(('consume_alltoall', 'consume_replicate',
                             'screen')):
        row[key + '_s'] = round(0.5 + 0.25 * i + 0.125 * cells, 3)
        row[key + '_reads_per_s'] = round(2 * 65536 / row[key + '_s'])
    return row


def _stubs(mp, module):
    calls = []

    def run_subprocess(ndev, n_data, n_shard, tag, tmpdir, *rest, **kw):
        calls.append(('subprocess', ndev, n_data, n_shard, tag))
        return _row(ndev, n_data, n_shard)

    def run_gloo(tmpdir, nproc, ndev_each, *rest, **kw):
        calls.append(('gloo', nproc, ndev_each))
        if nproc == 4:
            raise RuntimeError('gloo worker failed')
        return _row(nproc * ndev_each, 1, 8)
    mp.setattr(module, 'run_subprocess', run_subprocess)
    mp.setattr(module, 'run_gloo', run_gloo)
    return calls


def test_main_derives_jax_rows(jax_scaling, tmp_path, monkeypatch, capsys):
    import tempfile
    monkeypatch.setattr(jax_scaling, 'REPO', str(tmp_path))
    jax_calls = _stubs(monkeypatch, jax_scaling)
    with monkeypatch.context() as mp:
        # JAX's main leaves its temporary directory behind
        mp.setattr(tempfile, 'mkdtemp', lambda prefix='': str(tmp_path))
        mp.setattr(sys, 'argv', [jax_scaling.__file__])
        jax_scaling.main()
    want_lines = capsys.readouterr().out.splitlines()
    with open(tmp_path / 'SCALING.json') as fh:
        want = json.load(fh)

    calls = _stubs(monkeypatch, scaling)
    monkeypatch.chdir(REPO)
    before = _repo_files()
    got = scaling.main(['--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert _repo_files() == before and os.getcwd() == REPO
    assert calls == jax_calls
    assert lines == want_lines and len(lines) == 6
    assert list(got) == list(want)
    assert got.pop('note') != want.pop('note')
    assert json.loads(json.dumps(got)) == want
    assert got['gloo_4proc'] == {'error': 'gloo worker failed'}
    assert got['gloo_2proc']['vs_single_process_consume_alltoall'] == 1.0

    out = tmp_path / 'port.json'
    again = scaling.main(['--device', 'cpu', '--out', str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(again))
    assert '# wrote ' + str(out) in capsys.readouterr().err


# ------------------------------------------------------------------ gloo

RANK = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from kevlar_tpu_torch.bench import scaling
scaling.B_TOTAL, scaling.SHARD_TABLESIZE = {reads}, {tablesize}
made = []
make = scaling.ShardedSketch
scaling.ShardedSketch = lambda *a, **k: made.append(make(*a, **k)) or made[-1]
coord, pid, out, npz = sys.argv[1:5]
res = scaling.worker(2, 1, 4, out, distributed=(coord, 2, pid), device='cpu')
case = made[0]
np.savez(npz, **{{'{{}}_{{}}'.format(d, s): case.tables[d][s].numpy()
                  for d, s in case.mesh.local_cells()}})
with open(npz + '.json', 'w') as fh:
    json.dump(res, fh)
torch.distributed.destroy_process_group()
bad = [m for m in ('jax', 'kevlar_tpu') if m in sys.modules]
assert not bad, bad
"""


def test_two_rank_gloo_worker_counts_as_one_process(tmp_path):
    code = RANK.format(reads=SMALL_READS, tablesize=SMALL_TABLESIZE)
    coord = 'localhost:{}'.format(scaling._free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', code, coord, str(pid), str(tmp_path / 'out'),
         str(tmp_path / 'rank{}.npz'.format(pid))], cwd=str(tmp_path),
        env=env, stderr=subprocess.PIPE) for pid in range(2)]
    try:
        errs = [p.communicate(timeout=GLOO_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs

    with _small(scaling) as mp:
        made, _ = _recording(mp, scaling)
        one = scaling.worker(4, 1, 4, None, device='cpu')
    written = json.loads((tmp_path / 'out').read_text())
    assert list(written) == list(one) == ROW_KEYS
    assert {k: written[k] for k in COUNTED} == {k: one[k] for k in COUNTED}
    cells = {}
    for pid in range(2):
        with np.load(tmp_path / 'rank{}.npz'.format(pid)) as z:
            # two cells a rank, in rank order
            assert sorted(z.files) == ['0_{}'.format(2 * pid + i)
                                       for i in range(2)]
            cells.update({name: z[name] for name in z.files})
    for s in range(4):
        np.testing.assert_array_equal(cells['0_{}'.format(s)],
                                      made[0].tables[0][s].numpy())


# --------------------------------------------------------------- imports

@pytest.mark.parametrize('module', ['banded', 'scaling'])
def test_imports_no_jax(module):
    code = ('import sys\n'
            'import kevlar_tpu_torch.bench.{}\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in ('
            '"jax", "kevlar_tpu", "tools", "bigsim_bench", "sim_trio_bench", '
            '"banded_bench", "scaling_bench")]\n'
            'assert not bad, bad\n'
            'assert not any("/tools/" in (getattr(m, "__file__", None) or "")'
            ' for m in list(sys.modules.values())), "a tools/ module"\n'
            ).format(module)
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO)
