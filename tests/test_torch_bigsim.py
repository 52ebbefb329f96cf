"""The port's bigsim run and its forensics
(``kevlar_tpu_torch.bench.bigsim``, ``.miss_forensics``) against the JAX
package's tools (``tools/bigsim_bench.py``, ``tools/miss_forensics.py``),
each JAX tool loaded from its path.

Tolerance: none.  The scorers must give the JAX tool's results on every
case (and the values ``tests/test_bigsim_eval.py`` pins), the generated
genomes must be byte-equal, and one small run of each whole entry (a 200
kb class-balanced trio at 15x; ``filter``'s fixed ``-M 1G`` shrunk to 4M
for the CPU in both) must leave byte-equal files, equal evaluations, the
same keys and the same forensics.  JAX's ``main`` always gets ``--out``
under a temporary directory: its default writes into the repository.
"""

import contextlib
import gzip
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch.bench import bigsim, miss_forensics

# _one_torch_thread: test_torch_bench.py's autouse fixture, one torch
# thread a test
from .test_torch_bench import _one_torch_thread, _repo_files  # noqa: F401
from .test_torch_bench_tools import _load_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, 'tools')
# the small run: 1/400 of the tool's genome at half its coverage, the
# six classes balanced
SMALL = ['--genome-size', '200000', '--coverage', '15', '--denovo', '8',
         '--inherited', '6', '--class-balanced']
FILTER_MEMORY = '4M'
# the files a run leaves that must be byte-equal (##fileDate aside)
RUN_FILES = ('genome.fa', 'truth.vcf', 'proband.fq', 'mother.fq',
             'father.fq', 'novel.augfastq', 'filtered.augfastq',
             'partitioned.augfastq', 'calls.vcf', 'scored.vcf')


@contextlib.contextmanager
def _jax_tools():
    """``sys.path`` with ``tools/`` on it (JAX's ``main`` imports
    ``sim_trio_bench``, its forensics ``bigsim_bench``), and afterwards
    ``sys.path``, ``KEVLAR_BATCH_READS`` (set by both at import), the
    working directory and ``sys.modules`` as they were."""
    path = list(sys.path)
    env = os.environ.get('KEVLAR_BATCH_READS')
    cwd = os.getcwd()
    modules = set(sys.modules)
    sys.path.insert(0, TOOLS)
    try:
        yield
    finally:
        sys.path[:] = path
        if env is None:
            os.environ.pop('KEVLAR_BATCH_READS', None)
        else:
            os.environ['KEVLAR_BATCH_READS'] = env
        os.chdir(cwd)
        for name in set(sys.modules) - modules:
            if name in ('bigsim_bench', 'sim_trio_bench'):
                del sys.modules[name]


def _jax_tool(name):
    with _jax_tools():
        return _load_tool(name)


@pytest.fixture(scope='module')
def jax_bigsim():
    return _jax_tool('bigsim_bench')


def _small_filter(timed_stage):
    """``timed_stage`` with ``filter``'s ``-M 1G`` (a 4 GB int32
    accumulator on the CPU) cut to :data:`FILTER_MEMORY`."""
    def stage(arglist, *rest):
        arglist = [str(a) for a in arglist]
        if arglist[0] == 'filter':
            arglist[arglist.index('-M') + 1] = FILTER_MEMORY
        return timed_stage(arglist, *rest)
    return stage


def _reset_logstreams():
    import kevlar_tpu
    for pkg in (kevlar_tpu, kevlar_tpu_torch):
        pkg.logstream = None
        pkg.teelog = False


def _stdout_of(fn, *args):
    """``fn(*args)``'s return value and its standard output's lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue().splitlines()


def _jax_main(mod, argv):
    """A JAX tool's ``main`` with ``argv`` as its command line; returns
    its standard output's lines."""
    saved = sys.argv
    sys.argv = [mod.__file__] + [str(a) for a in argv]
    try:
        with _jax_tools():
            return _stdout_of(mod.main)[1]
    finally:
        sys.argv = saved
        _reset_logstreams()


# --------------------------------------------------------------- scorers

def _write_vcf(path, rows):
    with open(path, 'w') as fh:
        fh.write('##fileformat=VCFv4.2\n')
        fh.write('#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n')
        for row in rows:
            fh.write('\t'.join(str(x) for x in row) + '\n')


def _case_truth_rows(mod, tmp_path):
    vcf = tmp_path / 'truth.vcf'
    _write_vcf(vcf, [
        # de novo SNV (child het, both parents hom-ref)
        ('chrS', 101, '.', 'A', 'C', '.', '.', 'GT=0/1,0/0,0/0'),
        # inherited -> excluded
        ('chrS', 201, '.', 'G', 'T', '.', '.', 'GT=0/1,0/1,0/0'),
        # de novo 30 bp insertion
        ('chrS', 301, '.', 'T', 'T' + 'A' * 30, '.', '.', 'GT=1/0,0/0,0/0'),
        # de novo 12 bp deletion
        ('chrS', 401, '.', 'C' + 'G' * 12, 'C', '.', '.', 'GT=0/1,0/0,0/0'),
    ])
    rows = mod.truth_rows(str(vcf))
    assert rows == [(100, 'SNV', 0), (300, 'INDEL', 30), (400, 'INDEL', 12)]
    return rows


def _case_matching_and_collisions(mod, tmp_path):
    truth = [(100, 'SNV', 0), (300, 'INDEL', 30), (5000, 'INDEL', 150)]
    vcf = tmp_path / 'scored.vcf'
    _write_vcf(vcf, [
        # exact SNV hit
        ('chrS', 101, '.', 'A', 'C', '.', 'PASS', 'LIKESCORE=200'),
        # second call on the same SNV -> collision, not a new TP
        ('chrS', 105, '.', 'G', 'T', '.', 'PASS', 'LIKESCORE=150'),
        # insertion called 8 bp off -> inside tolerance 10
        ('chrS', 309, '.', 'T', 'T' + 'A' * 30, '.', 'PASS', 'LIKESCORE=90'),
        # far from any truth row -> FP (SNV-shaped)
        ('chrS', 9000, '.', 'A', 'G', '.', 'PASS', 'LIKESCORE=50'),
        # non-PASS calls never count, even on a truth position
        ('chrS', 5001, '.', 'C', 'C' + 'G' * 150, '.', 'ControlAbundance',
         'LIKESCORE=999'),
    ])
    ev = mod.evaluate(truth, str(vcf))
    assert (ev['tp'], ev['fp'], ev['collisions'], ev['total_truth']) == \
        (2, 1, 1, 3)
    assert ev['recall'] == round(2 / 3, 4)
    assert ev['fdr'] == round(1 / 3, 4)
    per = ev['per_class']
    assert per['SNVs'] == dict(total=1, tp=1, fp=0, recall=1.0)
    assert per['INDELs 11-100bp']['tp'] == 1
    # the filtered 150 bp indel was never matched
    assert per['INDELs 101-200bp'] == dict(total=1, tp=0, fp=0, recall=0.0)
    return ev


def _case_reference_compaction(mod, tmp_path):
    truth = [(100, 'SNV', 0), (300, 'INDEL', 30)]
    calls = [
        # class 7: first call misses, second matches -> keep the match
        (500, 90.0, '7', 1), (305, 80.0, '7', 31),
        # class 8: no call matches -> keep first in order; it's an FP
        (900, 70.0, '8', 1), (950, 60.0, '8', 1),
        # classless call matching the SNV point within delta
        (95, 50.0, None, 1),
        # LIKESCORE <= 0 compacted away
        (100, 0.0, None, 1),
    ]
    ev = mod.evaluate_reference_protocol(truth, calls)
    assert ev['calls_compacted'] == 3
    assert ev['tp'] == 2 and ev['fp'] == 1 and ev['missing'] == 0
    assert ev['calls_correct'] == 2
    assert ev['per_class']['INDELs 11-100bp']['tp'] == 1
    return ev


def _case_tolerance_boundary(mod, tmp_path):
    truth = [(1000, 'SNV', 0)]
    hit = tmp_path / 'hit.vcf'
    # call interval [1010, 1011): 1010 - 10 < 1001 and 1000 - 10 < 1011
    _write_vcf(hit, [('chrS', 1011, '.', 'A', 'C', '.', 'PASS',
                      'LIKESCORE=10')])
    got = mod.evaluate(truth, str(hit))
    assert got['tp'] == 1
    miss = tmp_path / 'miss.vcf'
    # call interval [1011, 1012): 1011 - 10 = 1001 is not < 1001 -> miss
    _write_vcf(miss, [('chrS', 1012, '.', 'A', 'C', '.', 'PASS',
                       'LIKESCORE=10')])
    ev = mod.evaluate(truth, str(miss))
    assert ev['tp'] == 0 and ev['fp'] == 1
    return got, ev


def _case_truth_tsv(mod, tmp_path):
    path = tmp_path / 'truth.tsv.gz'
    with gzip.open(path, 'wt') as fh:
        # a deletion listed by its last base, an insertion, an SNV, and a
        # blank line
        fh.write('5012\tDel\t12\n7000\tIns\t45\n\n9001\tA\tC\tSNV\n')
    rows = mod.load_truth_tsv(str(path))
    assert rows == [(5000, 'INDEL', 12), (7000, 'INDEL', 45),
                    (9001, 'SNV', 0)]
    return rows


def _case_pass_calls(mod, tmp_path):
    vcf = tmp_path / 'calls.vcf'
    _write_vcf(vcf, [
        ('chrS', 101, '.', 'A', 'C', '.', 'PASS',
         'CALLCLASS=3;LIKESCORE=12.5'),
        # not PASS
        ('chrS', 201, '.', 'A', 'C', '.', 'LikelihoodFail', 'LIKESCORE=9'),
        # no position
        ('chrS', '.', '.', '.', '.', '.', 'PASS', 'CALLCLASS=4'),
        # no LIKESCORE, no CALLCLASS: -inf and None
        ('chrS', 301, '.', 'T', 'TAAAA', '.', 'PASS', 'IKMERS=3'),
        ('chrS', 401, '.', 'CGGGGGG', 'C', '.', 'PASS',
         'CALLCLASS=5;LIKESCORE=-3.0'),
    ])
    plain = mod.read_pass_calls(str(vcf))
    with open(vcf, 'rb') as src, gzip.open(str(vcf) + '.gz', 'wb') as dst:
        dst.write(src.read())
    assert mod.read_pass_calls(str(vcf) + '.gz') == plain
    assert plain == [(100, 12.5, '3', 1), (300, float('-inf'), None, 5),
                     (400, -3.0, '5', 7)]
    return plain


SCORER_CASES = {
    'truth_rows': _case_truth_rows,
    'matching_and_collisions': _case_matching_and_collisions,
    'reference_compaction': _case_reference_compaction,
    'tolerance_boundary': _case_tolerance_boundary,
    'truth_tsv': _case_truth_tsv,
    'pass_calls': _case_pass_calls,
}


@pytest.mark.parametrize('impl', ['jax', 'port'])
@pytest.mark.parametrize('case', list(SCORER_CASES))
def test_scorers(case, impl, jax_bigsim, tmp_path):
    mod = jax_bigsim if impl == 'jax' else bigsim
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'mod').mkdir()
    got = SCORER_CASES[case](mod, tmp_path / 'mod')
    assert got == SCORER_CASES[case](jax_bigsim, tmp_path / 'jax')


def test_scorer_constants_equal_jax(jax_bigsim):
    assert bigsim.SIZE_CLASSES == jax_bigsim.SIZE_CLASSES
    for vartype, size in [('SNV', 0), ('INDEL', 1), ('INDEL', 10),
                          ('INDEL', 11), ('INDEL', 400), ('INDEL', 401),
                          ('SNV', 3)]:
        assert bigsim.classify(vartype, size) == \
            jax_bigsim.classify(vartype, size)
    # the published anchors need the reference's notebook directory
    assert bigsim.score_reference_calls() is None
    assert bigsim.reference_operating_point() is None


# ------------------------------------------------------------ generators

@pytest.mark.parametrize('repeats', [False, True], ids=['uniform',
                                                        'repeats'])
def test_generators_equal_jax(repeats, jax_bigsim, tmp_path):
    # 300 kb: segmental duplications are 20-50 kb blocks
    size, seed = 300_000, 20260820
    got, want = tmp_path / 'port.fa', tmp_path / 'jax.fa'
    if repeats:
        got_stats, want_stats = {}, {}
        bigsim.simulate_repeat_genome(str(got), size, seed, got_stats)
        jax_bigsim.simulate_repeat_genome(str(want), size, seed, want_stats)
        assert got_stats == want_stats
        assert list(got_stats) == ['SINE', 'LINE', 'tandem', 'segdup']
    else:
        bigsim.simulate_genome(str(got), size, seed)
        jax_bigsim.simulate_genome(str(want), size, seed)
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_bytes()) == len(b'>chrS\n') + size + 1


# ----------------------------------------------------- one run, end to end

@pytest.fixture(scope='module')
def runs(jax_bigsim, tmp_path_factory):
    """One small run of each entry: JAX's with ``--out`` under a temporary
    directory, the port's with no ``--out`` from the repository's root
    (the repository's files before and after)."""
    jax_dir = tmp_path_factory.mktemp('jax_bigsim')
    port_dir = tmp_path_factory.mktemp('port_bigsim')
    jax_out = jax_dir / 'result.json'
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bigsim, 'timed_stage',
                   _small_filter(jax_bigsim.timed_stage))
        mp.setattr(bigsim, 'timed_stage', _small_filter(bigsim.timed_stage))
        jax_lines = _jax_main(jax_bigsim, SMALL + [
            '--workdir', jax_dir / 'work', '--out', jax_out])
        cwd = os.getcwd()
        os.chdir(REPO)
        try:
            before = _repo_files()
            got, port_lines = _stdout_of(bigsim.main, SMALL + [
                '--device', 'cpu', '--workdir', str(port_dir / 'work')])
            after = _repo_files()
            port_cwd = os.getcwd()
        finally:
            os.chdir(cwd)
            _reset_logstreams()
            torch.set_num_threads(threads)
    with open(jax_out) as fh:
        want = json.load(fh)
    return dict(jax_dir=jax_dir / 'work', port_dir=port_dir / 'work',
                want=want, jax_lines=jax_lines, got=got,
                port_lines=port_lines, repo_unchanged=before == after,
                port_cwd=port_cwd)


def _without_filedate(path):
    with open(path, 'rb') as fh:
        return [line for line in fh if not line.startswith(b'##fileDate')]


@pytest.mark.parametrize('name', RUN_FILES)
def test_run_files_equal_jax(name, runs):
    got = _without_filedate(os.path.join(runs['port_dir'], name))
    assert got, name
    assert got == _without_filedate(os.path.join(runs['jax_dir'], name))


def test_run_evaluations_equal_jax(runs):
    got, want = runs['got'], runs['want']
    for key in ('evaluation', 'evaluation_reference_protocol',
                'reads_per_sample', 'denovo_in_truth', 'sketch_memory',
                'repeat_composition', 'reference_30x_scored',
                'reference_30x_operating_point'):
        assert got[key] == want[key], key
    ev = got['evaluation']
    assert ev['total_truth'] == 8 and ev['tp'] > 0
    # the class-balanced draw reaches every class
    assert all(c['total'] > 0 for c in ev['per_class'].values())
    assert got['evaluation_reference_protocol']['missing'] > 0
    assert got['backend'] == 'cpu'
    assert list(got['wall_s']) == list(want['wall_s'])


def test_run_keys_equal_jax(runs):
    got, want = runs['got'], runs['want']
    assert list(got) == list(want)
    last, jax_last = (json.loads(runs['port_lines'][-1]),
                      json.loads(runs['jax_lines'][-1]))
    assert list(last) == list(jax_last) == [
        'metric', 'value', 'unit', 'fdr', 'total_wall_s']
    assert last['metric'] == 'bigsim_recall'
    assert (last['value'], last['fdr'], last['total_wall_s']) == (
        got['evaluation']['recall'], got['evaluation']['fdr'],
        got['total_wall_s'])
    assert len(runs['port_lines']) == len(runs['jax_lines']) == 1


def test_run_writes_nothing_into_the_repo(runs):
    assert runs['repo_unchanged']
    assert runs['port_cwd'] == REPO
    assert not os.path.exists(os.path.join(runs['port_dir'], 'result.json'))


def test_main_writes_only_out(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    before = _repo_files()
    out = tmp_path / 'bigsim.json'
    got = bigsim.main(['--genome-size', '30000', '--coverage', '5',
                       '--denovo', '2', '--inherited', '1', '--device',
                       'cpu', '--workdir', str(tmp_path / 'work'),
                       '--out', str(out)])
    assert _repo_files() == before and os.getcwd() == REPO
    assert json.loads(out.read_text()) == got
    assert '# wrote ' + str(out) in capsys.readouterr().err


# -------------------------------------------------------------- forensics

def test_forensics_equal_jax(runs, tmp_path):
    jax_tool = _jax_tool('miss_forensics')
    want_path = tmp_path / 'jax.json'
    jax_lines = _jax_main(jax_tool, [runs['jax_dir'], '--out', want_path])
    with open(want_path) as fh:
        want = json.load(fh)
    before = _repo_files()
    got, lines = _stdout_of(miss_forensics.main, [str(runs['port_dir'])])
    assert _repo_files() == before
    assert os.listdir(tmp_path) == ['jax.json']
    for key in ('by_stage', 'by_class_stage', 'misses', 'n_truth', 'n_miss',
                'delta', 'k'):
        assert json.loads(json.dumps(got[key])) == want[key], key
    assert list(got) == list(want)
    assert got['n_miss'] == \
        runs['got']['evaluation_reference_protocol']['missing']
    assert sum(got['by_stage'].values()) == got['n_miss'] > 0
    printed, jax_printed = (json.loads('\n'.join(lines)),
                            json.loads('\n'.join(jax_lines)))
    assert printed.pop('workdir') == str(runs['port_dir'])
    jax_printed.pop('workdir')
    assert printed == jax_printed
    assert printed['misses'] == '[{} rows]'.format(got['n_miss'])


def test_forensics_imports_no_torch():
    code = ('import sys\n'
            'import kevlar_tpu_torch.bench.miss_forensics\n'
            'bad = [m for m in ("torch", "jax", "kevlar_tpu") '
            'if m in sys.modules]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO)


# --------------------------------------------------------------- rescore

def test_rescore_line_equals_jax(runs, jax_bigsim, tmp_path, monkeypatch):
    jax_out = tmp_path / 'jax.json'
    jax_lines = _jax_main(jax_bigsim, ['--rescore', runs['jax_dir'],
                                       '--out', jax_out])
    monkeypatch.chdir(REPO)
    before = _repo_files()
    work_before = sorted(os.listdir(runs['port_dir']))
    got, lines = _stdout_of(bigsim.main, ['--rescore',
                                          str(runs['port_dir'])])
    assert _repo_files() == before
    assert sorted(os.listdir(runs['port_dir'])) == work_before
    assert lines == jax_lines
    assert list(json.loads(lines[-1])) == [
        'metric', 'value', 'unit', 'fdr', 'recall_reference_protocol']
    with open(jax_out) as fh:
        assert got == json.load(fh)

    # with --out: the recorded walls kept, the evaluations rewritten
    out = tmp_path / 'port.json'
    record = dict(runs['got'], evaluation=None)
    out.write_text(json.dumps(record))
    again = bigsim.main(['--rescore', str(runs['port_dir']), '--out',
                         str(out)])
    assert json.loads(out.read_text()) == again
    assert again['wall_s'] == runs['got']['wall_s']
    assert again['evaluation'] == runs['got']['evaluation']

