"""The port's bench entries (``kevlar_tpu_torch.bench``) against the JAX
package's (``bench.py``, ``bench_call.py``, ``bench_configs.py``,
``tools/sim_trio_bench.py``).

Tolerance: none.  The entries' data (genomes, reads, loci, trio files)
must be byte-equal to the JAX entries' from the same seeds, and their
outputs (interesting k-mers, CIGARs and scores, truth VCFs, scores of a
call set) equal.  Sizes are cut where a whole entry runs here: the
entries' module constants for ``count_novel`` and ``call``, flags for
``configs``; ``sim_trio``'s workflow (a 50M mask) runs on the card only,
so its scoring is tested here on given VCFs.  JAX's ``bench_configs.main``
is never called (it writes ``BENCH_CONFIGS.json`` into the repository):
``configs``' keys are held to that file's.
"""

import functools
import gzip
import importlib.util
import json
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

import bench
import bench_call
import chip_smoke
import kevlar_tpu_torch
from kevlar_tpu_torch.bench import (bigsim, call, configs, control_plane,
                                    count_novel, helium_workflow_only,
                                    sim_trio, verify_e2e)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the entries' tests here cut their sizes to
SMALL_GENOME, SMALL_BATCH, SMALL_TABLESIZE = 20_000, 1024, 100_003


@pytest.fixture(autouse=True)
def _reset_logstream():
    """``cli.parse_args`` binds the port's log stream to the current
    stderr (a capture object under capsys): keep it test-local."""
    yield
    kevlar_tpu_torch.logstream = None
    kevlar_tpu_torch.teelog = False


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The entries' plain versions run thousands of small torch ops on
    the CPU; with several test workers on the cores, an intra-op thread
    pool spins at every op's barrier and a test takes minutes, not
    seconds.  One thread keeps each test's time its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_count_novel(monkeypatch):
    for mod in (bench, count_novel):
        monkeypatch.setattr(mod, 'GENOME_LEN', SMALL_GENOME)
        monkeypatch.setattr(mod, 'BATCH', SMALL_BATCH)
        monkeypatch.setattr(mod, 'TABLESIZE', SMALL_TABLESIZE)


@pytest.fixture
def jax_sim_trio():
    """``tools/sim_trio_bench.py``, loaded with the environment and
    ``sys.path`` it changes at import restored."""
    env = os.environ.get('KEVLAR_BATCH_READS')
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        'sim_trio_bench_jax', os.path.join(REPO, 'tools', 'sim_trio_bench.py'))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        if env is None:
            os.environ.pop('KEVLAR_BATCH_READS', None)
        else:
            os.environ['KEVLAR_BATCH_READS'] = env
    return mod


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()]


# ------------------------------------------------------------ count_novel

def test_count_novel_data_equals_bench_py():
    for name in ('KSIZE', 'READLEN', 'PADLEN', 'BATCH', 'GENOME_LEN',
                 'COVERAGE', 'TABLESIZE', 'CASEMIN', 'CTRLMAX'):
        assert getattr(count_novel, name) == getattr(bench, name), name
    # bench.py's main draws, with bench.py's own functions
    rng = np.random.default_rng(20260817)
    genome = bench.make_genome(rng, bench.GENOME_LEN)
    child = genome.copy()
    snvs = rng.choice(bench.GENOME_LEN - 100, size=20, replace=False) + 50
    child[snvs] = (child[snvs] + rng.integers(1, 4, size=len(snvs))) % 4
    want = [bench.tile_reads(child, bench.READLEN, bench.COVERAGE, rng)]
    want += [bench.tile_reads(genome, bench.READLEN, bench.COVERAGE, rng)
             for _ in range(2)]
    got = count_novel.bench_trio(count_novel.GENOME_LEN)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    rng_a, rng_b = (np.random.default_rng(7) for _ in range(2))
    assert (count_novel.make_genome(rng_a, 5000).tobytes() ==
            bench.make_genome(rng_b, 5000).tobytes())
    head = got[0][:20_000]
    assert count_novel.stack_all(head).tobytes() == \
        bench.stack_all(head).tobytes()
    for g, w in zip(count_novel.batches(head), bench.batches(head)):
        assert g.tobytes() == w.tobytes()


def test_chip_smoke_batch_shape_is_count_novel():
    assert (chip_smoke.BENCH_PADLEN, chip_smoke.BENCH_BATCH,
            chip_smoke.BENCH_TABLESIZE, chip_smoke.BENCH_CASEMIN,
            chip_smoke.BENCH_CTRLMAX) == (
        count_novel.PADLEN, count_novel.BATCH, count_novel.TABLESIZE,
        count_novel.CASEMIN, count_novel.CTRLMAX)


def test_device_pipeline_equals_jax(small_count_novel):
    import jax.numpy as jnp
    from kevlar_tpu.batch import pack_bases as jax_pack_bases
    from kevlar_tpu.ops import novel_ops as jax_novel_ops
    case, mom, dad = count_novel.bench_trio(SMALL_GENOME)
    _, got, (copy_s, program_s) = count_novel.device_pipeline(
        case, [mom, dad], device='cpu')
    assert copy_s >= 0 and program_s > 0

    stacks = [jax_pack_bases(bench.stack_all(r)) for r in (case, mom, dad)]
    lens = np.full((stacks[0][0].shape[0], SMALL_BATCH), bench.READLEN,
                   np.int32)
    lens.reshape(-1)[len(case):] = 0
    outs, _, _ = jax_novel_ops.count_and_screen_stack_packed(
        jnp.asarray(stacks[0][0]), jnp.asarray(stacks[0][1]),
        tuple(jnp.asarray(p) for p, _ in stacks[1:]),
        tuple(jnp.asarray(b) for _, b in stacks[1:]), jnp.asarray(lens),
        L=bench.PADLEN, ksize=bench.KSIZE, tablesize=SMALL_TABLESIZE,
        ntables=4, maxcount=255, casemin=bench.CASEMIN,
        ctrlmax=bench.CTRLMAX)
    want = int(jnp.sum(outs[2]))
    assert want > 0
    assert got == want
    assert count_novel.host_pipeline(case, [mom, dad])[1] == want
    assert bench.host_pipeline(case, [mom, dad])[1] == want


def test_count_novel_main_prints_bench_py_keys(small_count_novel, capsys):
    ret = count_novel.main(['--device', 'cpu'])
    out, err = capsys.readouterr()
    got = _json_lines(out)
    bench.main()
    jax_out, jax_err = capsys.readouterr()
    want = _json_lines(jax_out)
    assert len(got) == len(want) == 1
    assert list(got[0]) == list(want[0])
    assert got[0]['metric'] == want[0]['metric'] == 'count_novel_reads_per_s'
    assert got[0] == ret['result']
    pattern = r'\((\d+) interesting kmers\)'
    assert re.findall(pattern, err) == re.findall(pattern, jax_err) == [
        str(ret['interesting'])]
    assert '# device: cpu' in err


# ------------------------------------------------------------------- call

def test_call_loci_equal_bench_call():
    got = call.make_loci(random.Random(call.SEED), call.N_LOCI)
    want = bench_call.make_loci(random.Random(20260817))
    assert got == want
    assert (call.make_genome(random.Random(3), 500) ==
            bench_call.make_genome(random.Random(3), 500))


def test_call_align_batch_equals_jax():
    from kevlar_tpu.ops import align_ops
    from kevlar_tpu_torch import native
    from kevlar_tpu_torch.ops.align_cuda import align_batch
    partitions, cutouts = call.make_loci(random.Random(call.SEED), 8)
    contigs = [max(native.assemble(reads, min_overlap=45), key=len)
               for reads in partitions]
    targets = cutouts + cutouts
    queries = contigs + [c[::-1] for c in contigs]
    got = align_batch(targets, queries, device='cpu')
    want = align_ops.align_batch(targets, queries)
    assert [tuple(x) for x in got] == [tuple(x) for x in want]
    assert all(score > 0 for _, score in got[:8])


def test_call_main_prints_bench_call_metrics(monkeypatch, capsys):
    monkeypatch.setattr(call, 'N_LOCI', 4)
    monkeypatch.setattr(call, 'REP', 2)
    ret = call.main(['--device', 'cpu'])
    got = _json_lines(capsys.readouterr().out)
    monkeypatch.setattr(bench_call, 'make_loci',
                        functools.partial(bench_call.make_loci, n_loci=4))
    bench_call.main()
    want = _json_lines(capsys.readouterr().out)
    assert [list(x) for x in got] == [list(x) for x in want]
    assert [x['metric'] for x in got] == [x['metric'] for x in want] == [
        'assemble_call_contigs_per_s_host',
        'call_align_contigs_per_s_device',
        'call_align_contigs_per_s_device_batched']
    assert got == ret['results']
    assert len(ret['aligned']) == len(ret['targets']) == 8


# --------------------------------------------------------------- sim_trio

def test_sim_trio_files_equal_tools_sim_trio_bench(jax_sim_trio, tmp_path):
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    port_dir.mkdir()
    jax_dir.mkdir()
    seed = 20260818
    genome = sim_trio.write_genome(str(port_dir / 'genome.fa'), 200_000,
                                   seed)
    assert genome == jax_sim_trio.write_genome(str(jax_dir / 'genome.fa'),
                                               200_000, seed)
    variants = sim_trio.helium_trio(genome, 20, seed)
    jax_variants = jax_sim_trio.helium_trio(genome, 20, seed)
    sim_trio.write_trio(genome, variants, str(port_dir / 'trio'),
                        str(port_dir / 'truth.vcf'))
    jax_sim_trio.write_trio(genome, jax_variants, str(jax_dir / 'trio'),
                            str(jax_dir / 'truth.vcf'))
    names = ['genome.fa', 'truth.vcf'] + [
        'trio-{}.fasta'.format(who) for who in ('proband', 'mother',
                                                'father')]
    for name in names:
        assert (port_dir / name).read_bytes() == \
            (jax_dir / name).read_bytes(), name
    nreads = sim_trio.simulate_reads(
        str(port_dir / 'trio-proband.fasta'), str(port_dir / 'proband.fq'),
        5, 150, 0.005, seed)
    assert nreads == jax_sim_trio.simulate_reads(
        str(jax_dir / 'trio-proband.fasta'), str(jax_dir / 'proband.fq'),
        5, 150, 0.005, seed)
    assert (port_dir / 'proband.fq').read_bytes() == \
        (jax_dir / 'proband.fq').read_bytes()
    truth = sim_trio.denovo_truth(str(port_dir / 'truth.vcf'))
    assert truth == jax_sim_trio.denovo_truth(str(jax_dir / 'truth.vcf'))
    assert len(truth) == 5
    assert sorted(len(a) - len(r) for _, r, a in truth) == [0, 0, 0, 0, 300]


def test_sim_trio_scoring(tmp_path):
    truth = tmp_path / 'truth.vcf'
    rows = [('1001', 'A', 'G', 'GT=0/1,0/0,0/0'),
            ('2001', 'C', 'CTT', 'GT=1|0,0/0,0/0'),
            ('3001', 'G', 'T', 'GT=0/1,0/1,0/0'),
            ('4001', 'T', 'A', 'GT=0/1,0/0,0/0'),
            ('5001', 'T', 'C', 'ALTWINDOW=ACGT')]
    truth.write_text('##fileformat=VCFv4.2\n' + ''.join(
        'chr1\t{}\t.\t{}\t{}\t.\tPASS\t{}\t.\t.\n'.format(*row)
        for row in rows))
    final = tmp_path / 'final.vcf.gz'
    with gzip.open(final, 'wt') as fh:
        for row in [
                ('#CHROM', 'POS'),
                ('chr1', '1006', '.', 'A', 'G', '.', 'PASS', '.'),
                ('chr1', '2003', '.', 'C', 'CTT', '.', 'PASS', '.'),
                ('chr1', '2010', '.', 'C', 'T', '.', 'PASS', '.'),
                ('chr1', '3001', '.', 'G', 'T', '.', 'PASS', '.'),
                ('chr1', '4001', '.', 'T', 'A', '.', 'LikelihoodFail', '.'),
                ('chr1', '9000', '.', 'A', 'C', '.', 'PASS', '.')]:
            print('\t'.join(row), file=fh)
    assert sim_trio.denovo_truth(str(truth)) == [
        (1000, 'A', 'G'), (2000, 'C', 'CTT'), (4000, 'T', 'A')]
    found, fps, calls = sim_trio.score_calls(str(truth), str(final))
    # found: 1000 (5 bp off) and 2000 (the same length change); the call
    # at 2010 changes no length, 3001 is inherited, 9000 is far away
    assert (found, fps, len(calls)) == (2, 3, 5)


# ---------------------------------------------------------------- configs

def _repo_files():
    """(size, mtime) of every file under the repository that git would
    track or that an entry could write (build outputs and caches
    aside)."""
    skip_dirs = {'.git', '__pycache__', '.pytest_cache', '_build',
                 '_archive'}
    files = {}
    for root, dirs, names in os.walk(REPO):
        dirs[:] = [d for d in dirs if d not in skip_dirs]
        for name in names:
            if name.endswith(('.pyc', '.so', '.log')):
                continue
            path = os.path.join(root, name)
            st = os.stat(path)
            files[path] = (st.st_size, st.st_mtime_ns)
    return files


def test_configs_main_prints_bench_configs_keys(tmp_path, capsys):
    with open(os.path.join(REPO, 'BENCH_CONFIGS.json')) as fh:
        recorded = json.load(fh)
    before = _repo_files()
    cwd = os.getcwd()
    out = tmp_path / 'configs.json'
    art = configs.main(['--device', 'cpu', '--genome-size', '20000',
                        '--coverage', '10', '--memory', '4M', '--out',
                        str(out)])
    assert os.getcwd() == cwd
    assert _repo_files() == before
    lines = _json_lines(capsys.readouterr().out)
    assert lines == art['results']
    assert json.loads(out.read_text()) == art
    assert list(art) == list(recorded)
    assert (art['backend'], art['devices']) == ('cpu', 1)
    assert len(lines) == len(recorded['results']) == 5
    for got, want in zip(lines, recorded['results']):
        assert list(got) == list(want)
        assert (got['config'], got['metric'], got['unit']) == (
            want['config'], want['metric'], want['unit'])
        assert list(got['detail']) == list(want['detail'])
    assert lines[3]['detail']['align_engine'] == 'plain'
    assert lines[3]['detail']['denovo_total'] == 8
    assert lines[4]['detail']['output_identical_to_unsharded'] is True


@pytest.mark.parametrize('entry,argv', [
    (count_novel, []), (call, []), (configs, []), (sim_trio, []),
    (verify_e2e, []), (helium_workflow_only, ['.']), (control_plane, []),
    (bigsim, [])],
    ids=['count_novel', 'call', 'configs', 'sim_trio', 'verify_e2e',
         'helium_workflow_only', 'control_plane', 'bigsim'])
def test_entries_refuse_cuda_without_a_card(entry, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(SystemExit, match='no CUDA device'):
        entry.main(argv + ['--device', 'cuda'])
    assert capsys.readouterr().out == ''
