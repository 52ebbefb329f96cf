"""The port's sandbox tools and BAM driver against ``kevlar_tpu``'s.

Tolerance: none.  On tests/test_sandbox.py's inputs both packages must print
the same text and write the same files (``subsketch``'s tables compared as
arrays; the port runs it with ``--device cpu``, the plain PyTorch versions
of its kernels).  The BAM driver is held to ``kevlar_tpu``'s command lines
through stub ``samtools``/``fastp``/``lighter`` scripts that record their
arguments; no real tool is run or needed.
"""

import random
import stat
import sys

import numpy as np
import pytest

import kevlar_tpu
from kevlar_tpu.sandbox import compact as jax_compact
from kevlar_tpu.sandbox import get_partitions as jax_get_partitions
from kevlar_tpu.sandbox import subsketch as jax_subsketch
from kevlar_tpu.sequence import Record, print_augmented_fastx
from kevlar_tpu.sketch import Sketch as JaxSketch
from kevlar_tpu.workflows import bam_preproc as jax_bam_preproc
from kevlar_tpu_torch.sandbox import compact, get_partitions, subsketch
from kevlar_tpu_torch.workflows import bam_preproc

from . import simdata


def _write_calls(path):
    with open(path, 'w') as fh:
        kevlar_tpu.vcf_header(fh, source='test')
        fh.write('chr1\t1000\t.\tA\tC\t.\tPASS\t'
                 'LIKESCORE=200.0;CALLCLASS=1\n')
        fh.write('chr1\t1003\t.\tA\tG\t.\tPASS\t'
                 'LIKESCORE=100.0;CALLCLASS=1\n')
        fh.write('chr1\t9000\t.\tT\tG\t.\tPASS\t'
                 'LIKESCORE=50.0;CALLCLASS=2\n')
        fh.write('chr1\t4990\t.\tT\tGA\t.\tPASS\t'
                 'LIKESCORE=70.0;CALLCLASS=3\n')


@pytest.mark.parametrize('delta', [None, '0'])
def test_compact_matches_jax(tmp_path, capsys, delta):
    bed = tmp_path / 'truth.bed'
    bed.write_text('chr1\t999\t1000\nchr1\t4999\t5000\n')
    calls = tmp_path / 'calls.vcf'
    _write_calls(calls)
    argv = ([] if delta is None else ['--delta', delta]) + \
        [str(bed), str(calls)]
    jax_compact.main(argv)
    want = capsys.readouterr().out
    compact.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert 'EVAL=True' in want and 'EVAL=False' in want


def _ann_read(name, seq, kmers):
    r = Record(name=name, sequence=seq, quality='I' * len(seq))
    for k, o in kmers:
        r.annotate(k, o, (9, 0, 0))
    return r


def test_get_partitions_matches_jax(tmp_path, capsys):
    seq = 'ACGTACGTACGTACGTACGTACGTACGTAC'
    aug = tmp_path / 'parts.augfastq'
    with open(aug, 'w') as fh:
        for pid in (1, 2, 3):
            for i in range(2):
                read = _ann_read('r{}-{} kvcc={}'.format(pid, i, pid),
                                 seq, [(seq[:21], 0)])
                print_augmented_fastx(read, fh)
    printed = {}
    for tool, tag in ((jax_get_partitions, 'jax'), (get_partitions, 'port')):
        tool.main(['-o', str(tmp_path / (tag + '.sel')), str(aug), '1', '3'])
        tool.main(['-p', str(tmp_path / (tag + '.part{}.fq')), str(aug),
                   '2', '3'])
        tool.main([str(aug), '2'])
        printed[tag] = capsys.readouterr().out
    assert printed['port'] == printed['jax']
    assert 'kvcc=2' in printed['jax'] and 'kvcc=1' not in printed['jax']
    for name in ('{}.sel', '{}.part2.fq', '{}.part3.fq'):
        want = (tmp_path / name.format('jax')).read_text()
        assert (tmp_path / name.format('port')).read_text() == want
        assert want
    assert 'kvcc=2' not in (tmp_path / 'port.sel').read_text()
    with pytest.raises(ValueError):
        get_partitions.main(['-o', 'x', '-p', 'y{}', str(aug), '1'])


@pytest.mark.parametrize('flags', [
    ['--table-size', '9973'],
    ['--sketch-type', 'smallcounttable', '--table-size', '5003'],
    ['--sketch-type', 'nodetable', '--num-tables', '3'],
    ['--sketch-type', 'countgraph', '--table-size', '9973']],
    ids=['counttable', 'smallcounttable', 'nodetable', 'countgraph'])
def test_subsketch_matches_jax(tmp_path, capsys, flags):
    rng = random.Random(99)
    genome = simdata.make_genome(rng, 500)
    src = JaxSketch(21, 100003, 4, counter_bits=8, backend='host')
    for _ in range(5):
        src.consume(genome)
    srcfile = str(tmp_path / 'src.ct')
    src.save(srcfile)
    ext = '.cg' if 'countgraph' in flags else \
        '.sct' if 'smallcounttable' in flags else \
        '.nt' if 'nodetable' in flags else '.ct'
    want, got = str(tmp_path / ('jax' + ext)), str(tmp_path / ('port' + ext))
    segments = [genome[100:160], genome[300:340]]
    jax_subsketch.main(flags + [srcfile, want] + segments)
    want_out = capsys.readouterr().out
    subsketch.main(flags + ['--device', 'cpu', srcfile, got] + segments)
    assert capsys.readouterr().out == want_out
    assert 'Estimated FPR' in want_out
    if ext == '.cg':  # khmer format: the same bytes
        with open(want, 'rb') as fh, open(got, 'rb') as gh:
            assert gh.read() == fh.read()
        return
    with np.load(want) as w, np.load(got) as g:
        assert np.array_equal(g['tables'], w['tables'])
        for key in ('ksize', 'tablesize', 'ntables', 'counter_bits'):
            assert int(g[key]) == int(w[key])
        assert w['tables'].any()


def _stub_tools(bindir, log, tools=('samtools', 'fastp', 'lighter')):
    """Scripts named after the tools that append their argv to ``log``;
    ``samtools sort`` creates its -o file and ``lighter`` writes a
    corrected FASTQ into its -od directory, as the real tools do."""
    bindir.mkdir(exist_ok=True)
    body = '''#!{python}
import os, sys
argv = sys.argv
with open({log!r}, 'a') as fh:
    fh.write(' '.join([os.path.basename(argv[0])] + argv[1:]) + '\\n')
if os.path.basename(argv[0]) == 'samtools' and argv[1] == 'sort':
    open(argv[argv.index('-o') + 1], 'w').close()
if os.path.basename(argv[0]) == 'lighter':
    outdir = argv[argv.index('-od') + 1]
    for i, flag in enumerate(argv):
        if flag == '-r':
            name = os.path.basename(argv[i + 1]).replace('.fq.gz', '.cor.fq')
            open(os.path.join(outdir, name), 'w').close()
'''.format(python=sys.executable, log=str(log))
    for tool in tools:
        path = bindir / tool
        path.write_text(body)
        path.chmod(path.stat().st_mode | stat.S_IXUSR)


@pytest.mark.parametrize('flags', [[], ['--skip-qc'], ['--skip-correction'],
                                   ['-t', '4', '--skip-qc',
                                    '--skip-correction']],
                         ids=['all', 'skip-qc', 'skip-correction', 'bare'])
def test_bam_preproc_runs_the_same_commands_as_jax(tmp_path, monkeypatch,
                                                   capsys, flags):
    monkeypatch.setenv('PATH', str(tmp_path / 'bin'))
    runs = {}
    for tool, tag in ((jax_bam_preproc, 'jax'), (bam_preproc, 'port')):
        log = tmp_path / (tag + '.log')
        _stub_tools(tmp_path / 'bin', log)
        prefix = str(tmp_path / 'out')
        tool.main(['sample.bam', prefix, '--genome-size', '3.2e9'] + flags)
        runs[tag] = (log.read_text(), capsys.readouterr().out)
    assert runs['port'] == runs['jax']
    commands = runs['jax'][0].splitlines()
    assert commands[0].startswith('samtools sort -n -@ ')
    assert any(c.startswith('fastp ') for c in commands) == \
        ('--skip-qc' not in flags)
    assert any(c.startswith('lighter ') for c in commands) == \
        ('--skip-correction' not in flags)


@pytest.mark.parametrize('tools', [(), ('samtools',), ('samtools', 'fastp')],
                         ids=['empty-path', 'no-fastp', 'no-lighter'])
def test_bam_preproc_names_a_missing_tool(tmp_path, monkeypatch, capsys,
                                          tools):
    monkeypatch.setenv('PATH', str(tmp_path / 'bin'))
    (tmp_path / 'bin').mkdir()
    _stub_tools(tmp_path / 'bin', tmp_path / 'log', tools)
    missing = ('samtools', 'fastp', 'lighter')[len(tools)]
    with pytest.raises(bam_preproc.MissingToolError, match=missing):
        bam_preproc.run('sample.bam', str(tmp_path / 'out'), 3_200_000_000)
    with pytest.raises(jax_bam_preproc.MissingToolError, match=missing):
        jax_bam_preproc.run('sample.bam', str(tmp_path / 'out'),
                            3_200_000_000)
    with pytest.raises(SystemExit) as exit_info:
        bam_preproc.main(['sample.bam', str(tmp_path / 'out'),
                          '--genome-size', '1e6'])
    assert exit_info.value.code == 1
    assert '"{}" not found on PATH'.format(missing) in capsys.readouterr().err
    assert issubclass(bam_preproc.MissingToolError, RuntimeError)
