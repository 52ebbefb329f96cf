"""The port's ``count`` and ``novel`` subcommands against ``kevlar_tpu``'s.

Tolerance: none — on the same simulated trio both CLIs must write the same
sketch arrays and byte-identical augmented FASTQ (the port with ``--device
cpu``, the plain PyTorch versions of its kernels).  The cases: a trio with
an SNV and an insertion whose proband reads carry N bases, then
``--abund-screen``, ``--num-bands 4 --band 2``, ``--skip-until``, and a
k-mer-dense batch of more than 32,768 hits, where both screens take their
overflow paths.
"""

import io
import random

import numpy as np
import pytest

import kevlar_tpu
import kevlar_tpu_torch
from kevlar_tpu import cli as jax_cli
from kevlar_tpu_torch import cli, novel, sketch

from . import simdata

KSIZE = 21


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def trio(tmp_path_factory):
    """FASTQ files of a 4 kb trio: the proband carries an SNV and a 9 bp
    insertion; one read in ten of the proband's carries an N."""
    workdir = tmp_path_factory.mktemp('trio')
    rng = random.Random(4242)
    genome = simdata.make_genome(rng, 4000)
    child, _, _ = simdata.apply_snv(genome, 1000, rng=rng)
    child = simdata.apply_insertion(child, 3000, 'CATGATCAT')
    proband = (simdata.tiled_reads(child, 100, 6, prefix='c') +
               simdata.sample_reads(rng, genome, coverage=8, prefix='h'))
    for r in proband[::10]:
        pos = rng.randrange(len(r.sequence))
        r.sequence = r.sequence[:pos] + 'N' + r.sequence[pos + 1:]
    paths = {}
    for who, reads in (('proband', proband),
                       ('mother', simdata.sample_reads(
                           rng, genome, coverage=20, prefix='m')),
                       ('father', simdata.sample_reads(
                           rng, genome, coverage=20, prefix='f'))):
        paths[who] = str(workdir / (who + '.fq'))
        simdata.write_fastq(reads, paths[who])
    return paths


def _both(tmp_path, reads, count_args=(), novel_args=(), samples=None):
    """Count ``samples`` and screen the proband with each package's CLI;
    returns the port's novel text after checking it, and every sketch
    array, against the JAX package's."""
    texts = {}
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        outdir = tmp_path / name
        outdir.mkdir(parents=True)
        for who in samples or ('proband', 'mother', 'father'):
            main(['count', '-k', str(KSIZE), '-M', '1M'] + extra +
                 list(count_args) + [str(outdir / (who + '.ct')),
                                     reads[who]])
        controls = [str(outdir / (who + '.ct')) for who in
                    (samples or ('proband', 'mother', 'father'))[1:]]
        out = str(outdir / 'novel.augfastq')
        main(['novel', '-k', str(KSIZE), '--case', reads['proband'],
              '--case-counts', str(outdir / 'proband.ct'),
              '--control-counts'] + controls + extra + list(novel_args) +
             ['-o', out])
        with open(out) as fh:
            texts[name] = fh.read()
    for ct in (tmp_path / 'jax').glob('*.ct'):
        with np.load(str(ct)) as want, \
                np.load(str(tmp_path / 'port' / ct.name)) as got:
            for member in want.files:
                assert np.array_equal(got[member], want[member]), ct.name
    assert texts['port'] == texts['jax']
    return texts['port']


def _records(text):
    return list(kevlar_tpu.parse_augmented_fastx(iter(text.splitlines(
        keepends=True))))


def test_count_novel_cli_matches_jax(trio, tmp_path):
    text = _both(tmp_path, trio, novel_args=['--case-min', '6',
                                            '--ctrl-max', '0'])
    records = _records(text)
    assert len(records) > 10
    assert all(r.annotations and 'N' not in r.sequence for r in records)
    assert any('CATGATCAT' in r.sequence for r in records)


def test_abund_screen_matches_jax(trio, tmp_path):
    loose = _both(tmp_path / 'a', trio, novel_args=[
        '--case-min', '2', '--ctrl-max', '1'])
    screened = _both(tmp_path / 'b', trio, novel_args=[
        '--case-min', '6', '--ctrl-max', '1', '--abund-screen', '5'])
    assert 0 < len(_records(screened)) < len(_records(loose))


def test_banded_cli_matches_jax(trio, tmp_path):
    text = _both(tmp_path, trio, count_args=['--num-bands', '4', '--band',
                                             '2'],
                 novel_args=['--case-min', '6', '--ctrl-max', '0',
                             '--num-bands', '4', '--band', '2'])
    assert text.count('#\n') > 0


def test_skip_until_matches_jax(trio, tmp_path):
    text = _both(tmp_path, trio, novel_args=['--case-min', '6',
                                            '--ctrl-max', '0',
                                            '--skip-until', 'c400'])
    assert text and '@c300\n' not in text


def test_novel_counting_its_samples_matches_jax(trio, tmp_path):
    """``novel`` given reads instead of sketches counts each sample
    itself, and ``--save-case-counts`` keeps the case sketch."""
    texts, saved = {}, {}
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        out = str(tmp_path / (name + '.augfastq'))
        saved[name] = str(tmp_path / (name + '_case.ct'))
        main(['novel', '-k', str(KSIZE), '-M', '1M', '--case',
              trio['proband'], '--control', trio['mother'], '--control',
              trio['father'], '--case-min', '6', '--ctrl-max', '0',
              '--save-case-counts', saved[name], '-o', out] + extra)
        with open(out) as fh:
            texts[name] = fh.read()
    assert texts['port'] == texts['jax'] and texts['port']
    with np.load(saved['jax']) as want, np.load(saved['port']) as got:
        assert np.array_equal(got['tables'], want['tables'])


def test_dense_batch_over_32768_hits_matches_jax(tmp_path, monkeypatch):
    """A proband genome unrelated to its parents': nearly every k-mer of
    its 550 reads is novel (> 32,768 hits in one batch), which sends the
    JAX screen to its uncompacted overflow path, and the port's screen
    over packed words past its capacity to the uncapped ``novel_screen``
    over the same words."""
    from kevlar_tpu.ops import novel_ops as jax_novel_ops
    from kevlar_tpu_torch.ops import novel_ops as port_novel_ops
    rng = random.Random(99)
    reads = {}
    for who, genome, cov in (('proband', simdata.make_genome(rng, 5500), 10),
                             ('mother', simdata.make_genome(rng, 3000), 5)):
        reads[who] = str(tmp_path / (who + '.fq'))
        simdata.write_fastq(simdata.sample_reads(rng, genome, coverage=cov,
                                                 prefix=who[0]),
                            reads[who])
    overflow = []
    full_screen = jax_novel_ops.novel_screen

    def spy(*args, **kwargs):
        overflow.append(1)
        return full_screen(*args, **kwargs)

    monkeypatch.setattr(jax_novel_ops, 'novel_screen', spy)
    port_overflow = []
    port_screen = port_novel_ops.novel_screen

    def port_spy(*args, **kwargs):
        port_overflow.append(kwargs.get('words') is not None)
        return port_screen(*args, **kwargs)

    monkeypatch.setattr(port_novel_ops, 'novel_screen', port_spy)
    text = _both(tmp_path, reads, samples=('proband', 'mother'),
                 novel_args=['--case-min', '1', '--ctrl-max', '0'])
    assert overflow
    assert port_overflow and all(port_overflow)
    assert text.count('#\n') > 32768


@pytest.mark.parametrize('native', [True, False])
def test_emit_records_matches_text(trio, tmp_path, native):
    counts = []
    for who in ('proband', 'mother', 'father'):
        path = str(tmp_path / (who + '.ct'))
        cli.main(['count', '-k', str(KSIZE), '-M', '1M', '--device', 'cpu',
                  path, trio[who]])
        counts.append(sketch.load(path, device='cpu'))

    def run(emit):
        if native:
            stream = dict(batchstream=novel.native_read_batches(
                [trio['proband']], 64))
        else:
            stream = dict(casestream=kevlar_tpu_torch.seqio.multi_file_iter(
                [trio['proband']]), batch_size=64)
        kw = dict(casestream=None, ksize=KSIZE, casemin=6, ctrlmax=0,
                  abundscreen=3, emit=emit)
        kw.update(stream)
        return novel.novel(casecounts=counts[:1], controlcounts=counts[1:],
                           **kw)

    text = ''.join(run('text'))
    records = list(run('records'))
    rendered = []
    for record in records:
        buf = io.StringIO()
        kevlar_tpu_torch.print_augmented_fastx(record, buf)
        rendered.append(buf.getvalue())
    assert records and ''.join(rendered) == text


@pytest.mark.parametrize('stage', ['count', 'novel'])
@pytest.mark.parametrize('threads', ['1', '2'])
def test_threads_parse_like_jax(stage, threads, trio, tmp_path):
    """``-t`` takes any int on ``count`` and ``novel``, as ``kevlar_tpu``'s
    parser does, and changes nothing: both packages parse the same command
    line, and ``count -t T`` writes the table ``-t 1`` writes."""
    rest = (['x.ct', 'x.fq'] if stage == 'count' else
            ['--case', 'x.fq', '--case-counts', 'x.ct'])
    argv = [stage, '-t', threads] + rest
    assert jax_cli.parser().parse_args(argv).threads == int(threads)
    assert cli.parser().parse_args(
        argv[:3] + ['--device', 'cpu'] + rest).threads == int(threads)
    if stage != 'count':
        return
    for t in ('1', threads):
        cli.main(['count', '-k', str(KSIZE), '-M', '1M', '-t', t, '--device',
                  'cpu', str(tmp_path / (t + '.ct')), trio['mother']])
    with np.load(str(tmp_path / '1.ct')) as want, \
            np.load(str(tmp_path / (threads + '.ct'))) as got:
        for member in want.files:
            assert np.array_equal(got[member], want[member]), member
