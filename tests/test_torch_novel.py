"""The port's ``count`` and ``novel`` subcommands against ``kevlar_tpu``'s.

Tolerance: none — on the same simulated trio both CLIs must write the same
sketch arrays and byte-identical augmented FASTQ (the port with ``--device
cpu``, the plain PyTorch versions of its kernels).  The cases: a trio with
an SNV and an insertion whose proband reads carry N bases, then
``--abund-screen``, ``--num-bands 4 --band 2``, ``--skip-until``, and a
k-mer-dense batch of more than 32,768 hits, where both screens take their
overflow paths.  Sample tables of 4- and 1-bit counters, and a trio of
8-bit case and 4-bit controls: ``kevlar_tpu``'s novel reads each sketch's
packed bytes as 8-bit counters over the packed width, and the port reads
them so too (at the CLI, and in ``novel.novel`` on tables where that
reading gives hits).
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
    array, against the JAX package's.  ``count_args`` go to every count,
    or by sample where they are a dict; a ``-c 4`` or ``-c 1`` count is
    saved as ``.sct`` or ``.nt``."""
    samples = samples or ('proband', 'mother', 'father')
    args = {who: list(count_args.get(who, ()) if isinstance(count_args, dict)
                      else count_args) for who in samples}
    names = {who: who + {'4': '.sct', '1': '.nt'}.get(
        a[a.index('-c') + 1] if '-c' in a else '8', '.ct')
        for who, a in args.items()}
    texts = {}
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        outdir = tmp_path / name
        outdir.mkdir(parents=True)
        for who in samples:
            main(['count', '-k', str(KSIZE), '-M', '1M'] + extra +
                 args[who] + [str(outdir / names[who]), reads[who]])
        controls = [str(outdir / names[who]) for who in samples[1:]]
        out = str(outdir / 'novel.augfastq')
        main(['novel', '-k', str(KSIZE), '--case', reads['proband'],
              '--case-counts', str(outdir / names[samples[0]]),
              '--control-counts'] + controls + extra + list(novel_args) +
             ['-o', out])
        with open(out) as fh:
            texts[name] = fh.read()
    for who in samples:
        with np.load(str(tmp_path / 'jax' / names[who])) as want, \
                np.load(str(tmp_path / 'port' / names[who])) as got:
            for member in want.files:
                assert np.array_equal(got[member], want[member]), who
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


@pytest.fixture(scope='module')
def snv_trio(tmp_path_factory):
    """FASTQ files of a 4 kb trio whose proband carries two SNVs and reads
    with an N (test_torch_screen.py's)."""
    workdir = tmp_path_factory.mktemp('snv_trio')
    rng = random.Random(1212)
    genome = simdata.make_genome(rng, 4000)
    child, _, _ = simdata.apply_snv(genome, 1200, rng=rng)
    child, _, _ = simdata.apply_snv(child, 2900, rng=rng)
    proband = simdata.tiled_reads(child, 100, 5, prefix='c')
    for r in proband[::9]:
        r.sequence = r.sequence[:30] + 'N' + r.sequence[31:]
    paths = {}
    for who, reads in (('proband', proband),
                       ('mother', simdata.sample_reads(
                           rng, genome, coverage=15, prefix='m')),
                       ('father', simdata.sample_reads(
                           rng, genome, coverage=15, prefix='f'))):
        paths[who] = str(workdir / (who + '.fq'))
        simdata.write_fastq(reads, paths[who])
    return paths


@pytest.mark.parametrize('bits,limits', [('4', ('6', '0')), ('1', ('1', '0'))])
def test_novel_over_sub_byte_tables_matches_jax(snv_trio, tmp_path, bits,
                                                limits):
    """4- and 1-bit sample tables of one shape: both packages screen their
    packed bytes as 8-bit counters (the port over packed words, as JAX)."""
    _both(tmp_path, snv_trio, count_args=['-c', bits], novel_args=[
        '--case-min', limits[0], '--ctrl-max', limits[1]])


def test_novel_over_mixed_widths_matches_jax(snv_trio, tmp_path):
    """An 8-bit case with 4-bit controls: tables of two shapes, each read
    at 8 bits over its own packed width."""
    text = _both(tmp_path, snv_trio, count_args={'mother': ['-c', '4'],
                                                 'father': ['-c', '4']},
                 novel_args=['--case-min', '6', '--ctrl-max', '0'])
    assert text.count('#\n') > 0


@pytest.mark.parametrize('bits', [4, 1])
def test_novel_reads_sub_byte_tables_as_jax_does(bits, monkeypatch):
    """``novel.novel`` on sketches built from the same counter values in
    both packages, where JAX's reading of the packed bytes as 8-bit
    counters gives hits: the same text, and not the text of the true
    counters."""
    from kevlar_tpu import novel as jax_novel
    from kevlar_tpu import sketch as jax_sketch
    rng = np.random.default_rng(bits)
    maxcount = (1 << bits) - 1
    tablesize = 1009
    case = rng.integers(0, maxcount + 1, (4, tablesize), dtype=np.uint8)
    ctrl = np.zeros((4, tablesize), np.uint8)
    ctrl[rng.random((4, tablesize)) < 0.1] = maxcount
    pyrng = random.Random(bits)
    reads = simdata.sample_reads(pyrng, simdata.make_genome(pyrng, 600),
                                 coverage=4, prefix='r')
    texts = {}
    for name, mod, make in (
            ('jax', jax_novel, lambda t: jax_sketch.Sketch(
                KSIZE, tablesize, 4, counter_bits=bits, tables=t)),
            ('port', novel, lambda t: sketch.Sketch(
                KSIZE, tablesize, 4, counter_bits=bits, tables=t,
                device='cpu'))):
        texts[name] = ''.join(mod.novel(
            iter(reads), [make(case)], [make(ctrl), make(ctrl)],
            ksize=KSIZE, casemin=6, ctrlmax=0, emit='text'))
    assert texts['port'] == texts['jax']
    assert texts['port'].count('#\n') > 0
    # the true counters give other hits
    true = [sketch.Sketch(KSIZE, tablesize, 4, counter_bits=8, tables=t,
                          device='cpu') for t in (case, ctrl, ctrl)]
    assert ''.join(novel.novel(iter(reads), true[:1], true[1:], ksize=KSIZE,
                               casemin=min(6, maxcount), ctrlmax=0,
                               emit='text')) != texts['port']


# ------------------------------------------------- the augmented-FASTX text

def _python_format_hits(rbatch, hits_np, hitab_np, discard, ksize):
    """The per-line Python formatter that ``native.AugTextWriter``
    replaced, kept as the reference it is held to: ``(text, revcommin
    strings, reads, lines)``."""
    unique = set()
    if not len(hits_np):
        return '', unique, 0, 0
    P = rbatch.bases.shape[1] - ksize + 1
    i = hits_np // P
    p = hits_np - i * P
    n = len(rbatch.records)
    ok = (i < n) & ~discard[np.minimum(i, len(discard) - 1)]
    i, p, hitab_np = i[ok], p[ok], hitab_np[:, ok]
    if not len(i):
        return '', unique, 0, 0
    boundaries = np.flatnonzero(np.diff(i)) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [len(i)]))
    abstr = [' '.join(map(str, col)) for col in hitab_np.T.tolist()]
    parts = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        r = int(i[s])
        if isinstance(rbatch, novel._NativeBatch):
            L = int(rbatch.lengths[r])
            seq = np.frombuffer(b'ACGTN', np.uint8)[
                rbatch.bases[r, :L]].tobytes().decode('ascii')
            name, qual = rbatch.names[r], None
            if rbatch.quals is not None:
                q = rbatch.quals[r, :L].tobytes().decode('ascii', 'replace')
                qual = q if q.strip('\x00') else None
        else:
            rec = rbatch.records[r]
            name, seq, qual = rec.name, rec.sequence, rec.quality
        if qual is not None:
            parts.append('@{}\n{}\n+\n{}\n'.format(name, seq, qual))
        else:
            parts.append('>{}\n{}\n'.format(name, seq))
        for j in range(s, e):
            off = int(p[j])
            kmer = seq[off:off + ksize]
            parts.append('{}{}          {}#\n'.format(
                ' ' * off, kmer, abstr[j]))
            unique.add(kevlar_tpu_torch.revcommin(kmer))
    return ''.join(parts), unique, len(starts), len(i)


def _kmer_strings(keys, ksize):
    """``format_hits``'s canonical keys as strings: 2-bit codes decoded."""
    return {k if isinstance(k, str) else ''.join(
        'ACGT'[(k >> 2 * (ksize - 1 - b)) & 3] for b in range(ksize))
        for k in keys}


def _text_batch(kind, ksize, rng):
    """A batch of 11 reads in 16 rows, 72 columns wide: reads of ksize to
    72 bases, every fourth carrying an N; ``fastq`` the reader's codes with
    one quality row for all (stride 0, as the benchmark hands them),
    ``fasta`` with no qualities, ``nul`` qualities that are all NUL in some
    rows, short of the read in others and outside ASCII in others (a view
    of wider rows, as the reader gives them), ``records`` Records of
    lower-case and IUPAC text, with and without qualities."""
    from kevlar_tpu_torch import batch as batch_mod
    from kevlar_tpu_torch.sequence import Record
    nreads, rows, width = 11, 16, 72
    lengths = rng.integers(ksize, width + 1, nreads).astype(np.int32)
    lengths[0] = width
    if kind == 'records':
        records = []
        for r in range(nreads):
            seq = ''.join(rng.choice(list('ACGT'), lengths[r]))
            if r % 3 == 1:
                seq = seq.lower()
            if r % 3 == 2:
                pos = rng.integers(0, lengths[r], 3)
                seq = ''.join('RYNk'[pos.tolist().index(x) % 4]
                              if x in pos else c for x, c in enumerate(seq))
            qual = [None, 'I' * len(seq), '', chr(0x263A) * len(seq)][r % 4]
            records.append(Record(name='rec{}-ä'.format(r),
                                  sequence=seq, quality=qual))
        return batch_mod.ReadBatch(records, pad_to=width, pad_rows=rows)
    bases = np.full((nreads, width), 4, np.uint8)
    for r in range(nreads):
        bases[r, :lengths[r]] = rng.integers(0, 4, lengths[r])
        if r % 4 == 3:
            bases[r, rng.integers(0, lengths[r])] = 4
    names = ['read{}'.format(r) for r in range(nreads)]
    quals = None
    if kind == 'fastq':
        row = np.zeros((1, width), np.uint8)
        row[0, :] = ord('F')
        quals = np.broadcast_to(row, (nreads, width))
    elif kind == 'nul':
        wide = np.zeros((nreads, 2 * width), np.uint8)
        for r in range(nreads):
            if r % 3:
                wide[r, :lengths[r] - (r % 3 == 2)] = rng.integers(
                    33, 127, lengths[r] - (r % 3 == 2))
            if r % 5 == 4:
                wide[r, :3] = [0x80, 0xC3, 0xFF]
        quals = wide[:, :width]
    return novel._NativeBatch(bases, lengths, names, quals, rows)


TEXT_KINDS = ['fastq', 'fasta', 'nul', 'records']
TEXT_KSIZES = [15, 31, 32, 33]


@pytest.mark.parametrize('ksize', TEXT_KSIZES)
@pytest.mark.parametrize('kind', TEXT_KINDS)
def test_text_writer_matches_the_python_formatter(kind, ksize):
    """``novel.format_hits`` (one ``kt_augtext`` call a batch) writes the
    bytes of the per-line Python formatter, and its canonical keys are the
    reference's ``revcommin`` strings: hits at offset 0, at L - k and past
    it, on discarded and padding rows; abundances 0, 9, 10, 99, 100 and
    255 over 2 to 8 samples; then an empty batch and one whose every hit
    is dropped, through the same writer (its buffer grown, then reused)."""
    from kevlar_tpu_torch import native
    case = TEXT_KINDS.index(kind) * len(TEXT_KSIZES) + \
        TEXT_KSIZES.index(ksize)
    rng = np.random.default_rng(case)
    nsamples = 2 + case % 7
    rbatch = _text_batch(kind, ksize, rng)
    rows, width = rbatch.bases.shape
    P = width - ksize + 1
    flat = set(rng.choice(rows * P, 3 * rows, replace=False).tolist())
    for r in range(rows):
        L = int(rbatch.lengths[r])
        flat.update({r * P, r * P + max(L - ksize, 0)})
    hits = np.array(sorted(flat), np.int32 if case % 2 else np.int64)
    abund = rng.integers(0, 256, (nsamples, len(hits)), dtype=np.uint8)
    abund[:, :6] = np.array([0, 9, 10, 99, 100, 255], np.uint8)[
        (np.arange(nsamples)[:, None] + np.arange(6)) % 6]
    discard = rng.random(rows) < 0.2
    discard[0] = False
    writer = native.AugTextWriter()
    before = dict(novel.counters)
    keys = set()
    got = novel.format_hits(rbatch, hits, abund, discard, ksize, writer,
                            keys)
    text, unique, nreads, nlines = _python_format_hits(
        rbatch, hits, abund, discard, ksize)
    assert got == (text, nreads, nlines)
    assert nlines > rows
    headers = {line[0] for line in text.splitlines()
               if line[:1] in ('@', '>')}
    # the case holds what it says it does
    assert headers == {'fastq': {'@'}, 'fasta': {'>'}, 'nul': {'@', '>'},
                       'records': {'@', '>'}}[kind]
    assert ('\x00' in text and '\ufffd' in text) == (kind == 'nul')
    assert len(keys) == len(unique)
    assert _kmer_strings(keys, ksize) == unique
    host = sum(1 for line in text.splitlines() if line.endswith('#')
               and (ksize > 32 or len(line.split()[0]) != ksize or
                    set(line.split()[0]) - set('ACGT')))
    assert novel.counters['text_lines'] - before['text_lines'] == nlines
    assert novel.counters['text_host_kmers'] - \
        before['text_host_kmers'] == host
    if kind == 'records' or ksize > 32:
        assert host > 0
    for hits_, abund_, discard_ in (
            (hits[:0], abund[:, :0], discard),
            (hits, abund, np.ones_like(discard))):
        assert novel.format_hits(rbatch, hits_, abund_, discard_, ksize,
                                 writer, keys) == ('', 0, 0)
        assert _python_format_hits(rbatch, hits_, abund_, discard_,
                                   ksize)[0] == ''
    # a second batch through the grown buffer
    assert novel.format_hits(rbatch, hits, abund, discard, ksize, writer,
                             set())[0] == text
