"""The port's screen over packed sample words (``novel_screen_compact``)
against the JAX package's ``novel_screen_compact(..., packed=...)``, and
the novel stage's choice between it and the per-sample gather.

Tolerance: none.  Counts, hit indices and abundances are integers, so the
five outputs (``hit_idx``, ``hit_abunds``, ``n_hits``, ``discard``,
``skip``) must be bit-identical.  On the CPU the port runs the plain
PyTorch version of its kernel, ``novel_screen_compact_plain`` (K1's plain
hashes, the word gather, the predicates and the fixed-capacity
compaction).  ``kt_screen_reads``' schedule is emulated in Python
integers (blocks in a shuffled order of start, the in-block scan, the
look-back, the early exit) and held to the plain version; the
``cuda``-marked tests hold the kernel on a card to it (they skip without
one).

The inputs are seeded with numpy: random base codes with an N inside a
read, bases past a read's length, a read shorter than k and padding rows
of length 0; case tables whose counters are mostly above ``casemin`` and
controls of small counts, so that there are hits, screened reads and
reads kept alike.  The cases take 1 and 2 cases, 1, 2 and 5 controls (7
samples: two word tensors), the abundance screen off and at 3, no band and
band 1 of 4, and a capacity below the number of hits.

The JAX package is imported inside the tests that compare with it, so the
``cuda`` tests also run where JAX is absent (the machine with the card):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_screen.py
"""

import itertools
import random

import numpy as np
import pytest
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch import cli
from kevlar_tpu_torch.ops import hashing, kmer_cuda, novel_ops, sketch_ops

from . import simdata

KSIZE = 21
B, L = 48, 64
NTABLES, TABLESIZE = 4, 997
CASEMIN, CTRLMAX = 4, 1
OUTPUTS = ('hit_idx', 'hit_abunds', 'n_hits', 'discard', 'skip')


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


def _batch(seed):
    """(codes [B, L] uint8, lengths [B] int32) of one seeded batch."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(KSIZE, L + 1, B).astype(np.int32)
    for r in range(B):
        codes[r, lengths[r]:] = 4
    codes[3, 10] = 4                 # an N inside the read: skipped
    lengths[9] = 40                  # bases past the read's length
    codes[9] = rng.integers(0, 4, L, dtype=np.uint8)
    codes[9, 50] = 4                 # and an N among them: not skipped
    lengths[7] = KSIZE - 6           # shorter than k: skipped
    codes[7, lengths[7]:] = 4
    codes[-4:] = 4                   # padding rows
    lengths[-4:] = 0
    return codes, lengths


def _tables(seed, ncase, nctrl):
    """Case tables mostly above CASEMIN (a few low counters), controls
    of counts 0-3: uint8 [NTABLES, TABLESIZE] each."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(ncase + nctrl):
        if s < ncase:
            t = rng.integers(CASEMIN, 12, (NTABLES, TABLESIZE))
            low = rng.random((NTABLES, TABLESIZE)) < 0.005
            t[low] = rng.integers(0, CASEMIN, int(low.sum()))
        else:
            t = rng.integers(0, 4, (NTABLES, TABLESIZE))
        out.append(t.astype(np.uint8))
    return out


CASES = {'{} case{}, {} control{}, screen {}, {}'.format(
    ncase, 's' if ncase > 1 else '', nctrl, 's' if nctrl > 1 else '',
    screen, 'band 1 of 4' if band else 'no band'): dict(
        ncase=ncase, nctrl=nctrl, screen=screen,
        numbands=4 if band else None, band=1 if band else None)
    for ncase, nctrl, screen, band in itertools.product(
        (1, 2), (1, 2, 5), (None, 3), (False, True))}
CASES['max_hits below the hits'] = dict(ncase=1, nctrl=2, screen=3,
                                        max_hits=64)
CASES['max_hits below the hits, 2 cases, 5 controls, band'] = dict(
    ncase=2, nctrl=5, screen=None, numbands=4, band=1, max_hits=16)


def _inputs(case):
    """(words, tables, codes, lengths, keyword arguments) of a case, the
    seed taken from its parameters."""
    kw = dict(CASES[case])
    ncase, nctrl = kw.pop('ncase'), kw.pop('nctrl')
    seed = 10 * ncase + nctrl + (100 if kw['screen'] else 0) + \
        (1000 if kw.get('numbands') else 0)
    codes, lengths = _batch(seed)
    tables = _tables(seed + 1, ncase, nctrl)
    kw = dict(dict(ksize=KSIZE, casemin=CASEMIN, ctrlmax=CTRLMAX,
                   max_hits=32768), **kw)
    return tables, ncase, codes, lengths, kw


def _port(tables, ncase, codes, lengths, kw, device='cpu'):
    words = sketch_ops.pack_sample_tables(
        [torch.from_numpy(t).to(device) for t in tables])
    return novel_ops.novel_screen_compact(
        words, len(tables), ncase, torch.from_numpy(codes).to(device),
        torch.from_numpy(lengths).to(device), **kw)


def _plain_args(case):
    """(positional arguments of ``novel_screen_compact_plain``, max_hits)
    of a case, on the CPU."""
    tables, ncase, codes, lengths, kw = _inputs(case)
    words = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                           for t in tables])
    return (words, len(tables), ncase, torch.from_numpy(codes),
            torch.from_numpy(lengths), KSIZE, CASEMIN, CTRLMAX,
            kw['screen'], kw.get('numbands'), kw.get('band')), kw['max_hits']


def _jax(tables, ncase, codes, lengths, kw):
    import jax.numpy as jnp
    from kevlar_tpu.ops import novel_ops as jax_novel_ops
    from kevlar_tpu.ops import sketch_ops as jax_sketch_ops
    jt = tuple(jnp.asarray(t) for t in tables)
    return jax_novel_ops.novel_screen_compact(
        jt[:ncase], jt[ncase:], jnp.asarray(codes), jnp.asarray(lengths),
        packed=jax_sketch_ops.pack_sample_tables(jt), **kw)


def _assert_same(got, want):
    for name, a, b in zip(OUTPUTS, got, want):
        a = a.cpu().numpy()
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize('case', list(CASES))
def test_screen_over_words_matches_jax(case):
    tables, ncase, codes, lengths, kw = _inputs(case)
    got = _port(tables, ncase, codes, lengths, kw)
    _assert_same(got, _jax(tables, ncase, codes, lengths, kw))
    hit_idx, hit_abunds, n_hits, discard, skip = got
    n = int(n_hits)
    assert n > 0
    shown = min(n, kw['max_hits'])
    assert bool((hit_idx[:shown] >= 0).all())
    assert bool((hit_idx[1:shown] > hit_idx[:shown - 1]).all())
    assert bool((hit_idx[shown:] == -1).all())
    assert not bool(hit_abunds[:, shown:].any())
    if kw['max_hits'] < 32768:
        assert n > kw['max_hits']
    # the N inside read 3 and read 7's length skip them; read 9's N lies
    # past its length; padding rows are skipped
    assert bool(skip[3]) and bool(skip[7]) and not bool(skip[9])
    assert bool(skip[-4:].all())
    if kw['screen'] is not None:
        assert bool(discard.any()) and not bool(discard.all())
        assert not bool((discard & skip).any())
    else:
        assert not bool(discard.any())


@pytest.mark.parametrize('case', list(CASES))
def test_plain_screen_matches_jax(case):
    """``novel_screen_compact_plain``, the plain version the card holds
    ``kt_screen_reads`` to, called directly: it hashes with K1's plain
    version inside and equals JAX's screen over packed words, bands, the
    abundance screen, skipped and padding rows, row 9's bases past its
    length and capacities below the hits included."""
    tables, ncase, codes, lengths, kw = _inputs(case)
    args, max_hits = _plain_args(case)
    got = novel_ops.novel_screen_compact_plain(*args, max_hits=max_hits)
    _assert_same(got, _jax(tables, ncase, codes, lengths, kw))
    assert int(got[2]) > 0


def test_novel_screen_over_words_matches_per_sample_gather():
    """The uncapped screen that takes a batch past the capacity gathers
    from the words, as JAX's does; it equals the per-sample gather."""
    tables, ncase, codes, lengths, kw = _inputs(
        '2 cases, 5 controls, screen 3, band 1 of 4')
    t = [torch.from_numpy(x) for x in tables]
    args = ([(x, 8, TABLESIZE) for x in t], ncase, torch.from_numpy(codes),
            torch.from_numpy(lengths), KSIZE, CASEMIN, CTRLMAX)
    kw = dict(screen=3, numbands=4, band=1)
    got = novel_ops.novel_screen(*args, words=sketch_ops.pack_sample_tables(
        t), **kw)
    want = novel_ops.novel_screen(*args, **kw)
    assert got[0].numel() > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_screen_checks_its_inputs():
    tables, ncase, codes, lengths, kw = _inputs(
        '1 case, 2 controls, screen None, no band')
    words = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                           for t in tables])
    c = torch.from_numpy(codes)
    lens = torch.from_numpy(lengths)

    def call(**changes):
        args = dict(words=words, nsamples=3, ncase=1, codes=c, lengths=lens,
                    ksize=KSIZE, casemin=CASEMIN, ctrlmax=CTRLMAX)
        args.update(changes)
        return novel_ops.novel_screen_compact(**args)

    call()
    for bad in (dict(nsamples=5), dict(ncase=0), dict(ncase=4),
                dict(codes=c.long()), dict(codes=c[:, ::2]),
                dict(lengths=lens.long()), dict(lengths=lens[:-1]),
                dict(ksize=L + 1), dict(ksize=0), dict(casemin=256),
                dict(screen=-1), dict(max_hits=0),
                dict(words=(words[0].view(torch.uint8),))):
        with pytest.raises(ValueError):
            call(**bad)


def _count_and_screen(tmp_path, reads, memories):
    """Count the proband, mother and father (``-M`` each from
    ``memories``) and screen the proband with each package's CLI; returns
    the port's novel text after checking it against JAX's."""
    from kevlar_tpu import cli as jax_cli
    texts = {}
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        outdir = tmp_path / name
        outdir.mkdir()
        for who, memory in zip(('proband', 'mother', 'father'), memories):
            main(['count', '-k', str(KSIZE), '-M', memory] + extra +
                 [str(outdir / (who + '.ct')), reads[who]])
        out = str(outdir / 'novel.augfastq')
        main(['novel', '-k', str(KSIZE), '--case', reads['proband'],
              '--case-counts', str(outdir / 'proband.ct'),
              '--control-counts', str(outdir / 'mother.ct'),
              str(outdir / 'father.ct'), '--case-min', '6', '--ctrl-max',
              '0', '--abund-screen', '3'] + extra + ['-o', out])
        with open(out) as fh:
            texts[name] = fh.read()
    assert texts['port'] == texts['jax']
    return texts['port']


@pytest.fixture(scope='module')
def trio(tmp_path_factory):
    """FASTQ files of a 4 kb trio whose proband carries two SNVs and reads
    with an N."""
    workdir = tmp_path_factory.mktemp('screen_trio')
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


@pytest.mark.parametrize('memories,words', [
    (('1M', '1M', '1M'), True), (('1M', '2M', '2M'), False)])
def test_novel_takes_the_word_screen_where_jax_packs(trio, tmp_path,
                                                     monkeypatch, memories,
                                                     words):
    """A trio of one table shape goes through ``novel_screen_compact`` over
    packed words (JAX's ``_pack_or_none`` packs it); samples of two shapes
    keep the per-sample gather (JAX's does too).  The text equals JAX's
    both ways."""
    calls = {'novel_screen_compact': 0, 'novel_screen': 0}
    for name in calls:
        def spy(*args, _name=name, _fn=getattr(novel_ops, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(novel_ops, name, spy)
    text = _count_and_screen(tmp_path, trio, memories)
    assert text.count('#\n') > 10
    if words:
        assert calls['novel_screen_compact'] > 0
        assert calls['novel_screen'] == 0
    else:
        assert calls['novel_screen_compact'] == 0
        assert calls['novel_screen'] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    '1 case, 2 controls, screen None, no band',
    '2 cases, 5 controls, screen 3, band 1 of 4',
    'max_hits below the hits'])
def test_screen_kernel_matches_plain_on_card(cuda_device, case):
    """``kt_screen_reads`` on the card against its plain version on the
    same inputs, and against the same screen on the CPU; one launch."""
    tables, ncase, codes, lengths, kw = _inputs(case)
    words = sketch_ops.pack_sample_tables(
        [torch.from_numpy(t).to(cuda_device) for t in tables])
    args = (words, len(tables), ncase, torch.from_numpy(codes).to(
        cuda_device), torch.from_numpy(lengths).to(cuda_device), KSIZE,
        CASEMIN, CTRLMAX, kw['screen'], kw.get('numbands'), kw.get('band'),
        kw['max_hits'])
    before = dict(kmer_cuda.launches)
    got = kmer_cuda.screen_reads_cuda(*args)
    torch.cuda.synchronize()
    assert kmer_cuda.launches['screen_reads'] == before['screen_reads'] + 1
    assert kmer_cuda.launches['kmer_hashes'] == before['kmer_hashes']
    _assert_same(got, novel_ops.novel_screen_compact_plain(*args))
    _assert_same(_port(tables, ncase, codes, lengths, kw,
                       device=cuda_device),
                 _port(tables, ncase, codes, lengths, kw))


@pytest.mark.cuda
@pytest.mark.parametrize('nrows,L,ksize,nsamples', [
    (3000, 160, 31, 3), (7, 1500, 31, 6), (40, 200, 41, 9)])
def test_screen_kernel_on_a_dense_batch_on_card(cuda_device, nrows, L,
                                                 ksize, nsamples):
    """Every k-mer a hit (controls at 0, casemin 0): many blocks full and a
    capacity far below the hits; rows of more than 1,024 windows (a block
    each, longer runs), k > 32 and three word tensors."""
    rng = np.random.default_rng(nrows + L)
    codes = rng.integers(0, 4, (nrows, L), dtype=np.uint8)
    lengths = np.full(nrows, L - 10, np.int32)
    codes[:, L - 10:] = 4
    tables = [rng.integers(0, 256, (4, 100_003), dtype=np.uint8)] + \
        [np.zeros((4, 100_003), np.uint8)] * (nsamples - 1)
    kw = dict(ksize=ksize, casemin=0, ctrlmax=0, max_hits=32768)
    words = sketch_ops.pack_sample_tables(
        [torch.from_numpy(t).to(cuda_device) for t in tables])
    args = (words, nsamples, 1, torch.from_numpy(codes).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device))
    got = novel_ops.novel_screen_compact(*args, **kw)
    want = novel_ops.novel_screen_compact_plain(*args, **kw)
    assert int(got[2]) == nrows * (L - 10 - ksize + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _vcmpgeu4(a, b):
    """``__vcmpgeu4``: 0xff in each byte of ``a`` >= that byte of ``b``."""
    return sum(0xff << (8 * j) for j in range(4)
               if (a >> (8 * j)) & 0xff >= (b >> (8 * j)) & 0xff)


def _vcmpleu4(a, b):
    return sum(0xff << (8 * j) for j in range(4)
               if (a >> (8 * j)) & 0xff <= (b >> (8 * j)) & 0xff)


def _vminu4(a, b):
    return sum(min((a >> (8 * j)) & 0xff, (b >> (8 * j)) & 0xff) << (8 * j)
               for j in range(4))


def _mod_by(x, d, m):
    """``mod_by`` of csrc/kmer.cu: the multiply-high reduction."""
    r = (x - ((x * m) >> 32) * d) & 0xFFFFFFFF
    return r - d if r >= d else r


# csrc/kmer.cu's kScreenThreads, kScreenRun, kScreenChunk
SCREEN_THREADS, SCREEN_RUN, SCREEN_CHUNK = 256, 4, 4
COUNT_FLAG, PREFIX_FLAG = 1, 2


def _screen_geometry(nrows, P):
    """``screen_geometry`` of csrc/kmer.cu: (run, runs a row, rows a block,
    blocks)."""
    run = SCREEN_RUN
    runs_per_row = -(-P // run)
    if runs_per_row > SCREEN_THREADS:
        run = -(-P // SCREEN_THREADS)
        runs_per_row = -(-P // run)
    rows = SCREEN_THREADS // runs_per_row
    if rows > nrows:
        rows = max(nrows, 1)
    return run, runs_per_row, rows, -(-nrows // rows) if nrows else 1


def _lookback(status, blk, count):
    """``route_lookback`` with one bin: publish the block's count, read
    the earlier blocks' words 32 at a time (lane l the l-th nearest; before
    block 0 a prefix of 0) until one holds an inclusive prefix, publish the
    block's own; returns the hits before the block."""
    if blk == 0:
        status[0] = (PREFIX_FLAG, count)
        return 0
    status[blk] = (COUNT_FLAG, count)
    prefix, top = 0, blk - 1
    while True:
        words = [status[top - lane] if top - lane >= 0 else (PREFIX_FLAG, 0)
                 for lane in range(32)]
        assert all(flag for flag, _ in words), 'a block was not published'
        done = [lane for lane, (flag, _) in enumerate(words)
                if flag == PREFIX_FLAG]
        if done:
            prefix += sum(v for _, v in words[:done[0] + 1])
            break
        prefix += sum(v for _, v in words)
        top -= 32
    status[blk] = (PREFIX_FLAG, prefix + count)
    return prefix


def _emulate_screen_reads(words, nsamples, ncase, codes, lengths, ksize,
                          casemin, ctrlmax, screen, numbands, band, max_hits,
                          order=None, early=True):
    """``kt_screen_reads`` in Python integers (change with the kernel in
    csrc/kmer.cu).  Each block stages its rows, marks the rows to skip from
    its threads' runs (the bases each run's windows start at, the row's
    last run to the end of the row), and each thread's run takes K1's
    hashes (the kernel rolls the same bits with K1's Roller) in chunks:
    ``mod_by``'s bucket indices, the word loads of the kept windows (with
    ``early`` and no abundance screen, table 0 first and the other tables
    only where no case byte lies below casemin), ``__vminu4`` over the
    tables, the four-byte compares against byte masks, the first failing
    case by ``__ffs``.  The blocks start in ``order`` (a permutation of
    their indices, the ticket's order): every block counts its hits and
    publishes them first, then in the same order each block scans its
    threads' counts in run order, finds its first rank by the look-back
    and stores its hits below the capacity; the last block pads.  Returns
    the kernel's five outputs and the words it loaded."""
    W = len(words)
    T, Z = words[0].shape
    magic = kmer_cuda.mod_magic(Z)
    flat_words = [w.numpy().view(np.uint32).reshape(-1).tolist()
                  for w in words]
    h1, h2, valid = hashing.kmer_hashes_plain(codes, ksize)
    a = h1.numpy().view(np.uint32).reshape(-1).tolist()
    b = h2.numpy().view(np.uint32).reshape(-1).tolist()
    ok = valid.numpy().reshape(-1).tolist()
    codes, lengths = codes.numpy(), lengths.numpy()
    nrows, L = codes.shape
    P = L - ksize + 1
    run, runs_per_row, rows, nblocks = _screen_geometry(nrows, P)
    bandmask, bandval = (numbands - 1, band) if numbands else (0, 0)
    casem = [sum(0xff << (8 * j) for j in range(4) if 4 * w + j < ncase)
             for w in range(W)]
    ctrlm = [sum(0xff << (8 * j) for j in range(4)
                 if ncase <= 4 * w + j < nsamples) for w in range(W)]
    cmin, cmax = casemin * 0x01010101, ctrlmax * 0x01010101
    early = early and screen is None
    hit_idx = [None] * max_hits
    hit_ab = [[None] * max_hits for _ in range(nsamples)]
    discard, skip = [None] * nrows, [None] * nrows
    status = [(0, 0)] * nblocks
    loads = 0

    def screen_run(g0, nw, disc):
        """(hits, their flat indices and abundances) of a thread's run."""
        nonlocal loads
        hits = []
        for c0 in range(0, nw, SCREEN_CHUNK):
            for g in range(g0 + c0, g0 + min(c0 + SCREEN_CHUNK, nw)):
                if not (ok[g] and (a[g] & bandmask) == bandval):
                    continue
                idx = [_mod_by((a[g] + t * b[g]) & 0xFFFFFFFF, Z, magic)
                       for t in range(T)]
                word = [[flat_words[w][idx[0]]] for w in range(W)]
                loads += W
                if early and any(~_vcmpgeu4(word[w][0], cmin) & casem[w]
                                 for w in range(W)):
                    continue
                for w in range(W):
                    word[w] += [flat_words[w][t * Z + idx[t]]
                                for t in range(1, T)]
                loads += W * (T - 1)
                m = []
                for w in range(W):
                    x = word[w][0]
                    for t in range(1, T):
                        x = _vminu4(x, word[w][t])
                    m.append(x)
                below = [~_vcmpgeu4(m[w], cmin) & casem[w] for w in range(W)]
                above = 0
                for w in range(W):
                    above |= ~_vcmpleu4(m[w], cmax) & ctrlm[w]
                if any(below) and screen is not None:
                    w = next(w for w in range(W) if below[w])
                    low = below[w] & -below[w]             # __ffs
                    if (m[w] >> ((low.bit_length() - 1) & ~7)) & 0xff < \
                            screen:
                        disc[0] = True
                if not any(below) and not above:
                    hits.append((g, [(m[s // 4] >> (8 * (s % 4))) & 0xff
                                     for s in range(nsamples)]))
        return hits

    order = list(range(nblocks)) if order is None else list(order)
    assert sorted(order) == list(range(nblocks))
    blocks = {}
    for blk in order:
        # stage, skip flags, the first pass
        row0 = blk * rows
        nr = max(0, min(rows, nrows - row0))
        s_skip = [lengths[row0 + r] < ksize for r in range(nr)]
        s_disc = [[False] for _ in range(nr)]
        threads = []
        for tid in range(SCREEN_THREADS):
            row, q = divmod(tid, runs_per_row)
            p0 = q * run
            if row >= nr or p0 >= P:
                continue
            nw = min(run, P - p0)
            end = p0 + nw if p0 + nw < P else L
            for i in range(p0, min(end, lengths[row0 + row])):
                if codes[row0 + row, i] >= 4:
                    s_skip[row] = True
                    break
            threads.append((tid, row, p0, nw))
        counts = [len(screen_run((row0 + row) * P + p0, nw, s_disc[row]))
                  if not s_skip[row] else 0 for tid, row, p0, nw in threads]
        if blk == 0:
            status[0] = (PREFIX_FLAG, sum(counts))
        else:
            status[blk] = (COUNT_FLAG, sum(counts))
        blocks[blk] = (row0, nr, s_skip, s_disc, threads, counts)
    total = None
    for blk in order:
        row0, nr, s_skip, s_disc, threads, counts = blocks[blk]
        base = _lookback(status, blk, sum(counts))
        before = base
        for (tid, row, p0, nw), count in zip(threads, counts):
            if count and before < max_hits:
                for slot, (g, ab) in enumerate(
                        screen_run((row0 + row) * P + p0, nw, [False]),
                        start=before):
                    if slot < max_hits:
                        hit_idx[slot] = g
                        for s in range(nsamples):
                            hit_ab[s][slot] = ab[s]
            before += count
        for r in range(nr):
            skip[row0 + r] = bool(s_skip[r])
            discard[row0 + r] = s_disc[r][0] and not s_skip[r]
        if blk == nblocks - 1:
            total = base + sum(counts)
            for slot in range(total, max_hits):
                hit_idx[slot] = -1
                for s in range(nsamples):
                    hit_ab[s][slot] = 0
    assert None not in hit_idx and None not in discard
    return (torch.tensor(hit_idx, dtype=torch.int32),
            torch.tensor(hit_ab, dtype=torch.uint8),
            torch.tensor(total, dtype=torch.int32), torch.tensor(discard),
            torch.tensor(skip)), loads


@pytest.mark.parametrize('case,order', [
    ('1 case, 1 control, screen None, no band', None),
    ('2 cases, 2 controls, screen 3, no band', None),
    ('2 cases, 5 controls, screen 3, band 1 of 4', None),
    ('1 case, 5 controls, screen None, band 1 of 4', None),
    ('max_hits below the hits', 1),
    ('2 cases, 5 controls, screen None, band 1 of 4', 2),
    ('many blocks', 3)])
def test_emulated_screen_kernel_matches_its_plain_version(case, order):
    """``kt_screen_reads``' schedule and arithmetic emulated in Python
    integers (``_emulate_screen_reads``) equal
    ``novel_screen_compact_plain``, with the blocks started in their order
    and in orders shuffled from a seed; change ``screen_reads_kernel`` in
    csrc/kmer.cu and this emulation together.  Without the abundance
    screen the early exit loads fewer words and changes nothing."""
    if case == 'many blocks':
        # 1,000 rows, 23 a block: 44 blocks, look-backs past 32 of them
        rng = np.random.default_rng(44)
        codes = rng.integers(0, 4, (1000, L), dtype=np.uint8)
        codes[::50, 30] = 4
        lengths = np.full(1000, L, np.int32)
        lengths[-3:] = 0
        tables = _tables(45, 1, 2)
        words = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                               for t in tables])
        args = (words, 3, 1, torch.from_numpy(codes),
                torch.from_numpy(lengths), KSIZE, CASEMIN, CTRLMAX, None,
                None, None)
        max_hits = 300
    else:
        args, max_hits = _plain_args(case)
    nblocks = _screen_geometry(args[3].shape[0], L - KSIZE + 1)[3]
    perm = None if order is None else \
        np.random.default_rng(order).permutation(nblocks).tolist()
    got, loads = _emulate_screen_reads(*args, max_hits, order=perm)
    want = novel_ops.novel_screen_compact_plain(*args, max_hits=max_hits)
    assert int(want[2]) > 0
    _assert_same(got, want)
    if case == 'many blocks':
        assert nblocks > 32 and int(want[2]) > max_hits
    if args[8] is None:
        late, all_loads = _emulate_screen_reads(*args, max_hits, order=perm,
                                                early=False)
        _assert_same(late, want)
        assert loads < all_loads
