"""The port's screen over packed sample words (``novel_screen_compact``)
against the JAX package's ``novel_screen_compact(..., packed=...)``, and
the novel stage's choice between it and the per-sample gather.

Tolerance: none.  Counts, hit indices and abundances are integers, so the
five outputs (``hit_idx``, ``hit_abunds``, ``n_hits``, ``discard``,
``skip``) must be bit-identical.  On the CPU the port runs the plain
PyTorch version of its two kernels (the word gather, the predicates and
the fixed-capacity compaction); the plain versions of each kernel
(``screen_words_plain``, ``compact_hits_plain``) must compose to it at any
block size.  The ``cuda``-marked tests hold ``kt_screen_words`` and
``kt_compact_hits`` on a card to those plain versions (they skip without
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
    c = torch.from_numpy(codes).to(device)
    h1, h2, valid = hashing.kmer_hashes_codes(c, KSIZE)
    return novel_ops.novel_screen_compact(
        words, len(tables), ncase, h1, h2, valid, c,
        torch.from_numpy(lengths).to(device), **kw)


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
def test_kernel_plain_versions_compose_to_the_screen(case):
    """``screen_words_plain`` then ``compact_hits_plain`` (the plain
    versions of the two kernels, which the card holds its kernels to)
    equal ``novel_screen_compact_plain`` at any rows a block, and each
    block's filled prefix holds its own hits in flat order."""
    tables, ncase, codes, lengths, kw = _inputs(case)
    words = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                           for t in tables])
    c = torch.from_numpy(codes)
    h1, h2, valid = hashing.kmer_hashes_codes(c, KSIZE)
    args = (words, len(tables), ncase, h1, h2, valid, c,
            torch.from_numpy(lengths), KSIZE, CASEMIN, CTRLMAX,
            kw['screen'], kw.get('numbands'), kw.get('band'))
    want = novel_ops.novel_screen_compact_plain(*args, kw['max_hits'])
    P = L - KSIZE + 1
    assert novel_ops.screen_rows(P) == novel_ops.SCREEN_BLOCK_KMERS // P
    for rows in (1, 5, novel_ops.screen_rows(P), B + 3):
        counts, seg_idx, seg_ab, discard, skip = novel_ops.screen_words_plain(
            *args, rows)
        assert counts.shape == (-(-B // rows),)
        assert int(counts.sum()) == int(want[2])
        for b, cnt in enumerate(counts.tolist()):
            seg = seg_idx[b * rows * P:b * rows * P + cnt]
            assert bool((seg >= b * rows * P).all())
            assert bool((seg < (b + 1) * rows * P).all())
            assert bool((seg[1:] > seg[:-1]).all())
        got = novel_ops.compact_hits_plain(counts, seg_idx, seg_ab,
                                           rows * P, kw['max_hits'])
        _assert_same(got + (discard, skip), want)


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
    h1, h2, valid = hashing.kmer_hashes_codes(c, KSIZE)
    lens = torch.from_numpy(lengths)

    def call(**changes):
        args = dict(words=words, nsamples=3, ncase=1, h1=h1, h2=h2,
                    valid=valid, codes=c, lengths=lens, ksize=KSIZE,
                    casemin=CASEMIN, ctrlmax=CTRLMAX)
        args.update(changes)
        return novel_ops.novel_screen_compact(**args)

    call()
    for bad in (dict(nsamples=5), dict(ncase=0), dict(ncase=4),
                dict(h1=h1.long()), dict(valid=valid.bool()),
                dict(lengths=lens.long()), dict(ksize=KSIZE + 1),
                dict(casemin=256), dict(screen=-1), dict(max_hits=0),
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


def _filled_equal(got, want, rows, P):
    """``kt_screen_words``' outputs against its plain version's: the block
    counts, each block's filled prefix (the kernel leaves the rest
    unwritten), discard and skip."""
    counts, seg_idx, seg_ab, discard, skip = got
    assert torch.equal(counts, want[0])
    assert torch.equal(discard, want[3]) and torch.equal(skip, want[4])
    n = seg_idx.numel()
    index = torch.arange(n, device=seg_idx.device)
    block = index // (rows * P)
    filled = index - block * rows * P < counts.long()[block]
    assert torch.equal(seg_idx[filled], want[1][filled])
    assert torch.equal(seg_ab[:, filled], want[2][:, filled])


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    '1 case, 2 controls, screen None, no band',
    '2 cases, 5 controls, screen 3, band 1 of 4',
    'max_hits below the hits'])
def test_screen_kernels_match_plain_on_card(cuda_device, case):
    """Each kernel against its plain version on the same inputs, and the
    whole screen on the card against the same screen on the CPU."""
    tables, ncase, codes, lengths, kw = _inputs(case)
    words = sketch_ops.pack_sample_tables(
        [torch.from_numpy(t).to(cuda_device) for t in tables])
    c = torch.from_numpy(codes).to(cuda_device)
    lens = torch.from_numpy(lengths).to(cuda_device)
    h1, h2, valid = hashing.kmer_hashes_codes(c, KSIZE)
    P = L - KSIZE + 1
    args = (words, len(tables), ncase, h1, h2, valid, c, lens, KSIZE,
            CASEMIN, CTRLMAX, kw['screen'], kw.get('numbands'),
            kw.get('band'))
    for rows in (1, 5, novel_ops.screen_rows(P)):
        got = kmer_cuda.screen_words_cuda(*args, rows)
        _filled_equal(got, novel_ops.screen_words_plain(*args, rows), rows,
                      P)
        hits = kmer_cuda.compact_hits_cuda(got[0], got[1], got[2],
                                           rows * P, kw['max_hits'])
        want = novel_ops.compact_hits_plain(got[0], got[1], got[2],
                                            rows * P, kw['max_hits'])
        for a, b in zip(hits, want):
            assert torch.equal(a, b)
    before = dict(kmer_cuda.launches)
    got = _port(tables, ncase, codes, lengths, kw, device=cuda_device)
    torch.cuda.synchronize()
    _assert_same(got, _port(tables, ncase, codes, lengths, kw))
    assert kmer_cuda.launches['screen_words'] == before['screen_words'] + 1
    assert kmer_cuda.launches['compact_hits'] == before['compact_hits'] + 1


@pytest.mark.cuda
def test_screen_kernels_on_a_dense_batch_on_card(cuda_device):
    """Every k-mer a hit (controls at 0, casemin 0): many blocks full and a
    capacity far below the hits."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (3000, 160), dtype=np.uint8)
    lengths = np.full(3000, 150, np.int32)
    codes[:, 150:] = 4
    tables = [rng.integers(0, 256, (4, 100_003), dtype=np.uint8)] + \
        [np.zeros((4, 100_003), np.uint8)] * 2
    kw = dict(ksize=31, casemin=0, ctrlmax=0, max_hits=32768)
    words = sketch_ops.pack_sample_tables(
        [torch.from_numpy(t).to(cuda_device) for t in tables])
    c = torch.from_numpy(codes).to(cuda_device)
    h1, h2, valid = hashing.kmer_hashes_codes(c, 31)
    got = novel_ops.novel_screen_compact(
        words, 3, 1, h1, h2, valid, c,
        torch.from_numpy(lengths).to(cuda_device), **kw)
    want = novel_ops.novel_screen_compact_plain(
        words, 3, 1, h1, h2, valid, c,
        torch.from_numpy(lengths).to(cuda_device), **kw)
    assert int(got[2]) == 3000 * 120
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


def _emulate_screen_words(words, nsamples, ncase, h1, h2, valid, codes,
                          lengths, ksize, casemin, ctrlmax, screen,
                          numbands, band, rows):
    """``kt_screen_words`` in Python integers, block by block and 256
    threads a step as the kernel runs: the skip flags from the codes, the
    byte masks of the cases and controls, each kept k-mer's word loads at
    ``mod_by``'s indices, ``__vminu4`` over the tables, the four-byte
    predicates, the first failing case by ``__ffs``, the warps' ballots
    and ranks.  Returns the kernel's outputs, its unwritten slots -1 and
    0."""
    W = len(words)
    T, Z = words[0].shape
    magic = kmer_cuda.mod_magic(Z)
    flat_words = [w.numpy().view(np.uint32).reshape(-1).tolist()
                  for w in words]
    a = (h1.numpy().view(np.uint32).reshape(-1)).tolist()
    b = (h2.numpy().view(np.uint32).reshape(-1)).tolist()
    ok = valid.numpy().reshape(-1).tolist()
    codes, lengths = codes.numpy(), lengths.numpy()
    nrows, L = codes.shape
    P = L - ksize + 1
    n = nrows * P
    seg_idx = [-1] * n
    seg_ab = [[0] * n for _ in range(nsamples)]
    counts, discard, skip = [], [False] * nrows, [False] * nrows
    bandmask, bandval = (numbands - 1, band) if numbands else (0, 0)
    casem = [sum(0xff << (8 * j) for j in range(4) if 4 * w + j < ncase)
             for w in range(W)]
    ctrlm = [sum(0xff << (8 * j) for j in range(4)
                 if ncase <= 4 * w + j < nsamples) for w in range(W)]
    cmin, cmax = casemin * 0x01010101, ctrlmax * 0x01010101
    for blk in range(-(-nrows // rows)):
        row0 = blk * rows
        nr = min(rows, nrows - row0)
        s_skip = [lengths[row0 + r] < ksize for r in range(nr)]
        s_disc = [False] * nr
        for i in range(nr * L):
            r, col = divmod(i, L)
            if codes[row0 + r, col] >= 4 and col < lengths[row0 + r]:
                s_skip[r] = True
        base, filled = row0 * P, 0
        for j0 in range(0, nr * P, 256):
            hits = []
            for tid in range(256):
                j = j0 + tid
                if j >= nr * P:
                    break
                g, r = base + j, j // P
                if not (ok[g] and (a[g] & bandmask) == bandval and
                        not s_skip[r]):
                    continue
                idx = [_mod_by((a[g] + t * b[g]) & 0xFFFFFFFF, Z, magic)
                       for t in range(T)]
                m = []
                for w in range(W):
                    x = flat_words[w][idx[0]]
                    for t in range(1, T):
                        x = _vminu4(x, flat_words[w][t * Z + idx[t]])
                    m.append(x)
                below = [~_vcmpgeu4(m[w], cmin) & casem[w] for w in range(W)]
                above = 0
                for w in range(W):
                    above |= ~_vcmpleu4(m[w], cmax) & ctrlm[w]
                if any(below) and screen is not None:
                    w = next(w for w in range(W) if below[w])
                    low = below[w] & -below[w]             # __ffs
                    fail = (m[w] >> ((low.bit_length() - 1) & ~7)) & 0xff
                    if fail < screen:
                        s_disc[r] = True
                if not any(below) and not above:
                    hits.append((tid, j, m))
            # the warps' ballots in warp order, lanes in lane order
            for rank, (tid, j, m) in enumerate(sorted(hits)):
                slot = base + filled + rank
                seg_idx[slot] = base + j
                for s in range(nsamples):
                    seg_ab[s][slot] = (m[s // 4] >> (8 * (s % 4))) & 0xff
            filled += len(hits)
        counts.append(filled)
        for r in range(nr):
            skip[row0 + r] = s_skip[r]
            discard[row0 + r] = s_disc[r] and not s_skip[r]
    return (torch.tensor(counts, dtype=torch.int32),
            torch.tensor(seg_idx, dtype=torch.int32),
            torch.tensor(seg_ab, dtype=torch.uint8).reshape(nsamples, n),
            torch.tensor(discard), torch.tensor(skip))


@pytest.mark.parametrize('case', [
    '1 case, 1 control, screen None, no band',
    '2 cases, 2 controls, screen 3, no band',
    '2 cases, 5 controls, screen 3, band 1 of 4',
    '1 case, 5 controls, screen None, band 1 of 4'])
def test_emulated_screen_kernel_matches_its_plain_version(case):
    """The kernel's arithmetic (``mod_by``, ``__vminu4``, the four-byte
    compares against byte masks, ``__ffs`` for the first failing case, the
    ballot ranks) emulated in Python integers equals
    ``screen_words_plain``, unwritten slots aside; change
    ``screen_words_kernel`` in csrc/kmer.cu and this emulation together."""
    tables, ncase, codes, lengths, kw = _inputs(case)
    words = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                           for t in tables])
    c = torch.from_numpy(codes)
    h1, h2, valid = hashing.kmer_hashes_codes(c, KSIZE)
    P = L - KSIZE + 1
    rows = novel_ops.screen_rows(P)
    args = (words, len(tables), ncase, h1, h2, valid, c,
            torch.from_numpy(lengths), KSIZE, CASEMIN, CTRLMAX,
            kw['screen'], kw.get('numbands'), kw.get('band'), rows)
    got = _emulate_screen_words(*args)
    assert int(got[0].sum()) > 0
    _filled_equal(got, novel_ops.screen_words_plain(*args), rows, P)
