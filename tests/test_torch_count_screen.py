"""The port's fused count and screen (``count_and_screen_stack_packed``)
and its packed-word gather against the JAX package.

Tolerance: none.  Counts, hit indices and abundances are integers, so the
five per-batch outputs (``hit_idx``, ``hit_abunds``, ``n_hits``,
``discard``, ``skip``) and every table must be bit-identical.  On the CPU
the port's wrappers run the plain PyTorch versions of its kernels; the
``cuda``-marked tests hold the word-gather kernel and the whole program on
a card to those plain versions (they skip without one).

The inputs are a small trio in the manner of ``bench.py``: a 6 kb random
genome, the proband with five SNVs and a few reads of foreign sequence,
30x of 150 bp reads padded to 160 in batches of 256 (the last batch padded
with rows of code 4 and length 0), one case read with an N inside its
length, one whose length is shorter than its bases (an N past its length),
and an N in a control read.

The JAX package is imported inside the tests that compare with it, so the
``cuda`` tests also run where JAX is absent (the machine with the card):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_count_screen.py
"""

import numpy as np
import pytest
import torch

from kevlar_tpu_torch.batch import pack_bases
from kevlar_tpu_torch.ops import kmer_cuda, novel_ops, sketch_ops

GENOME_LEN = 6000
READLEN = 150
L = 160
B = 256
TABLESIZE = 20_011
CASEMIN, CTRLMAX = 6, 1
SEED = 20260817


def _tile(rng, genome, coverage=30):
    n = len(genome) * coverage // READLEN
    starts = rng.integers(0, len(genome) - READLEN, size=n)
    reads = np.full((n, L), 4, dtype=np.uint8)
    reads[:, :READLEN] = genome[starts[:, None] + np.arange(READLEN)]
    return reads


def _stack(reads):
    nb = -(-len(reads) // B)
    out = np.full((nb * B, L), 4, dtype=np.uint8)
    out[:len(reads)] = reads
    return out.reshape(nb, B, L)


@pytest.fixture(scope='module')
def trio():
    """(case stack, case lengths, [mother stack, father stack]) as numpy."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.uint8)
    child = genome.copy()
    snvs = rng.choice(GENOME_LEN - 100, size=5, replace=False) + 50
    child[snvs] = (child[snvs] + rng.integers(1, 4, size=5)) % 4
    case = _tile(rng, child)
    # reads of foreign sequence: case counts of 1, below any screen
    case[:6, :READLEN] = rng.integers(0, 4, (6, READLEN), dtype=np.uint8)
    case[10, 70] = 4                    # an N inside the read: skipped
    case[11, 120] = 4                   # an N past the read's length
    lengths = np.full(len(case), READLEN, np.int32)
    lengths[11] = 100                   # shorter than its bases
    case_stack = _stack(case)
    lens = np.zeros(case_stack.shape[:2], np.int32)
    lens.reshape(-1)[:len(case)] = lengths
    controls = [_tile(rng, genome) for _ in range(2)]
    controls[0][3, 40] = 4
    return case_stack, lens, [_stack(c) for c in controls]


def _packed(trio, nctrl):
    """The trio's stacks in the 2-bit wire format: (case packed, case
    badmask, control packed tuple, control badmask tuple, lengths)."""
    case, lens, controls = trio
    cp, cb = pack_bases(case)
    ctrl = [pack_bases(c) for c in controls[:nctrl]]
    return (cp, cb, tuple(p for p, _ in ctrl), tuple(b for _, b in ctrl),
            lens)


def _port(packed, device='cpu', **kw):
    cp, cb, ctrl_p, ctrl_b, lens = packed
    t = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    return novel_ops.count_and_screen_stack_packed(
        t(cp), t(cb), tuple(t(p) for p in ctrl_p),
        tuple(t(b) for b in ctrl_b), t(lens), L=L, tablesize=TABLESIZE,
        ntables=4, **kw)


def _jax(packed, **kw):
    import jax.numpy as jnp
    from kevlar_tpu.ops import novel_ops as jax_novel_ops
    cp, cb, ctrl_p, ctrl_b, lens = packed
    return jax_novel_ops.count_and_screen_stack_packed(
        jnp.asarray(cp), jnp.asarray(cb),
        tuple(jnp.asarray(p) for p in ctrl_p),
        tuple(jnp.asarray(b) for b in ctrl_b), jnp.asarray(lens), L=L,
        tablesize=TABLESIZE, ntables=4, **kw)


OUTPUTS = ('hit_idx', 'hit_abunds', 'n_hits', 'discard', 'skip')


def _assert_same(got, want):
    """Port (tensors) against JAX or the port again: every output and
    table equal in shape, dtype and value."""
    (outs, case_tables, ctrl_tables) = got
    (w_outs, w_case, w_ctrl) = want
    pairs = list(zip(OUTPUTS, outs, w_outs)) + [('case tables', case_tables,
                                                 w_case)]
    pairs += [('control {} tables'.format(i), a, b)
              for i, (a, b) in enumerate(zip(ctrl_tables, w_ctrl))]
    assert len(ctrl_tables) == len(w_ctrl)
    for name, a, b in pairs:
        a = a.cpu().numpy()
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


CASES = {
    'no controls': dict(nctrl=0),
    'one control': dict(nctrl=1),
    'two controls': dict(nctrl=2),
    'k21, one control': dict(nctrl=1, ksize=21),
    'k21, two controls': dict(nctrl=2, ksize=21),
    'screen': dict(nctrl=2, screen=3),
    'screen, no controls': dict(nctrl=0, screen=3, ksize=21),
    'max_hits below the hits': dict(nctrl=2, max_hits=64),
    'maxcount 7': dict(nctrl=1, maxcount=7),
}


@pytest.mark.parametrize('case', list(CASES))
def test_program_matches_jax(trio, case):
    kw = dict(CASES[case])
    packed = _packed(trio, kw.pop('nctrl'))
    kw = dict(dict(ksize=31, maxcount=255, casemin=CASEMIN,
                   ctrlmax=CTRLMAX), **kw)
    got = _port(packed, **kw)
    _assert_same(got, _jax(packed, **kw))
    hit_idx, _, n_hits, discard, skip = got[0]
    assert int(n_hits.sum()) > 0
    # the N inside read 10's length skips it; read 11's N lies past its
    # length; padding rows are skipped
    assert bool(skip[0, 10]) and not bool(skip[0, 11])
    assert bool(skip[-1, -1])
    if 'max_hits' in kw:
        assert int(n_hits.max()) > kw['max_hits']
        assert bool((hit_idx >= 0).all())
    if 'screen' in kw:
        assert bool(discard.any())


@pytest.mark.parametrize('nctrl', [0, 2])
def test_program_matches_its_unfused_path(trio, nctrl):
    """The program equals the port's own count (an Accumulator per
    sample, batch by batch) and screen (``novel_screen``, uncapped, on the
    unpacked codes), as tests/test_novel.py holds JAX's to its own."""
    case, lens, controls = trio
    packed = _packed(trio, nctrl)
    (hit_idx, hit_abunds, n_hits, discard, skip), case_tables, ctrl_tables = \
        _port(packed, ksize=31, maxcount=255, casemin=CASEMIN,
              ctrlmax=CTRLMAX)
    tables = []
    for stack in [case] + controls[:nctrl]:
        acc = sketch_ops.Accumulator(
            torch.zeros((4, TABLESIZE), dtype=torch.uint8), 8, TABLESIZE)
        for batch in stack:
            sketch_ops.consume_codes(acc, torch.from_numpy(batch), 31)
        tables.append(acc.tables())
    assert torch.equal(case_tables, tables[0])
    assert all(torch.equal(a, b) for a, b in zip(ctrl_tables, tables[1:]))
    samples = [(t, 8, TABLESIZE) for t in tables]
    for i, batch in enumerate(case):
        hits, abunds, disc = novel_ops.novel_screen(
            samples, 1, torch.from_numpy(batch), torch.from_numpy(lens[i]),
            31, CASEMIN, CTRLMAX)
        n = int(n_hits[i])
        assert n == hits.numel()
        assert torch.equal(hit_idx[i, :n].long(), hits)
        assert bool((hit_idx[i, n:] == -1).all())
        assert torch.equal(hit_abunds[i, :, :n], abunds)
        assert not bool(hit_abunds[i, :, n:].any())
        assert torch.equal(discard[i], disc)


def _random_tables(rng, nsamples, ntables=4, tablesize=997):
    return [rng.integers(0, 256, (ntables, tablesize), dtype=np.uint8)
            for _ in range(nsamples)]


def _random_hashes(rng, n):
    h = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
    h[1] |= 1
    h[:, :3] = [[0, 1, 2**32 - 1], [1, 2**32 - 1, 3]]
    return h


@pytest.mark.parametrize('nsamples', [1, 2, 3, 4, 5, 6])
def test_pack_sample_tables_matches_jax(nsamples):
    import jax.numpy as jnp
    from kevlar_tpu.ops import sketch_ops as jax_sketch_ops
    tables = _random_tables(np.random.default_rng(nsamples), nsamples)
    got = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                         for t in tables])
    want = jax_sketch_ops.pack_sample_tables([jnp.asarray(t)
                                              for t in tables])
    assert len(got) == len(want) == -(-nsamples // 4)
    for mine, ref in zip(got, want):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy().view(np.uint32), np.asarray(ref))


@pytest.mark.parametrize('nsamples', [1, 2, 3, 4, 5, 6])
def test_word_gather_matches_jax_and_per_sample(nsamples):
    """The word gather's plain version against JAX's
    ``gather_counts_multi`` on packed words and against the port's
    per-sample gather (K2's plain version), with a partial final word,
    as tests/test_sketch.py holds JAX's to its per-sample gather."""
    import jax.numpy as jnp
    from kevlar_tpu.ops import sketch_ops as jax_sketch_ops
    rng = np.random.default_rng(100 + nsamples)
    tables = _random_tables(rng, nsamples)
    h = _random_hashes(rng, 5 * 17)
    words = sketch_ops.pack_sample_tables([torch.from_numpy(t)
                                           for t in tables])
    h1, h2 = (torch.from_numpy(x.view(np.int32)) for x in h)
    got = sketch_ops.gather_counts_words(words, nsamples, h1, h2)
    jax_words = jax_sketch_ops.pack_sample_tables([jnp.asarray(t)
                                                   for t in tables])
    want = jax_sketch_ops.gather_counts_multi(
        jax_words, nsamples, jnp.asarray(h[0]), jnp.asarray(h[1]))
    assert got.dtype == torch.uint8 and got.shape == (nsamples, 85)
    assert np.array_equal(got.numpy(), np.asarray(want))
    per_sample = sketch_ops.gather_counts_multi(
        [(torch.from_numpy(t), 8, t.shape[1]) for t in tables], h1, h2)
    assert torch.equal(got, per_sample)


def test_word_gather_checks_its_inputs():
    tables = [torch.zeros((4, 11), dtype=torch.uint8)] * 5
    words = sketch_ops.pack_sample_tables(tables)
    h = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_words(words, 9, h, h)      # needs 3 words
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_words(words, 5, h.long(), h)
    with pytest.raises(ValueError):
        sketch_ops.pack_sample_tables(tables[:1] +
                                      [torch.zeros((4, 12), dtype=torch.uint8)])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('nsamples,ntables', [(1, 4), (3, 4), (4, 4),
                                              (5, 4), (9, 4), (17, 4),
                                              (3, 3), (6, 5)])
def test_word_gather_kernel_matches_plain_on_card(cuda_device, nsamples,
                                                  ntables):
    """Every word count a launch takes, a partial final word, more word
    tensors than one launch serves, and table counts other than 4 (the
    kernel's general instance)."""
    rng = np.random.default_rng(nsamples * 10 + ntables)
    tables = [torch.from_numpy(t).to(cuda_device) for t in
              _random_tables(rng, nsamples, ntables, tablesize=100_003)]
    words = sketch_ops.pack_sample_tables(tables)
    h = torch.from_numpy(_random_hashes(rng, 70_001).view(np.int32)).to(
        cuda_device)
    got = kmer_cuda.gather_words_cuda(words, nsamples, h[0], h[1])
    want = sketch_ops.gather_counts_words_plain(words, nsamples, h[0], h[1])
    assert torch.equal(got, want)
    assert torch.equal(got, sketch_ops.gather_counts_multi_plain(
        [(t, 8, 100_003) for t in tables], h[0], h[1]))


@pytest.mark.cuda
@pytest.mark.parametrize('nctrl', [0, 2])
def test_program_on_card_matches_cpu(trio, cuda_device, nctrl):
    """The whole program on the card (K1, ``kt_consume``, then
    ``kt_screen_words`` and ``kt_compact_hits``, or K2 with the case
    alone) against the same program on the CPU (the plain versions)."""
    packed = _packed(trio, nctrl)
    kw = dict(ksize=31, maxcount=255, casemin=CASEMIN, ctrlmax=CTRLMAX,
              screen=3, max_hits=64)
    before = dict(kmer_cuda.launches)
    got = _port(packed, device=cuda_device, **kw)
    torch.cuda.synchronize()
    _assert_same(got, _port(packed, **kw))
    assert kmer_cuda.launches['consume'] > before['consume']
    screens = ('screen_words', 'compact_hits') if nctrl else \
        ('gather_counts',)
    for name in screens:
        assert kmer_cuda.launches[name] > before[name]
