"""The port's ``partition`` subcommand and connected components (B6)
against ``kevlar_tpu``'s.

Tolerance: none.  On the filtered novel reads of a seeded trio both CLIs
must write identical text in relaxed mode, strict mode, with
``--no-dedup``, with ``--split`` (every shard) and with ``--gml`` (the
port with ``--device cpu``).  The port's plain label propagation must give
the labels of ``kevlar_tpu.ops.cc_ops.connected_components_bipartite_jit``
(JAX on the CPU) and of the host union-find, on random graphs, chains,
isolated reads and duplicate pairs, and through the dispatcher on a graph
above ``HOST_CC_THRESHOLD``.  K4 itself (``csrc/cc.cu``, a lock-free
union-find) is emulated in Python integers, :func:`_emulate_union_find`:
its hook and flatten kernels memory access by memory access, with the
threads of the hook kernel interleaved at random between accesses to stand
in for the card's races; its labels must equal all of the above under
every interleaving tried.  The ``cuda``-marked test holds K4 to the plain
version on the card and skips here.

The JAX package is imported inside the tests that compare with it, so the
``cuda`` test also runs where JAX is absent (the machine with the card):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_partition.py
"""

import glob
import os

import numpy as np
import pytest
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch import cli
from kevlar_tpu_torch.ops import cc_cuda, cc_ops


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def filtered(tmp_path_factory):
    """The filtered novel reads of a seeded 20 kb trio (``kevlar_tpu``'s
    count, novel and filter)."""
    from kevlar_tpu import cli as jax_cli
    from .test_torch_filter import make_novel_case
    workdir = tmp_path_factory.mktemp('partition')
    case = make_novel_case(workdir, seed=77)
    path = str(workdir / 'filtered.augfastq')
    jax_cli.main(['filter', '--case-min', '5', '--mask', case['mask'],
                  '-o', path, case['novel']])
    return path


def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize('flags', [[], ['--strict'], ['--no-dedup'],
                                   ['--min-abund', '3', '--max-abund', '8']],
                         ids=['relaxed', 'strict', 'no-dedup', 'abund'])
def test_partition_matches_jax(filtered, tmp_path, flags):
    from kevlar_tpu import cli as jax_cli
    want, got = str(tmp_path / 'jax.augfastq'), str(tmp_path / 'port')
    jax_cli.main(['partition'] + flags + ['-o', want, filtered])
    cli.main(['partition', '--device', 'cpu'] + flags + ['-o', got,
                                                          filtered])
    text = _read(want)
    assert _read(got) == text
    assert text.count(' kvcc=') > 10 and ' kvcc=2\n' in text


def test_partition_split_and_gml_match_jax(filtered, tmp_path):
    from kevlar_tpu import cli as jax_cli
    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    jax_cli.main(['partition', '--split', str(jax_dir / 'part'), '--gml',
                  str(tmp_path / 'jax.gml'), '--strict', filtered])
    cli.main(['partition', '--device', 'cpu', '--split',
              str(port_dir / 'part'), '--gml', str(tmp_path / 'port.gml'),
              '--strict', filtered])
    assert _read(str(tmp_path / 'port.gml')) == \
        _read(str(tmp_path / 'jax.gml'))
    assert 'edge [' in _read(str(tmp_path / 'jax.gml'))
    shards = sorted(os.path.basename(p)
                    for p in glob.glob(str(jax_dir / 'part.cc*')))
    assert len(shards) >= 2
    assert sorted(os.path.basename(p)
                  for p in glob.glob(str(port_dir / 'part.cc*'))) == shards
    import gzip
    for name in shards:
        with gzip.open(str(jax_dir / name), 'rt') as fh:
            expected = fh.read()
        with gzip.open(str(port_dir / name), 'rt') as fh:
            assert fh.read() == expected, name


# -- connected components ---------------------------------------------------

def _graphs():
    """(name, read_ids, kmer_ids, n_reads, n_kmers) test graphs."""
    rng = np.random.default_rng(17)
    out = []
    for n_reads, n_kmers, E in ((50, 80, 60), (300, 200, 400),
                                (1000, 3000, 1500)):
        out.append(('random{}'.format(n_reads),
                    rng.integers(0, n_reads, E), rng.integers(0, n_kmers, E),
                    n_reads, n_kmers))
    # a chain read0 - k0 - read1 - k1 - ..., relabelled at random so the
    # minimum sits in the middle: diameter ~ n_reads
    n = 400
    perm = rng.permutation(n)
    reads = np.concatenate([perm[:-1], perm[1:]])
    kmers = np.concatenate([np.arange(n - 1), np.arange(n - 1)])
    out.append(('chain', reads, kmers, n, n - 1))
    # isolated reads, k-mers with one read, duplicate pairs
    reads = np.array([0, 0, 2, 2, 2, 5, 7, 7])
    kmers = np.array([0, 0, 1, 1, 3, 3, 4, 6])
    out.append(('sparse', reads, kmers, 10, 8))
    out.append(('one-edge', np.array([3]), np.array([0]), 5, 1))
    return [(name, r.astype(np.int32), k.astype(np.int32), nr, nk)
            for name, r, k, nr, nk in out]


@pytest.mark.parametrize('graph', _graphs(), ids=lambda g: g[0])
def test_label_propagation_matches_jax_and_union_find(graph):
    from kevlar_tpu.ops import cc_ops as jax_cc
    _, reads, kmers, n_reads, n_kmers = graph
    want = np.asarray(jax_cc.connected_components_bipartite_jit(
        reads, kmers, n_reads=n_reads, n_kmers=n_kmers))
    got = cc_ops.connected_components_bipartite(
        torch.from_numpy(reads), torch.from_numpy(kmers), n_reads, n_kmers)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cc_ops.host_connected_components(reads, kmers, n_reads, n_kmers),
        want)
    np.testing.assert_array_equal(
        jax_cc.host_connected_components(reads, kmers, n_reads, n_kmers),
        want)


# -- K4's union-find, emulated ------------------------------------------------

def _find_root(parent, x):
    """``find_root`` of csrc/cc.cu as a generator that yields before every
    access to ``parent`` (a load, or the path-halving store), so that a
    scheduler can run other threads in between; returns the root."""
    yield
    p = parent[x]
    while p != x:
        yield
        g = parent[p]
        if g != p:
            yield
            parent[x] = g
        x, p = p, g
    return x


def _hook_thread(parent, read, kmer_node):
    """One thread of ``kt_cc_hook``: link the roots of a pair's two nodes,
    the larger onto the smaller, by compare-and-swap (atomic: no yield
    inside it), retrying from the new roots when the swap loses."""
    a = yield from _find_root(parent, read)
    b = yield from _find_root(parent, kmer_node)
    while a != b:
        hi, lo = max(a, b), min(a, b)
        yield
        seen = parent[hi]
        if seen == hi:
            parent[hi] = lo
            break
        a = yield from _find_root(parent, seen)
        b = yield from _find_root(parent, lo)


def _emulate_union_find(reads, kmers, n_reads, n_kmers, rng, resident):
    """Labels of K4's three kernels: ``kt_cc_init``, then ``kt_cc_hook``
    with one thread a pair, started in a shuffled order, up to ``resident``
    of them alive at a time and the next memory access always made by one
    of those picked at random, then ``kt_cc_flatten``."""
    parent = list(range(n_reads + n_kmers))
    order = rng.permutation(len(reads)).tolist()
    alive = []
    while order or alive:
        while order and len(alive) < resident:
            e = order.pop()
            alive.append(_hook_thread(parent, int(reads[e]),
                                      n_reads + int(kmers[e])))
        slot = int(rng.integers(len(alive)))
        try:
            next(alive[slot])
        except StopIteration:
            alive[slot] = alive[-1]
            alive.pop()
    assert all(parent[i] <= i for i in range(len(parent)))
    labels = np.empty(n_reads, dtype=np.int32)
    for i in range(n_reads):
        x = i
        while parent[x] != x:
            x = parent[x]
        labels[i] = x
    return labels


def _uf_graphs():
    """Small versions of every family of the smoke's ``_cc_graphs``."""
    rng = np.random.default_rng(23)
    reads = rng.integers(0, 300, 1200) * 2            # odd reads isolated
    kmers = rng.integers(0, 2400, 1200)               # most k-mers single
    dup = rng.integers(0, 1200, 300)
    return _graphs() + [
        ('isolated-single-duplicate',
         np.concatenate([reads, reads[dup]]).astype(np.int32),
         np.concatenate([kmers, kmers[dup]]).astype(np.int32), 601, 2400),
        ('hot-kmer', rng.integers(0, 200, 600).astype(np.int32),
         rng.integers(0, 4, 600).astype(np.int32), 200, 4),
        ('E=0', np.zeros(0, np.int32), np.zeros(0, np.int32), 17, 1)]


@pytest.mark.parametrize('resident', [1, 7, 64], ids=lambda r: 'x%d' % r)
@pytest.mark.parametrize('graph', _uf_graphs(), ids=lambda g: g[0])
def test_union_find_emulation_matches_plain_and_jax(graph, resident):
    from kevlar_tpu.ops import cc_ops as jax_cc
    _, reads, kmers, n_reads, n_kmers = graph
    want = cc_ops.connected_components_plain(
        torch.from_numpy(reads), torch.from_numpy(kmers), n_reads,
        n_kmers).numpy()
    np.testing.assert_array_equal(
        cc_ops.host_connected_components(reads, kmers, n_reads, n_kmers),
        want)
    if len(reads):
        np.testing.assert_array_equal(np.asarray(
            jax_cc.connected_components_bipartite_jit(
                reads, kmers, n_reads=n_reads, n_kmers=n_kmers)), want)
    for seed in range(3):
        rng = np.random.default_rng(1000 * resident + seed)
        got = _emulate_union_find(reads, kmers, n_reads, n_kmers, rng,
                                  resident)
        np.testing.assert_array_equal(got, want)


def test_node_count_beyond_int32_is_refused():
    """K4 numbers k-mer j as node n_reads + j in int32."""
    reads = torch.tensor([0], dtype=torch.int32)
    kmers = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match='n_reads \\+ n_kmers'):
        cc_ops.connected_components_bipartite(reads, kmers, 2 ** 29,
                                              2 ** 31 - 2 ** 29)
    with pytest.raises(ValueError, match='2\\^30'):
        cc_ops.connected_components_bipartite(reads, kmers, 2 ** 30, 1)


def test_empty_incidence_keeps_every_read_alone():
    empty = torch.zeros(0, dtype=torch.int32)
    np.testing.assert_array_equal(
        cc_ops.connected_components_bipartite(empty, empty, 7, 1).numpy(),
        np.arange(7))


def test_dispatcher_above_threshold_matches_jax():
    """>= HOST_CC_THRESHOLD pairs: both packages take the propagation
    (the port's plain version on ``cpu``), with equal labels."""
    from kevlar_tpu.ops import cc_ops as jax_cc
    assert cc_ops.HOST_CC_THRESHOLD == jax_cc.HOST_CC_THRESHOLD == 200_000
    rng = np.random.default_rng(3)
    n_reads, n_kmers, E = 60_000, 150_000, 210_000
    reads = rng.integers(0, n_reads, E).astype(np.int32)
    kmers = rng.integers(0, n_kmers, E).astype(np.int32)
    calls = []
    plain = cc_ops.connected_components_bipartite

    def spy(*args):
        calls.append(args[0].device)
        return plain(*args)

    cc_ops.connected_components_bipartite = spy
    try:
        got = cc_ops.connected_components(reads, kmers, n_reads, n_kmers,
                                          device='cpu')
    finally:
        cc_ops.connected_components_bipartite = plain
    assert calls == [torch.device('cpu')]
    want = np.asarray(jax_cc.connected_components(reads, kmers, n_reads,
                                                  n_kmers))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1000


def test_dispatcher_below_threshold_takes_union_find(monkeypatch):
    def refuse(*args):
        raise AssertionError('propagation below the threshold')
    monkeypatch.setattr(cc_ops, 'connected_components_bipartite', refuse)
    reads = np.array([0, 1, 1, 2], dtype=np.int32)
    kmers = np.array([0, 0, 1, 1], dtype=np.int32)
    np.testing.assert_array_equal(
        cc_ops.connected_components(reads, kmers, 4, 2, device='cuda'),
        [0, 0, 0, 3])


def test_wrapper_checks_ids():
    reads = torch.tensor([0, 5], dtype=torch.int32)
    kmers = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match='read ids'):
        cc_ops.connected_components_bipartite(reads, kmers, 5, 2)
    with pytest.raises(ValueError, match='int32'):
        cc_ops.connected_components_bipartite(reads.long(), kmers, 6, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cc_kernel_matches_plain_on_card(cuda_device):
    before = cc_cuda.launches['cc_labels']
    for _, reads, kmers, n_reads, n_kmers in _uf_graphs():
        r = torch.from_numpy(reads).to(cuda_device)
        k = torch.from_numpy(kmers).to(cuda_device)
        got = cc_cuda.cc_labels_cuda(r, k, n_reads, n_kmers)
        want = cc_ops.connected_components_plain(r, k, n_reads, n_kmers)
        assert torch.equal(got, want)
    assert cc_cuda.launches['cc_labels'] == before + len(_uf_graphs())
