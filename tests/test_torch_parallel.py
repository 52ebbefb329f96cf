"""The port's hash-range-sharded sketch (``kevlar_tpu_torch.parallel``)
against ``kevlar_tpu.parallel``.

Tolerance: none — tables, counts, screens, seed ranges and alignments must
be identical.  The port's mesh runs on the CPU (the CPU stands in for every
mesh device, and every kernel runs its plain PyTorch version); JAX's on its
8 virtual CPU devices (tests/conftest.py), at the same mesh shapes.  Also:
the routing kernel's plain version, the bucket ranges of K2 and K3, the
sharded seed search, the mesh-sharded aligner and simlike's batched gather
for sharded sketches.  On a card, ``kt_route`` and the range variants of
``kt_gather_counts`` and ``kt_consume`` are held to their plain versions
in tests/test_torch_hashing.py (which runs without JAX there).
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from kevlar_tpu import dna as jax_dna
from kevlar_tpu.ops import seed_ops as jax_seed_ops
from kevlar_tpu.parallel import (ShardedSketch as JaxShardedSketch,
                                 make_mesh as jax_make_mesh,
                                 sharded_novel_screen as jax_screen)
from kevlar_tpu.reference import SeedIndex as JaxSeedIndex
from kevlar_tpu.sketch import Sketch as JaxSketch
from kevlar_tpu_torch import dna
from kevlar_tpu_torch.ops import seed_ops, sketch_ops
from kevlar_tpu_torch.parallel import (ShardedSketch, collectives,
                                       device_grid, make_mesh,
                                       sharded_novel_screen)
from kevlar_tpu_torch.reference import SeedIndex
from kevlar_tpu_torch.sketch import Sketch

from . import simdata

KSIZE = 21
MESHES = [(1, 8), (2, 4), (8, 1)]


def _bases(seed, rows=24, cols=70):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(rows, cols)).astype(np.uint8)
    bases[3, 50:] = 4      # an ambiguous tail: the validity mask
    bases[7, 10] = 4
    return bases


def _pair(n_data, n_shard, tablesize=4096, bits=8, exact=False):
    """The same empty sketch in both packages, on meshes of one shape."""
    return (JaxShardedSketch(jax_make_mesh(n_data, n_shard), KSIZE,
                             tablesize, counter_bits=bits, exact=exact),
            ShardedSketch(make_mesh(n_data, n_shard, device='cpu'), KSIZE,
                          tablesize, counter_bits=bits, exact=exact))


def test_parallel_imports_no_jax():
    code = ('import sys\n'
            'import kevlar_tpu_torch.parallel\n'
            'import kevlar_tpu_torch.parallel.collectives\n'
            'from kevlar_tpu_torch.parallel import make_mesh, device_grid, '
            'ShardedSketch, sharded_novel_screen\n'
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "kevlar_tpu.")) or m == "kevlar_tpu"]\n'
            'assert not bad, bad\n'
            'print("ok")\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_mesh_shapes_like_jax(monkeypatch):
    # the default grid is all shard; an axis not given takes the rest
    assert make_mesh(device='cpu').shape == {'data': 1, 'shard': 1}
    assert make_mesh(n_shard=4, device='cpu').shape == {'data': 1,
                                                        'shard': 4}
    assert make_mesh(2, 3, device='cpu').shape == {'data': 2, 'shard': 3}
    for n_data, n_shard in MESHES:
        assert jax_make_mesh(n_data, n_shard).shape == \
            make_mesh(n_data, n_shard, device='cpu').shape
    # an explicit device list may repeat a device
    mesh = make_mesh(devices=['cpu'] * 4)
    assert mesh.shape == {'data': 1, 'shard': 4}
    assert mesh.cells() == [(0, 0), (0, 1), (0, 2), (0, 3)]
    mesh = make_mesh(n_data=2, devices=['cpu'] * 4)
    assert mesh.devices == [[torch.device('cpu')] * 2] * 2
    # on 'cuda' the grid must fill every card, as JAX's fills its devices
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert device_grid(n_shard=2)[:2] == (1, 2)
    assert device_grid()[2] == [torch.device('cuda', 0),
                                torch.device('cuda', 1)]
    for n_shard in (3, 4):
        with pytest.raises(ValueError, match='cannot build a .* mesh from 2 '
                           'available device'):
            make_mesh(n_shard=n_shard)
    with pytest.raises(ValueError, match='cannot build'):
        jax_make_mesh(n_shard=3)


@pytest.mark.parametrize('route', ['alltoall', 'replicate'])
@pytest.mark.parametrize('bits', [1, 4, 8])
@pytest.mark.parametrize('n_data,n_shard', MESHES)
def test_sharded_counts_match_jax(n_data, n_shard, bits, route):
    bases = _bases(11)
    want, got = _pair(n_data, n_shard, bits=bits)
    want.consume_batch(bases, route=route)
    got.consume_batch(bases, route=route)
    assert got.tablesize == want.tablesize
    assert got.shard_size == want.shard_size
    assert got.batches[{'alltoall': 'routed',
                        'replicate': 'replicated'}[route]] == 1
    np.testing.assert_array_equal(got._host(), np.asarray(want._host()))
    if bits == 8:   # sub-byte rows keep the port's packing, not JAX's
        for s in range(n_shard):
            np.testing.assert_array_equal(
                got.tables[0][s].numpy(), np.asarray(want.tables)[
                    :, s * got.shard_width:(s + 1) * got.shard_width])
    counts, valid = got.query_batch(bases)
    jcounts, jvalid = want.query_batch(bases)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(valid.numpy() != 0, np.asarray(jvalid))
    assert got.n_occupied() == want.n_occupied()
    # and both are the single-device host engine's counts
    host = JaxSketch(KSIZE, want.tablesize, 4, counter_bits=bits,
                     backend='host')
    host.consume_batch(bases)
    np.testing.assert_array_equal(got._host(), host.tables)


def test_routed_consume_overflow_reruns_replicate():
    """tests/test_parallel.py's overflow case: every read identical, a tiny
    routing capacity; the batch runs down the replicate path instead, with
    the same counts."""
    one = np.tile(np.array([0, 1, 2, 3], np.uint8), 16)[:60]
    bases = np.tile(one, (16, 1))
    want, got = _pair(2, 4)
    want.consume_batch(bases, route='alltoall', a2a_capacity=8)
    got.consume_batch(bases, route='alltoall', a2a_capacity=8)
    assert got.batches == {'routed': 0, 'replicated': 1, 'overflowed': 1}
    np.testing.assert_array_equal(got._host(), np.asarray(want._host()))
    # at the default capacity the same batch routes
    again = ShardedSketch(got.mesh, KSIZE, 4096)
    again.consume_batch(bases)
    assert again.batches == {'routed': 1, 'replicated': 0, 'overflowed': 0}
    np.testing.assert_array_equal(again._host(), got._host())


@pytest.mark.parametrize('consume_masked', [False, True])
@pytest.mark.parametrize('mask_bits', [1, 8])
def test_masked_sharded_consume_matches_jax(mask_bits, consume_masked):
    bases = _bases(21)
    jmesh, mesh = jax_make_mesh(2, 4), make_mesh(2, 4, device='cpu')
    jmask = JaxSketch(KSIZE, 1999, 4, counter_bits=mask_bits)
    mask = Sketch(KSIZE, 1999, 4, counter_bits=mask_bits, device='cpu')
    jmask.consume_batch(bases[::3])
    mask.consume_batch(bases[::3])
    threshold = 1 if consume_masked else 0
    want = JaxShardedSketch(jmesh, KSIZE, 4096, counter_bits=4, exact=True)
    got = ShardedSketch(mesh, KSIZE, 4096, counter_bits=4, exact=True)
    want.consume_batch(bases, mask=JaxShardedSketch.from_sketch(jmesh, jmask),
                       mask_threshold=threshold,
                       consume_masked=consume_masked)
    got.consume_batch(bases, mask=ShardedSketch.from_sketch(mesh, mask),
                      mask_threshold=threshold, consume_masked=consume_masked)
    assert got.batches['replicated'] == 1
    np.testing.assert_array_equal(got._host(), np.asarray(want._host()))
    # the unsharded consume with the same mask counts the same
    single = Sketch(KSIZE, 4096, 4, counter_bits=4, device='cpu')
    single.consume_batch(bases, mask=mask, mask_threshold=threshold,
                         consume_masked=consume_masked)
    np.testing.assert_array_equal(got._host(), single._host())


def test_masked_consume_refuses_an_unsharded_mask():
    sk = ShardedSketch(make_mesh(1, 2, device='cpu'), KSIZE, 4096)
    mask = Sketch(KSIZE, 4096, 4, device='cpu')
    with pytest.raises(ValueError, match='sharded mask on the same mesh'):
        sk.consume_batch(_bases(1), mask=mask)
    with pytest.raises(ValueError, match='banding is superseded'):
        sk.consume_batch(_bases(1), numbands=2, band=0)


def test_consuming_block_saturates_once_like_jax():
    """One accumulator over many batches, saturated when the block ends,
    gives the counts of saturating every batch (adds are monotone): a
    k-mer seen 40 times in 4-bit counters, over 8 batches."""
    read = np.frombuffer(b'ACGTTGCAACGGTACCATGACT', np.uint8)
    codes = dna.encode(read.tobytes().decode())
    bases = np.tile(codes, (5, 1))
    want, got = _pair(2, 4, bits=4)
    with got.consuming():
        for _ in range(8):
            got.consume_batch(bases)
            want.consume_batch(bases)
        assert got.tables is None
    np.testing.assert_array_equal(got._host(), np.asarray(want._host()))
    assert got._host().max() == 15


def test_from_sketch_save_and_point_queries(tmp_path):
    """Re-sharding a counted sketch keeps its exact hash space; the saved
    file loads as a single-device sketch in both packages; point queries
    go through the device batch and agree with the host mirror."""
    rng = random.Random(5)
    seqs = [simdata.make_genome(rng, 90) for _ in range(40)]
    bases, _ = jax_dna.encode_batch(seqs)
    single = Sketch(KSIZE, 10007, 4, device='cpu')
    single.consume_batch(bases)
    jsingle = JaxSketch(KSIZE, 10007, 4)
    jsingle.consume_batch(bases)
    got = ShardedSketch.from_sketch(make_mesh(2, 4, device='cpu'), single)
    want = JaxShardedSketch.from_sketch(jax_make_mesh(2, 4), jsingle)
    assert got.tablesize == want.tablesize == 10007
    np.testing.assert_array_equal(got._host(), np.asarray(want._host()))
    path = str(tmp_path / 'sharded.ct')
    got.save(path)
    from kevlar_tpu import sketch as jax_sketch
    from kevlar_tpu_torch import sketch
    loaded = sketch.load(path, device='cpu')
    assert isinstance(loaded, Sketch)
    np.testing.assert_array_equal(loaded._host(), single._host())
    np.testing.assert_array_equal(
        np.asarray(jax_sketch.load(path)._host()), single._host())
    seq = simdata.make_genome(rng, 120)
    host = [int(c) for c in got._host_counts(
        *jax_dna.kmer_hashes(jax_dna.encode(seq), KSIZE))]
    got._invalidate()
    assert got.get_kmer_counts(seq) == want.get_kmer_counts(seq) == host
    assert got.get(seqs[0][:KSIZE]) == want.get(seqs[0][:KSIZE]) >= 1
    assert got.n_unique_kmers() == want.n_unique_kmers()
    assert got._host_tables is None     # the device paths did not gather
    for sk in (got, want):     # a k-mer with an N: the host hash refuses
        with pytest.raises(ValueError, match='non-ACGT'):
            sk.get('ACGN' + 'A' * (KSIZE - 4))


@pytest.mark.parametrize('case_bits,ctrl_bits', [(4, 8), (1, 4), (8, 4)])
def test_sharded_novel_screen_of_mixed_widths_matches_jax(case_bits,
                                                          ctrl_bits):
    """Sketches of mixed counter widths: both packages read every sketch at
    the case's width (an 8-bit control's bytes as 4-bit counters), and
    neither screens an 8-bit case with narrower controls (the port raises
    for any control narrower than the case)."""
    rng = np.random.default_rng(case_bits * 10 + ctrl_bits)
    bases = rng.integers(0, 4, (16, 60), dtype=np.uint8)
    lengths = np.full(16, 60, np.int32)
    case_j, case_p = _pair(2, 4, bits=case_bits)
    ctrl_j, ctrl_p = _pair(2, 4, bits=ctrl_bits)
    for sk, reads in ((case_j, bases), (ctrl_j, bases[:6]),
                      (case_p, bases), (ctrl_p, bases[:6])):
        sk.consume_batch(reads)
    args = ([case_j], [ctrl_j], bases, lengths)
    kw = dict(casemin=1, ctrlmax=0)
    if case_bits == 8:
        with pytest.raises(TypeError):
            jax_screen(case_j.mesh, *args, **kw)
        with pytest.raises(ValueError):
            sharded_novel_screen(case_p.mesh, [case_p], [ctrl_p], bases,
                                 lengths, **kw)
        return
    interesting, abunds, discard, _ = (np.asarray(x) for x in jax_screen(
        case_j.mesh, *args, **kw))
    hits, hit_abunds, got_discard = (x.numpy() for x in sharded_novel_screen(
        case_p.mesh, [case_p], [ctrl_p], bases, lengths, **kw))
    want_hits = np.flatnonzero(interesting)
    assert len(want_hits)
    np.testing.assert_array_equal(hits, want_hits)
    np.testing.assert_array_equal(
        hit_abunds, abunds.reshape(abunds.shape[0], -1)[:, want_hits])
    np.testing.assert_array_equal(got_discard, discard)


@pytest.mark.parametrize('screen', [None, 7])
def test_sharded_novel_screen_matches_jax(screen):
    rng = random.Random(321)
    genome = simdata.make_genome(rng, 1000)
    child_genome, _, _ = simdata.apply_snv(genome, 500, rng=rng)
    child = simdata.tiled_reads(child_genome, 100, 10, 'c')
    parent = simdata.tiled_reads(genome, 100, 10, 'p')
    cb, _ = jax_dna.encode_batch([r.sequence for r in child])
    pb, _ = jax_dna.encode_batch([r.sequence for r in parent])
    cb[5, 40] = 4
    lengths = np.full(len(child), 100, np.int32)
    lengths[9] = 15
    case_j, case_p = _pair(2, 4, tablesize=100003)
    ctrl_j, ctrl_p = _pair(2, 4, tablesize=100003)
    for sk, reads in ((case_j, cb), (ctrl_j, pb), (case_p, cb),
                      (ctrl_p, pb)):
        sk.consume_batch(reads)
    interesting, abunds, discard, _ = (np.asarray(x) for x in jax_screen(
        case_j.mesh, [case_j], [ctrl_j], cb, lengths, casemin=6, ctrlmax=0,
        screen=screen))
    hits, hit_abunds, got_discard = (x.numpy() for x in sharded_novel_screen(
        case_p.mesh, [case_p], [ctrl_p], cb, lengths, casemin=6, ctrlmax=0,
        screen=screen))
    # the port returns the single-device screen's compacted hits: JAX's
    # dense arrays at its interesting k-mers
    want_hits = np.flatnonzero(interesting)
    np.testing.assert_array_equal(hits, want_hits)
    np.testing.assert_array_equal(
        hit_abunds, abunds.reshape(abunds.shape[0], -1)[:, want_hits])
    np.testing.assert_array_equal(got_discard, discard)
    assert len(hits)
    # and the unsharded screen of the same tables gives the same hits
    from kevlar_tpu_torch.ops import novel_ops
    single = [(sketch_ops.pack_rows(torch.from_numpy(np.ascontiguousarray(
        sk._host())), 8), 8, sk.tablesize) for sk in (case_p, ctrl_p)]
    want = novel_ops.novel_screen(single, 1, torch.from_numpy(cb),
                                  torch.from_numpy(lengths), KSIZE, 6, 0,
                                  screen=screen)
    for mine, theirs in zip((hits, hit_abunds, got_discard), want):
        np.testing.assert_array_equal(mine, theirs.numpy())


def test_route_plain_bins_each_bucket_once():
    """``route_plain``: every kept k-mer's local bucket lands once in the
    bin of its owner, populations count every k-mer, unfilled slots hold
    the sentinel; past the capacity only the population grows."""
    rng = np.random.default_rng(7)
    n, T, S, ss, total = 5000, 4, 3, 4000, 11_999
    h = torch.from_numpy(rng.integers(-2**31, 2**31, (2, n),
                                      dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy((rng.random(n) < 0.8).astype(np.uint8))
    send, pop = sketch_ops.route(h[0], h[1], valid, T, S, ss, total, 2000)
    a = h[0].numpy().view(np.uint32).astype(np.int64)
    b = h[1].numpy().view(np.uint32).astype(np.int64)
    keep = valid.numpy() != 0
    for t in range(T):
        g = ((a + t * b) & 0xFFFFFFFF)[keep] % total
        for s in range(S):
            mine = np.sort(g[g // ss == s] % ss)
            assert pop[t, s] == len(mine)
            row = send[t, s].numpy()
            np.testing.assert_array_equal(np.sort(row[:len(mine)]), mine)
            assert (row[len(mine):] == ss).all()
    tight, tight_pop = sketch_ops.route(h[0], h[1], valid, T, S, ss, total,
                                        100)
    assert torch.equal(tight_pop, pop)
    assert (tight < ss).all()
    assert torch.equal(tight, send[:, :, :100])


def _block_cumsum_route(h1, h2, valid, T, S, ss, total, capacity, blk=127):
    """``kevlar_tpu/parallel/sharded.py:_route_consume``'s send buffer and
    populations, re-derived in numpy: every k-mer's slot in its owner's bin
    is its rank inside a block of ``blk`` k-mers (a cumsum of the one-hot
    owner) plus the exclusive sum of the earlier blocks' totals; a slot
    past the capacity is dropped; unfilled slots hold ``ss``."""
    a = h1.view(np.uint32).astype(np.int64)
    b = h2.view(np.uint32).astype(np.int64)
    K = a.size
    nblk = -(-K // blk)
    send = np.full((T, S, capacity), ss, np.int64)
    pop = np.zeros((T, S), np.int64)
    for t in range(T):
        g = ((a + t * b) & 0xFFFFFFFF) % total
        owner = np.full(nblk * blk, S)
        owner[:K] = np.where(valid != 0, g // ss, S)
        onehot = owner.reshape(nblk, blk)[..., None] == np.arange(S)
        within = np.cumsum(onehot, axis=1)                # [nblk, blk, S]
        totals = within[:, -1, :]
        base = np.cumsum(totals, axis=0) - totals         # exclusive
        ob = np.clip(owner, 0, S - 1).reshape(nblk, blk)
        w = np.take_along_axis(within, ob[..., None], axis=2)[..., 0]
        bb = np.take_along_axis(base, ob, axis=1)
        slot = (bb + w - 1).reshape(-1)[:K]
        keep = (owner[:K] < S) & (slot < capacity)
        send[t, owner[:K][keep], slot[keep]] = (g % ss)[keep]
        pop[t] = totals.sum(axis=0)
    return send, pop


@pytest.mark.parametrize('capacity', [2000, 300])
def test_route_plain_matches_jax_block_cumsum_order(capacity):
    """``route_plain``'s bins are in k-mer order: its whole send buffer and
    its populations equal the block cumsum of ``kevlar_tpu``'s routed
    consume, slot by slot; at capacity 300 every bin overflows and keeps
    its first 300 k-mers."""
    rng = np.random.default_rng(17)
    n, T, S, ss, total = 5000, 4, 3, 4000, 11_999
    h = rng.integers(-2**31, 2**31, (2, n), dtype=np.int64).astype(np.int32)
    valid = (rng.random(n) < 0.8).astype(np.uint8)
    send, pop = sketch_ops.route_plain(
        torch.from_numpy(h[0]), torch.from_numpy(h[1]),
        torch.from_numpy(valid), T, S, ss, total, capacity)
    want_send, want_pop = _block_cumsum_route(h[0], h[1], valid, T, S, ss,
                                              total, capacity)
    np.testing.assert_array_equal(pop.numpy(), want_pop)
    np.testing.assert_array_equal(send.numpy(), want_send)
    assert (int(pop.max()) > capacity) == (capacity == 300)


def test_range_gather_and_consume_plain():
    """K2 and K3 on a range of buckets: the shards' gathers, minimised,
    are the whole table's; the shards' consumes, laid side by side, are
    the whole table's consume."""
    rng = np.random.default_rng(3)
    total, S = 1001, 4
    ss = 256
    h = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 3000),
                                      dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy((rng.random(3000) < 0.9).astype(np.uint8))
    whole = torch.zeros((4, total), dtype=torch.int32)
    sketch_ops.consume_hashes(whole, h[0], h[1], valid)
    parts = []
    for s in range(S):
        acc = torch.zeros((4, ss), dtype=torch.int32)
        sketch_ops.consume_hashes(acc, h[0], h[1], valid, total=total,
                                  lo=s * ss)
        parts.append(acc)
    torch.testing.assert_close(torch.cat(parts, dim=1)[:, :total], whole,
                               rtol=0, atol=0)
    assert int(torch.cat(parts, dim=1)[:, total:].sum()) == 0
    for bits in (1, 4, 8):
        values = whole.clamp(max=sketch_ops.MAXCOUNT[bits]).to(torch.uint8)
        tables = sketch_ops.pack_rows(values, bits)
        want = sketch_ops.gather_counts(tables, h[0], h[1], bits, total)
        padded = torch.nn.functional.pad(values, (0, S * ss - total))
        samples = [(sketch_ops.pack_rows(padded[:, s * ss:(s + 1) * ss]
                                         .contiguous(), bits), bits, total,
                    s * ss, ss) for s in range(S)]
        got = sketch_ops.gather_counts_multi(samples, h[0], h[1])
        assert torch.equal(got.min(dim=0).values, want)
        assert (got == 255).any()      # buckets a shard does not hold


def test_collectives_over_each_axis():
    mesh = make_mesh(2, 3, device='cpu')
    values = [[torch.tensor([10 * d + s]) for s in range(3)]
              for d in range(2)]
    assert [[int(x) for x in row] for row in
            collectives.psum(mesh, values, 'shard')] == [[3] * 3, [33] * 3]
    assert [[int(x) for x in row] for row in
            collectives.psum(mesh, values, 'data')] == [[10, 12, 14]] * 2
    assert [[int(x) for x in row] for row in
            collectives.pmin(mesh, values, 'shard')] == [[0] * 3, [10] * 3]
    assert [[int(x) for x in row] for row in
            collectives.pmax(mesh, values, 'data')] == [[10, 11, 12]] * 2
    send = [[torch.arange(6).reshape(1, 3, 2) + 100 * (3 * d + s)
             for s in range(3)] for d in range(2)]
    recv = collectives.all_to_all(mesh, send)
    for d in range(2):
        for s in range(3):
            for j in range(3):
                assert torch.equal(recv[d][s][:, j], send[d][j][:, s])


def test_all_to_all_parts_matches_stacking():
    """The parts form hands each shard the slices the stacking form
    stacks, as views of the senders' buffers (no copy on one device), the
    populations' slices alike."""
    mesh = make_mesh(2, 3, device='cpu')
    send = [[torch.arange(24, dtype=torch.int32).reshape(2, 3, 4) +
             100 * (3 * d + s) for s in range(3)] for d in range(2)]
    pops = [[torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * s
             for s in range(3)] for d in range(2)]
    parts = collectives.all_to_all_parts(mesh, send)
    stacked = collectives.all_to_all(mesh, send)
    pop_parts = collectives.all_to_all_parts(mesh, pops)
    for d in range(2):
        for s in range(3):
            assert len(parts[d][s]) == 3
            for j in range(3):
                assert torch.equal(parts[d][s][j], stacked[d][s][:, j])
                assert parts[d][s][j].data_ptr() == \
                    send[d][j][:, s].data_ptr()
                assert torch.equal(pop_parts[d][s][j], pops[d][j][:, s])


def _keys_and_queries(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**64 - 2, 700, dtype=np.uint64, endpoint=True)
    ends = np.array([0, 0, 2**63 - 1, 2**63, 2**63, 2**64 - 1, 2**64 - 1],
                    dtype=np.uint64)
    keys = np.sort(np.concatenate([keys, keys[:150], ends]))
    queries = np.concatenate([
        keys[::5], rng.integers(0, 2**64 - 1, 80, dtype=np.uint64,
                                endpoint=True),
        np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1],
                 dtype=np.uint64)])
    return keys, queries


@pytest.mark.parametrize('n_shard', [1, 3, 4, 8])
def test_sharded_seed_ranges_match_jax(n_shard):
    import jax.numpy as jnp
    keys, queries = _keys_and_queries(n_shard)
    hi, lo, nv, base = jax_seed_ops.shard_keys(keys, n_shard)
    qhi, qlo = jax_seed_ops.split_words(queries)
    jmesh = jax_make_mesh(devices=__import__('jax').devices()[:n_shard])
    want = jax_seed_ops.seed_ranges_sharded(
        jmesh, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qhi),
        jnp.asarray(qlo), jnp.asarray(nv), base)
    runs, n_valid, offsets = seed_ops.shard_keys(keys, n_shard)
    np.testing.assert_array_equal(n_valid, nv)
    np.testing.assert_array_equal(offsets, base)
    mesh = make_mesh(n_shard=n_shard, device='cpu')
    got = seed_ops.seed_ranges_sharded(
        mesh, [torch.from_numpy(r) for r in runs],
        torch.from_numpy(seed_ops.ordered_int64(queries)), n_valid, offsets)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # and the whole array's ranges, where there is a match
    left = np.searchsorted(keys, queries, side='left')
    right = np.searchsorted(keys, queries, side='right')
    hit = right > left
    np.testing.assert_array_equal(got[0][hit], left[hit])
    np.testing.assert_array_equal(got[1], right - left)
    assert (got[0][~hit] == np.iinfo(np.int64).max).all()
    # a real key of 2^64 - 1 is int64 max once ordered, as the padding is
    assert got[1][-1] == 2 and got[1][-2] == 0


def test_seed_index_sharded_backend_matches_jax(monkeypatch):
    rng = random.Random(17)
    genome = simdata.make_genome(rng, 6000)
    refrseqs = {'chr1': genome, 'chr2': genome[1000:3000] + 'N' * 10}
    seeds = {dna.revcommin(genome[p:p + 51]) for p in range(0, 5900, 37)}
    seeds |= {'A' * 51, dna.revcommin(simdata.make_genome(rng, 51))}
    index = SeedIndex(refrseqs, 51, backend='sharded', device='cpu')
    assert index.backend == 'sharded'
    got = index.lookup(seeds)
    assert got == JaxSeedIndex(refrseqs, 51, backend='sharded').lookup(seeds)
    assert got == SeedIndex(refrseqs, 51).lookup(seeds)
    assert len(got) > 100
    monkeypatch.setenv('KEVLAR_SEED_BACKEND', 'sharded')
    assert SeedIndex(refrseqs, 51, device='cpu').backend == 'sharded'


def _align_pairs(seed, n=13):
    rng = random.Random(seed)
    pairs = []
    for i in range(n):   # deliberately not a multiple of the device count
        tlen = rng.choice((80, 150, 300))
        target = ''.join(rng.choice('ACGT') for _ in range(tlen))
        lo = rng.randrange(0, tlen // 2)
        q = list(target[lo:lo + tlen // 2 + 10])
        q[len(q) // 2] = 'A' if q[len(q) // 2] != 'A' else 'C'
        query = ''.join(q)
        if i % 3 == 0:
            query = dna.revcom(query)
        pairs.append((target, query))
    return pairs


@pytest.mark.parametrize('n_data', [2, 8, 20])
def test_mesh_sharded_align_matches_host(n_data):
    """tests/test_align_batch.py's sharded pin: the batch cut over a mesh
    of ``n_data`` devices (more devices than pairs too) gives the host
    aligner's (score, cigar, strand), in input order."""
    from kevlar_tpu.ops.align import align_both_strands as jax_align
    from kevlar_tpu_torch.ops.align import align_both_strands_batch
    pairs = _align_pairs(99)
    host = [jax_align(t, q) for t, q in pairs]
    mesh = make_mesh(n_data=n_data, n_shard=1, device='cpu')
    assert align_both_strands_batch(pairs, mesh=mesh) == host
    assert align_both_strands_batch(pairs, device='cpu') == host


def _scoring_trio():
    """tests/test_simlike.py's scoring trio, counted by ``kevlar_tpu``: a
    3 kb genome, a het SNV in the proband at 1,500."""
    from kevlar_tpu.batch import batches_from_records
    rng = random.Random(555)
    genome = simdata.make_genome(rng, 3000)
    child, ref, alt = simdata.apply_snv(genome, 1500, rng=rng)
    reads = {'case': (simdata.tiled_reads(child, 100, 10, 'childA') +
                      simdata.tiled_reads(genome, 100, 10, 'childB')),
             'mom': simdata.tiled_reads(genome, 100, 5, 'mom'),
             'dad': simdata.tiled_reads(genome, 100, 5, 'dad')}
    sketches = {}
    for name, rs in reads.items():
        sketches[name] = JaxSketch(KSIZE, 1000003, 4, counter_bits=8)
        for batch in batches_from_records(iter(rs)):
            sketches[name].consume_batch(batch.bases)
    sketches['refr'] = JaxSketch(KSIZE, 1000003, 4, counter_bits=4)
    sketches['refr'].consume(genome)
    return genome, child, ref, alt, sketches


def _three_calls(variant, genome, child, ref, alt, p=1500):
    """tests/test_simlike.py's three calls: a de novo SNV, a boring site
    and an indel-shaped window."""
    k = KSIZE
    return [variant('chr1', p, ref, alt, ALTWINDOW=child[p - k + 1:p + k],
                    REFRWINDOW=genome[p - k + 1:p + k], PART='1'),
            variant('chr1', 100, genome[100], 'N',
                    ALTWINDOW=genome[100 - k + 1:100 + k],
                    REFRWINDOW=genome[100 - k + 1:100 + k], PART='2'),
            variant('chr1', 200, genome[200], genome[200] + 'ACGTA',
                    ALTWINDOW=child[p - k + 1:p + k - 5],
                    REFRWINDOW=genome[200 - k + 1:200 + k], PART='3')]


def _vcf_rows(vcf_mod, calls):
    import io
    buf = io.StringIO()
    writer = vcf_mod.VCFWriter(buf, source='test')
    for label in ('Case', 'Control1', 'Control2'):
        writer.register_sample(label)
    writer.write_header()
    for call in calls:
        writer.write(call)
    return [line for line in buf.getvalue().splitlines()
            if not line.startswith('#')]


def test_simlike_takes_the_batched_gather_for_sharded_sketches(monkeypatch):
    """tests/test_simlike.py's pin: mesh-sharded sketches take the batched
    gather by themselves and score as unsharded host gathering does, in
    ``kevlar_tpu`` and here."""
    from kevlar_tpu import simlike as jax_simlike
    from kevlar_tpu import vcf as jax_vcf
    from kevlar_tpu_torch import simlike, vcf
    monkeypatch.delenv('KEVLAR_SIMLIKE_BATCH', raising=False)
    monkeypatch.delenv('KEVLAR_SIMLIKE_DEVICE', raising=False)
    genome, child, ref, alt, sk = _scoring_trio()
    want = _vcf_rows(jax_vcf, jax_simlike.simlike(
        iter(_three_calls(jax_vcf.Variant, genome, child, ref, alt)),
        sk['case'], [sk['mom'], sk['dad']], sk['refr'], mu=10.0, sigma=3.0,
        casemin=6))
    mesh = make_mesh(1, 4, device='cpu')
    sharded = {name: ShardedSketch.from_sketch(mesh, Sketch(
        KSIZE, s.tablesize, 4, counter_bits=s.counter_bits,
        tables=np.array(s._host()), device='cpu'))
        for name, s in sk.items()}
    batched = []
    gather = simlike.gather_bundles_batched

    def spy(*args, **kwargs):
        batched.append(len(args[0]))
        return gather(*args, **kwargs)
    monkeypatch.setattr(simlike, 'gather_bundles_batched', spy)
    got = _vcf_rows(vcf, simlike.simlike(
        iter(_three_calls(vcf.Variant, genome, child, ref, alt)),
        sharded['case'], [sharded['mom'], sharded['dad']], sharded['refr'],
        mu=10.0, sigma=3.0, casemin=6, device='cpu'))
    assert batched == [3]
    assert got == want and len(got) == 3
    single = Sketch(KSIZE, 11, device='cpu')
    assert not simlike._use_batched_gather(single, [single], single)
    assert simlike._use_batched_gather(single, [sharded['mom']], single)
