"""The port's sharded sketch over two processes: the counterpart of
tests/test_distributed.py.

Two rank processes (this file run as ``python -m
tests.test_torch_distributed RANK WORLD STORE OUTDIR``) join one gloo
process group through ``kevlar_tpu_torch.parallel.init_distributed``; each
owns its cells of every mesh, the collectives cross the process boundary,
and every rank writes what it computed.  The ranks import torch, numpy and
the port only (each checks that ``jax`` and ``kevlar_tpu`` were never
imported); the tests compare both ranks' results, here, with the
one-process mesh's and with ``kevlar_tpu``'s on the same seeded inputs.

Tolerance: none — counts, tables, hits, seed ranges and alignments must be
identical.
"""

import datetime
import json
import os
import random
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

KSIZE = 21
WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- seeded inputs (numpy and random only: the ranks import no JAX) -------

def _worker_bases():
    """tests/distributed_worker.py's 16 reads of 60 bp."""
    from kevlar_tpu_torch import dna
    seqs = [''.join(np.random.default_rng(100 + i).choice(
        list('ACGT'), size=60)) for i in range(16)]
    return dna.encode_batch(seqs)[0]


def _bases(seed, rows=24, cols=70):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(rows, cols)).astype(np.uint8)
    bases[3, 50:] = 4      # an ambiguous tail: the validity mask
    bases[7, 10] = 4
    return bases


def _overflow_batches():
    """Three batches for a (1, 4) mesh whose cells take two rows each; in
    the second, the rows of cells (0, 2) and (0, 3) — rank 1's — are
    poly-A, so only their bins pass ``OVERFLOW_CAPACITY``."""
    rng = np.random.default_rng(5)
    second = rng.integers(0, 4, size=(8, 60)).astype(np.uint8)
    second[4:] = 0
    return [rng.integers(0, 4, size=(8, 60)).astype(np.uint8), second,
            rng.integers(0, 4, size=(7, 60)).astype(np.uint8)]


OVERFLOW_CAPACITY = 48


def _trio_reads():
    """A 1 kb genome, a child with a SNV at 500, reads of 100 bp every 10:
    (child codes, parent codes, lengths)."""
    from kevlar_tpu_torch import dna
    rng = random.Random(321)
    genome = ''.join(rng.choice('ACGT') for _ in range(1000))
    alt = 'A' if genome[500] != 'A' else 'C'
    child = genome[:500] + alt + genome[501:]

    def tiled(seq):
        return [seq[i:i + 100] for i in range(0, len(seq) - 99, 10)]
    cb, _ = dna.encode_batch(tiled(child))
    pb, _ = dna.encode_batch(tiled(genome))
    cb[5, 40] = 4
    lengths = np.full(len(cb), 100, np.int32)
    lengths[9] = 15
    return cb, pb, lengths


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


def _seed_genome():
    rng = random.Random(17)
    genome = ''.join(rng.choice('ACGT') for _ in range(6000))
    refrseqs = {'chr1': genome, 'chr2': genome[1000:3000] + 'N' * 10}
    from kevlar_tpu_torch import dna
    seeds = {dna.revcommin(genome[p:p + 51]) for p in range(0, 5900, 37)}
    seeds.add('A' * 51)
    return refrseqs, sorted(seeds)


def _align_pairs(seed=99, n=13):
    from kevlar_tpu_torch import dna
    rng = random.Random(seed)
    pairs = []
    for i in range(n):
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


# -- what a rank computes, and the one-process mesh's counterpart ---------

def _mesh(n_data, n_shard):
    """An (n_data, n_shard) mesh of CPU cells: after init_distributed each
    rank owns an even share, in rank order."""
    from kevlar_tpu_torch.parallel import make_mesh
    return make_mesh(n_data, n_shard, device='cpu')


def _local_tables(sketch):
    return {'{}_{}'.format(d, s): sketch.tables[d][s].numpy()
            for d, s in sketch.mesh.local_cells()}


def _exchange_input(d, s, n_shard, T=2, C=5):
    """Sender ``(d, s)``'s ``[T, S, C]`` bins and ``[T, S]`` populations:
    ragged, bin ``(t, j)`` filled to ``(s + j + t) % 4`` slots (none for
    some peers); the slots past a population hold -1."""
    pops = torch.tensor([[(s + j + t) % 4 for j in range(n_shard)]
                         for t in range(T)], dtype=torch.int32)
    send = torch.full((T, n_shard, C), -1, dtype=torch.int32)
    for t in range(T):
        for j in range(n_shard):
            n = int(pops[t, j])
            send[t, j, :n] = 1000 * (n_shard * d + s) + 100 * t + 10 * j + \
                torch.arange(n, dtype=torch.int32)
    return send, pops


def case_collectives(meshes):
    """psum, pmin and pmax over each axis, the stacked all_to_all and the
    parts with populations, on both layouts."""
    from kevlar_tpu_torch.parallel import collectives
    out = {}
    for name, mesh in meshes.items():
        n_data, n_shard = mesh.shape['data'], mesh.shape['shard']
        values = [[torch.tensor([10 * d + s]) if mesh.is_local(d, s) else
                   None for s in range(n_shard)] for d in range(n_data)]
        inputs = [[_exchange_input(d, s, n_shard) if mesh.is_local(d, s)
                   else None for s in range(n_shard)] for d in range(n_data)]
        send = [[x and x[0] for x in row] for row in inputs]
        pops = [[x and x[1] for x in row] for row in inputs]
        stacked = collectives.all_to_all(mesh, send)
        parts, got = collectives.all_to_all_parts(mesh, send, pops)
        for d, s in mesh.local_cells():
            key = '{}_{}_{}_'.format(name, d, s)
            for op in ('psum', 'pmin', 'pmax'):
                for axis in ('shard', 'data'):
                    out[key + op + axis] = getattr(collectives, op)(
                        mesh, values, axis)[d][s].numpy()
            out[key + 'stacked'] = stacked[d][s].numpy()
            out[key + 'pops'] = torch.stack(got[d][s]).numpy()
            out[key + 'filled'] = np.array([
                int(v) for j, part in enumerate(parts[d][s])
                for t in range(part.shape[0])
                for v in part[t, :min(int(got[d][s][j][t]),
                                      part.shape[1])]])
    return out


def case_jax_layout(mesh):
    """tests/distributed_worker.py: a (2, 4) mesh, data rows across
    ranks, its 16 reads, the query of every window."""
    from kevlar_tpu_torch.parallel import ShardedSketch
    bases = _worker_bases()
    sk = ShardedSketch(mesh, KSIZE, 50021)
    sk.consume_batch(bases)
    counts, valid = sk.query_batch(bases)
    return dict(counts=counts.numpy(), valid=valid.numpy(),
                tablesize=np.int64(sk.tablesize),
                routed=np.int64(sk.batches['routed']),
                occupied=np.int64(sk.n_occupied()))


def case_shards_across(mesh):
    """A (1, 4) mesh, two shards a rank: the routed exchange, a masked
    (replicate) consume whose mask count is a minimum across ranks, the
    query and the screen."""
    from kevlar_tpu_torch.parallel import ShardedSketch
    from kevlar_tpu_torch.sketch import Sketch
    bases = _bases(11)
    out = {}
    for bits in (8, 4):
        sk = ShardedSketch(mesh, KSIZE, 4096, counter_bits=bits)
        sk.consume_batch(bases)
        out.update({'b{}_{}'.format(bits, k): v
                    for k, v in _local_tables(sk).items()})
        out['b{}_routed'.format(bits)] = np.int64(sk.batches['routed'])
        out['b{}_occupied'.format(bits)] = np.int64(sk.n_occupied())
        out['b{}_counts'.format(bits)] = sk.query_batch(bases)[0].numpy()
    mask = Sketch(KSIZE, 1999, 4, counter_bits=1, device='cpu')
    mask.consume_batch(bases[::3])
    masked = ShardedSketch(mesh, KSIZE, 4096, counter_bits=4, exact=True)
    masked.consume_batch(bases, mask=ShardedSketch.from_sketch(mesh, mask))
    out.update({'masked_' + k: v for k, v in _local_tables(masked).items()})
    out['masked_replicated'] = np.int64(masked.batches['replicated'])
    out['kmer_counts'] = np.array(masked.get_kmer_counts(
        ''.join('ACGT'[b] for b in bases[0][:60])))
    out.update(_screen(mesh))
    return out


def _screen(mesh):
    """Counts of a child and a parent on ``mesh``, then the novel
    screen over the child's reads."""
    from kevlar_tpu_torch.parallel import ShardedSketch, sharded_novel_screen
    cb, pb, lengths = _trio_reads()
    case = ShardedSketch(mesh, KSIZE, 100003)
    ctrl = ShardedSketch(mesh, KSIZE, 100003)
    case.consume_batch(cb)
    ctrl.consume_batch(pb)
    hits, abunds, discard = sharded_novel_screen(
        mesh, [case], [ctrl], cb, lengths, casemin=6, ctrlmax=0)
    return dict(hits=hits.numpy(), abunds=abunds.numpy(),
                discard=discard.numpy())


def case_overflow(mesh):
    """A consuming() block of three batches at a tiny routing capacity;
    the second overflows it on rank 1's cells only."""
    from kevlar_tpu_torch.parallel import ShardedSketch
    sk = ShardedSketch(mesh, KSIZE, 4096)
    with sk.consuming():
        for batch in _overflow_batches():
            sk.consume_batch(batch, a2a_capacity=OVERFLOW_CAPACITY)
    out = _local_tables(sk)
    out['batches'] = np.array([sk.batches[k] for k in
                               ('routed', 'replicated', 'overflowed')])
    return out


def case_masked_screen(mesh):
    """A (2, 2) mesh, data rows across ranks: the masked (replicate)
    consume, whose sums over 'data' cross ranks, and the screen."""
    from kevlar_tpu_torch.parallel import ShardedSketch
    from kevlar_tpu_torch.sketch import Sketch
    bases = _bases(21)
    mask = Sketch(KSIZE, 1999, 4, counter_bits=8, device='cpu')
    mask.consume_batch(bases[::3])
    out = {}
    for consume_masked in (False, True):
        sk = ShardedSketch(mesh, KSIZE, 4096, counter_bits=4, exact=True)
        sk.consume_batch(bases, mask=ShardedSketch.from_sketch(mesh, mask),
                         mask_threshold=int(consume_masked),
                         consume_masked=consume_masked)
        out.update({'{}_{}'.format(int(consume_masked), k): v
                    for k, v in _local_tables(sk).items()})
    out.update(_screen(mesh))
    return out


def case_seeds_align(meshes):
    """The sharded seed search with shards on both ranks ((1, 4)) and with
    row 0 on rank 0 only ((2, 2)); the sharded SeedIndex on
    ``make_mesh(device='cpu')``; the mesh-cut aligner."""
    from kevlar_tpu_torch.ops import seed_ops
    from kevlar_tpu_torch.ops.align import align_both_strands_batch
    from kevlar_tpu_torch.reference import SeedIndex
    keys, queries = _keys_and_queries(4)
    out = {}
    for name, mesh in meshes.items():
        runs, n_valid, base = seed_ops.shard_keys(keys, mesh.shape['shard'])
        shards = [torch.from_numpy(runs[s]) if mesh.is_local(0, s) else None
                  for s in range(mesh.shape['shard'])]
        start, count = seed_ops.seed_ranges_sharded(
            mesh, shards, torch.from_numpy(seed_ops.ordered_int64(queries)),
            n_valid, base)
        out[name + '_start'] = start
        out[name + '_count'] = count
        out[name + '_align'] = np.frombuffer(json.dumps(
            align_both_strands_batch(_align_pairs(), mesh=mesh)).encode(),
            np.uint8)
    refrseqs, seeds = _seed_genome()
    index = SeedIndex(refrseqs, 51, backend='sharded', device='cpu')
    found = index.lookup(set(seeds))
    out['index_ranks'] = np.array(index.sharded_keys()[0].ranks)
    out['lookup'] = np.frombuffer(json.dumps(
        sorted((k, sorted(v)) for k, v in found.items())).encode(), np.uint8)
    return out


def case_host_raises(mesh):
    """``_host``, ``save`` and ``_host_counts`` across ranks raise, naming
    the cells held elsewhere."""
    from kevlar_tpu_torch.parallel import ShardedSketch
    sk = ShardedSketch(mesh, KSIZE, 4096)
    messages = []
    for call in (sk._host, lambda: sk.save(os.devnull),
                 lambda: sk._host_counts(np.uint32([1]), np.uint32([2]))):
        try:
            call()
            messages.append('no error')
        except ValueError as exc:
            messages.append(str(exc))
    return dict(messages=np.frombuffer(json.dumps(messages).encode(),
                                       np.uint8))


def rank_main(rank, world, store, outdir):
    """One rank: join the group, run every case, write ``CASE.RANK.npz``;
    a failed case writes its traceback to ``CASE.RANK.err`` and ends the
    rank (its peer then fails at the next collective)."""
    torch.set_num_threads(2)
    from kevlar_tpu_torch.parallel import init_distributed
    devices = init_distributed('file://' + store, world, rank,
                               backend='gloo',
                               timeout=datetime.timedelta(seconds=60))
    meshes = {'m14': _mesh(1, 4), 'm24': _mesh(2, 4), 'm22': _mesh(2, 2)}
    cases = [('init', lambda: dict(devices=np.frombuffer(json.dumps(
                  [[r, str(d)] for r, d in devices]).encode(), np.uint8),
                  ranks14=np.array(meshes['m14'].ranks),
                  ranks24=np.array(meshes['m24'].ranks))),
             ('collectives', lambda: case_collectives(
                 {'m14': meshes['m14'], 'm22': meshes['m22']})),
             ('jax_layout', lambda: case_jax_layout(meshes['m24'])),
             ('shards_across', lambda: case_shards_across(meshes['m14'])),
             ('overflow', lambda: case_overflow(meshes['m14'])),
             ('masked_screen', lambda: case_masked_screen(meshes['m22'])),
             ('seeds_align', lambda: case_seeds_align(
                 {'m14': meshes['m14'], 'm22': meshes['m22']})),
             ('host_raises', lambda: case_host_raises(meshes['m14']))]
    for name, case in cases:
        path = os.path.join(outdir, '{}.{}'.format(name, rank))
        try:
            np.savez(path + '.npz', **case())
        except Exception:
            with open(path + '.err', 'w') as fh:
                fh.write(traceback.format_exc())
            raise
    bad = [m for m in sys.modules if m in ('jax', 'kevlar_tpu') or
           m.startswith(('jax.', 'kevlar_tpu.'))]
    if bad:
        raise SystemExit('a rank imported {}'.format(bad))
    torch.distributed.destroy_process_group()


# -- the tests ------------------------------------------------------------

@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Run both ranks once; returns ``load(case)``: the list of the ranks'
    results of ``case``."""
    outdir = tmp_path_factory.mktemp('ranks')
    store = str(outdir / 'store')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    paths = [outdir / 'rank{}.log'.format(rank) for rank in range(WORLD)]
    procs = []
    for rank, path in enumerate(paths):
        with open(str(path), 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'tests.test_torch_distributed',
                 str(rank), str(WORLD), store, str(outdir)], env=env,
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=150)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    codes = [proc.returncode for proc in procs]
    logs = [path.read_text() for path in paths]

    def load(case):
        out = []
        for rank in range(WORLD):
            err = outdir / '{}.{}.err'.format(case, rank)
            assert not err.exists(), err.read_text()
            path = outdir / '{}.{}.npz'.format(case, rank)
            assert path.exists(), 'rank {} exit {}:\n{}'.format(
                rank, codes[rank], logs[rank])
            with np.load(str(path)) as data:
                out.append(dict(data))
        return out
    load.codes = codes
    load.logs = logs
    return load


def _text(array):
    return json.loads(bytes(array).decode())


def _one_process(fn, *shape):
    """``fn`` on the one-process mesh of ``shape`` (no process group)."""
    assert not torch.distributed.is_initialized()
    return fn(_mesh(*shape))


def test_ranks_ran_clean(ranks):
    ranks('init')
    assert ranks.codes == [0] * WORLD, ranks.logs


def test_init_distributed_lists_every_rank_and_meshes_own_cells(ranks):
    for got in ranks('init'):
        assert _text(got['devices']) == [[0, 'cpu'], [1, 'cpu']]
        np.testing.assert_array_equal(got['ranks14'], [[0, 0, 1, 1]])
        np.testing.assert_array_equal(got['ranks24'],
                                      [[0, 0, 0, 0], [1, 1, 1, 1]])


def test_collectives_across_ranks(ranks):
    """Every cell gets its group's sum, minimum and maximum, the stacked
    all_to_all's slices, and each sender's filled prefix with its
    populations (some zero for a peer), whichever rank it lies on."""
    got = ranks('collectives')
    for name, (n_data, n_shard) in (('m14', (1, 4)), ('m22', (2, 2))):
        cells = [(d, s) for d in range(n_data) for s in range(n_shard)]
        for d, s in cells:
            mine = [r for r in got if '{}_{}_{}_psumshard'.format(
                name, d, s) in r]
            assert len(mine) == 1
            mine = mine[0]
            key = '{}_{}_{}_'.format(name, d, s)
            row = [10 * d + j for j in range(n_shard)]
            col = [10 * i + s for i in range(n_data)]
            for op, fn in (('psum', sum), ('pmin', min), ('pmax', max)):
                assert int(mine[key + op + 'shard'][0]) == fn(row)
                assert int(mine[key + op + 'data'][0]) == fn(col)
            sends = [_exchange_input(d, j, n_shard) for j in range(n_shard)]
            np.testing.assert_array_equal(
                mine[key + 'stacked'],
                np.stack([x[0][:, s].numpy() for x in sends], axis=1))
            np.testing.assert_array_equal(
                mine[key + 'pops'], np.stack([x[1][:, s].numpy()
                                              for x in sends]))
            want = [int(v) for send, pop in sends
                    for t in range(send.shape[0])
                    for v in send[t, s, :int(pop[t, s])]]
            assert mine[key + 'filled'].tolist() == want
            assert -1 not in want


def test_jax_layout_counts_equal_single_device_sketch(ranks):
    """tests/test_distributed.py's comparison: the query over the (2, 4)
    mesh of two processes, on every rank, equals kevlar_tpu's single-device
    Sketch of the same table size, bit for bit."""
    from kevlar_tpu import dna as jax_dna
    from kevlar_tpu.sketch import Sketch as JaxSketch
    bases = _worker_bases()
    got = ranks('jax_layout')
    tablesize = int(got[0]['tablesize'])
    single = JaxSketch(KSIZE, tablesize, 4, counter_bits=8)
    single.consume_batch(bases)
    h1, h2, v = jax_dna.kmer_hashes(bases, KSIZE)
    expected = single._host_counts(h1, h2, v)
    one = _one_process(case_jax_layout, 2, 4)
    for rank in got:
        np.testing.assert_array_equal(rank['counts'], expected)
        np.testing.assert_array_equal(rank['valid'] != 0, v)
        assert int(rank['routed']) == 1
        assert int(rank['occupied']) == int(one['occupied']) == \
            single.n_occupied()
        for key in ('counts', 'valid', 'tablesize'):
            np.testing.assert_array_equal(rank[key], one[key])


def test_shards_across_ranks_equal_one_process_and_jax(ranks):
    """A (1, 4) mesh, two shards a rank: each rank's shards equal the
    one-process mesh's and kevlar_tpu's sharded tables (8-bit rows); the
    masked consume, the query and the screen agree on every rank."""
    from kevlar_tpu.parallel import (ShardedSketch as JaxShardedSketch,
                                     make_mesh as jax_make_mesh)
    got = ranks('shards_across')
    one = _one_process(case_shards_across, 1, 4)
    import jax
    want = JaxShardedSketch(jax_make_mesh(1, 4, devices=jax.devices()[:4]),
                            KSIZE, 4096)
    want.consume_batch(_bases(11))
    jtables = np.asarray(want.tables)
    width = jtables.shape[1] // 4
    for rank, mine in enumerate(got):
        cells = sorted(k[len('b8_0_'):] for k in mine
                       if k.startswith('b8_0_'))
        assert cells == (['0', '1'] if rank == 0 else ['2', '3'])
        for key, value in mine.items():
            np.testing.assert_array_equal(value, one[key], err_msg=key)
        for s in map(int, cells):
            np.testing.assert_array_equal(
                mine['b8_0_{}'.format(s)],
                jtables[:, s * width:(s + 1) * width])
        assert int(mine['b8_routed']) == int(mine['b4_routed']) == 1
        assert int(mine['masked_replicated']) == 1
        assert int(mine['b8_occupied']) == want.n_occupied()
        np.testing.assert_array_equal(mine['b8_counts'], np.asarray(
            want.query_batch(_bases(11))[0]))
    assert len(got[0]['hits'])


def test_overflow_on_one_rank_reruns_both_ranks(ranks):
    """One batch overflows the routing capacity on rank 1's cells only;
    the largest bin is a maximum over every rank, so both ranks re-run it
    down the replicate path, count the same batches, and hold the tables
    the one-process mesh holds."""
    from kevlar_tpu_torch.ops import hashing, sketch_ops
    for i, batch in enumerate(_overflow_batches()):
        tops = []
        for cell in range(4):    # two rows a cell (the last: padding)
            h1, h2, valid = hashing.kmer_hashes_codes(
                torch.from_numpy(batch[2 * cell:2 * cell + 2]), KSIZE)
            _, pop = sketch_ops.route(h1.reshape(-1), h2.reshape(-1),
                                      valid.reshape(-1), 4, 4, 1024, 4096,
                                      OVERFLOW_CAPACITY)
            tops.append(int(pop.max()))
        if i == 1:
            assert max(tops[:2]) <= OVERFLOW_CAPACITY < min(tops[2:]), tops
        else:
            assert max(tops) <= OVERFLOW_CAPACITY, tops
    got = ranks('overflow')
    one = _one_process(case_overflow, 1, 4)
    for mine in got:
        np.testing.assert_array_equal(mine['batches'], [2, 1, 1])
        for key, value in mine.items():
            np.testing.assert_array_equal(value, one[key], err_msg=key)


def test_masked_consume_and_screen_across_data_rows(ranks):
    """A (2, 2) mesh with one data row a rank: the masked consume in both
    senses and the novel screen equal the one-process mesh's on every
    rank; the screen equals kevlar_tpu's."""
    from kevlar_tpu.parallel import (ShardedSketch as JaxShardedSketch,
                                     make_mesh as jax_make_mesh,
                                     sharded_novel_screen as jax_screen)
    got = ranks('masked_screen')
    one = _one_process(case_masked_screen, 2, 2)
    for rank, mine in enumerate(got):
        assert sorted(k for k in mine if k.startswith('0_')) == \
            ['0_{}_0'.format(rank), '0_{}_1'.format(rank)]
        for key, value in mine.items():
            np.testing.assert_array_equal(value, one[key], err_msg=key)
    cb, pb, lengths = _trio_reads()
    import jax
    jmesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    case = JaxShardedSketch(jmesh, KSIZE, 100003)
    ctrl = JaxShardedSketch(jmesh, KSIZE, 100003)
    case.consume_batch(cb)
    ctrl.consume_batch(pb)
    interesting, abunds, discard, _ = (np.asarray(x) for x in jax_screen(
        jmesh, [case], [ctrl], cb, lengths, casemin=6, ctrlmax=0))
    hits = np.flatnonzero(interesting)
    assert len(hits)
    for mine in got:
        np.testing.assert_array_equal(mine['hits'], hits)
        np.testing.assert_array_equal(
            mine['abunds'], abunds.reshape(abunds.shape[0], -1)[:, hits])
        np.testing.assert_array_equal(mine['discard'], discard)


def test_seed_ranges_and_alignments_across_ranks(ranks):
    """The sharded seed search and the mesh-cut aligner give every rank
    the one-process results; the whole array's ranges where a key
    matches; the sharded SeedIndex on both ranks' CPUs finds what the
    host search finds."""
    from kevlar_tpu_torch.ops import seed_ops
    from kevlar_tpu_torch.ops.align import align_both_strands_batch
    from kevlar_tpu_torch.reference import SeedIndex
    keys, queries = _keys_and_queries(4)
    left = np.searchsorted(keys, queries, side='left')
    right = np.searchsorted(keys, queries, side='right')
    hit = right > left
    pairs = _align_pairs()
    aligned = [list(x) for x in align_both_strands_batch(pairs,
                                                         device='cpu')]
    refrseqs, seeds = _seed_genome()
    found = SeedIndex(refrseqs, 51).lookup(set(seeds))
    lookup = [[k, [list(x) for x in sorted(v)]] for k, v in
              sorted(found.items())]
    assert len(lookup) > 100
    for mine in ranks('seeds_align'):
        for name, shape in (('m14', (1, 4)), ('m22', (2, 2))):
            mesh = _mesh(*shape)
            runs, n_valid, base = seed_ops.shard_keys(keys, shape[1])
            one = seed_ops.seed_ranges_sharded(
                mesh, [torch.from_numpy(r) for r in runs],
                torch.from_numpy(seed_ops.ordered_int64(queries)), n_valid,
                base)
            np.testing.assert_array_equal(mine[name + '_start'], one[0])
            np.testing.assert_array_equal(mine[name + '_count'], one[1])
            np.testing.assert_array_equal(mine[name + '_count'],
                                          right - left)
            np.testing.assert_array_equal(mine[name + '_start'][hit],
                                          left[hit])
            assert _text(mine[name + '_align']) == aligned
            assert align_both_strands_batch(pairs, mesh=mesh) == \
                [tuple(x) for x in aligned]
        np.testing.assert_array_equal(mine['index_ranks'], [[0, 1]])
        assert _text(mine['lookup']) == lookup


def test_host_and_save_across_ranks_raise(ranks):
    got = ranks('host_raises')
    for rank, mine in enumerate(got):
        messages = _text(mine['messages'])
        other = 1 - rank
        held = '(0, 2), (0, 3)' if other == 1 else '(0, 0), (0, 1)'
        for message in messages:
            assert 'rank {}: {}'.format(other, held) in message, message


def test_one_process_mesh_makes_no_distributed_call(monkeypatch, tmp_path):
    """Without a process group every cell is rank 0's and nothing calls
    torch.distributed: the consumes, the query, the screen, the seed
    search, the aligner, ``_host`` and ``save`` run as before."""
    from kevlar_tpu_torch.ops import seed_ops
    from kevlar_tpu_torch.ops.align import align_both_strands_batch
    from kevlar_tpu_torch.parallel import ShardedSketch
    from kevlar_tpu_torch.sketch import load
    dist = torch.distributed
    for name in ('all_reduce', 'all_to_all_single', 'broadcast',
                 'new_group', 'all_gather_object', 'get_rank',
                 'get_world_size', 'get_backend'):
        monkeypatch.setattr(dist, name, lambda *a, **k: pytest.fail(
            'a one-process mesh called torch.distributed'))
    mesh = _mesh(2, 2)
    assert not mesh.distributed and mesh.ranks == [[0, 0], [0, 0]]
    assert mesh.local_cells() == mesh.cells() and not mesh.elsewhere()
    out = case_masked_screen(mesh)
    assert len(out['hits'])
    sk = ShardedSketch(mesh, KSIZE, 4096)
    sk.consume_batch(_bases(11))
    counts, _ = sk.query_batch(_bases(11))
    assert sk._host().shape == (4, 4096) and sk.n_occupied() > 0
    sk.save(str(tmp_path / 'one.ct'))
    np.testing.assert_array_equal(load(str(tmp_path / 'one.ct'),
                                       device='cpu')._host(), sk._host())
    keys, queries = _keys_and_queries(2)
    runs, n_valid, base = seed_ops.shard_keys(keys, 2)
    seed_ops.seed_ranges_sharded(
        mesh, [torch.from_numpy(r) for r in runs],
        torch.from_numpy(seed_ops.ordered_int64(queries)), n_valid, base)
    assert len(align_both_strands_batch(_align_pairs(), mesh=mesh)) == 13
    assert not dist.is_initialized()


def test_mesh_cells_naming_ranks_need_a_process_group():
    from kevlar_tpu_torch.parallel import Mesh, make_mesh
    with pytest.raises(ValueError, match='call init_distributed first'):
        Mesh([[(0, 'cpu'), (1, 'cpu')]])
    with pytest.raises(ValueError, match='as \\(rank, device\\) or none'):
        Mesh([[(0, 'cpu'), 'cpu']])
    with pytest.raises(ValueError, match='call init_distributed first'):
        make_mesh(1, 2, devices=[(0, 'cpu'), (0, 'cpu')])
    # equality compares the owning ranks too
    assert make_mesh(1, 2, devices=['cpu'] * 2) == \
        make_mesh(1, 2, device='cpu')
    assert make_mesh(1, 2, device='cpu') != make_mesh(2, 1, device='cpu')


def test_init_distributed_arguments(monkeypatch, tmp_path):
    """JAX's arguments: an address ``host:port`` is rank 0's TCP address,
    a URL passes as it is, none means the environment; the backend
    defaults to NCCL, and a failed start raises."""
    from kevlar_tpu_torch.parallel import mesh as mesh_mod
    seen = []
    monkeypatch.setattr(torch.distributed, 'init_process_group',
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(mesh_mod, '_gathered', lambda local: [
        (0, dev) for dev in local])
    assert mesh_mod.init_distributed('host:1234', 2, 1) == \
        [(0, torch.device('cpu'))]
    mesh_mod.init_distributed('file:///tmp/x', backend='gloo', timeout=5)
    mesh_mod.init_distributed()
    assert seen == [
        ('nccl', dict(init_method='tcp://host:1234', world_size=2, rank=1)),
        ('gloo', dict(init_method='file:///tmp/x', world_size=-1, rank=-1,
                      timeout=5)),
        ('nccl', dict(init_method='env://', world_size=-1, rank=-1))]
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, ValueError)):
            mesh_mod.init_distributed('file://' + str(tmp_path / 'store'),
                                      1, 0)
        assert not torch.distributed.is_initialized()


if __name__ == '__main__':
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
