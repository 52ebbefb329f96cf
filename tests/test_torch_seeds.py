"""The port's device seed search (B7) against ``kevlar_tpu``'s.

Tolerance: none — ranges, match dicts and cutout text must be identical.
The port runs its ``'device'`` backend with ``device='cpu'`` (the same
``torch.searchsorted`` calls a card runs); ``kevlar_tpu``'s runs on JAX's
CPU backend.  The keys include values at and above 2^63, where a plain
uint64 -> int64 cast would reorder them.
"""

import random

import numpy as np
import pytest
import torch

import kevlar_tpu
from kevlar_tpu import cli as jax_cli
from kevlar_tpu.ops import seed_ops as jax_seed_ops
from kevlar_tpu.reference import SeedIndex as JaxSeedIndex
from kevlar_tpu_torch import cli, reference
from kevlar_tpu_torch.ops import seed_ops
from kevlar_tpu_torch.reference import SeedIndex

from . import simdata
from .test_torch_alac import mini_trio, _jax_native_loaded  # noqa: F401
from .test_torch_cli import _pallas_backend, _read, stages  # noqa: F401

TOP = np.uint64(0xFFFFFFFFFFFFFFFF)


def _keys_and_queries(seed, nkeys, nqueries, ends):
    """Sorted uint64 keys with duplicates and keys on both sides of 2^63
    (with ``ends``, also 0 and 2^64-1), and queries that hit keys, fall
    between them, and lie below and above them all."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**64 - 2, nkeys, dtype=np.uint64,
                        endpoint=True)
    extra = [2**63, 2**63, 2**63 - 1, 2**63 + 1] + ([0, 0, TOP, TOP]
                                                   if ends else [])
    keys = np.concatenate([keys, keys[:nkeys // 4],
                           np.array(extra, dtype=np.uint64)])
    keys.sort()
    picks = rng.choice(keys, nqueries // 2)
    others = rng.integers(0, 2**64 - 1, nqueries - len(picks),
                          dtype=np.uint64, endpoint=True)
    edges = np.array([0, 1, TOP, TOP - 1, 2**63, 2**63 - 1], dtype=np.uint64)
    return keys, np.concatenate([picks, others, edges])


def _jax_ranges(keys, queries):
    khi, klo = jax_seed_ops.split_words(keys)
    qhi, qlo = jax_seed_ops.split_words(queries)
    start, count = jax_seed_ops.seed_ranges(khi, klo, qhi, qlo)
    return np.asarray(start), np.asarray(count)


def _port_ranges(keys, queries):
    start, count = seed_ops.seed_ranges(
        torch.from_numpy(seed_ops.ordered_int64(keys)),
        torch.from_numpy(seed_ops.ordered_int64(queries)))
    return start.numpy(), count.numpy()


@pytest.mark.parametrize('seed,nkeys,nqueries,ends', [
    (1, 1, 3, False), (2, 40, 25, True), (3, 1000, 400, False),
    (4, 20000, 3000, True)])
def test_seed_ranges_match_jax(seed, nkeys, nqueries, ends):
    keys, queries = _keys_and_queries(seed, nkeys, nqueries, ends)
    got_start, got_count = _port_ranges(keys, queries)
    want_start, want_count = _jax_ranges(keys, queries)
    assert np.array_equal(got_start, want_start)
    assert np.array_equal(got_count, want_count)
    # and numpy's own uint64 search
    assert np.array_equal(got_start, np.searchsorted(keys, queries, 'left'))
    assert np.array_equal(got_start + got_count,
                          np.searchsorted(keys, queries, 'right'))
    assert got_count.max() >= 2  # the duplicates were found


def test_seed_ranges_of_no_queries():
    keys, _ = _keys_and_queries(5, 100, 10, True)
    empty = np.zeros(0, dtype=np.uint64)
    start, count = _port_ranges(keys, empty)
    assert start.shape == count.shape == (0,)
    want_start, want_count = _jax_ranges(keys, empty)
    assert want_start.shape == (0,)


def test_ordered_int64_keeps_uint64_order():
    keys, _ = _keys_and_queries(6, 5000, 10, False)
    assert (keys >= 2**63).any() and (keys < 2**63).any()
    flipped = seed_ops.ordered_int64(keys)
    assert flipped.dtype == np.int64
    assert np.all(flipped[1:] >= flipped[:-1])
    # the hazard the flip avoids: a plain cast puts keys >= 2^63 first
    cast = keys.astype(np.int64)
    assert not np.all(cast[1:] >= cast[:-1])


@pytest.fixture(scope='module')
def genome_case():
    """tests/test_localize.py's genome and seeds: two chromosomes, a
    duplicated segment, reverse-complement, absent and multicopy seeds."""
    genome = simdata.make_genome(random.Random(1717), 8000)
    dup = genome[:3000] + genome[500:560] + genome[3000:]
    refrseqs = {'chr1': dup, 'chr2': kevlar_tpu.dna.revcom(genome[:4000])}
    seeds = set()
    rng = random.Random(99)
    for _ in range(40):
        pos = rng.randrange(0, len(dup) - 51)
        seeds.add(kevlar_tpu.revcommin(dup[pos:pos + 51]))
    for _ in range(10):
        pos = rng.randrange(0, 4000 - 51)
        seeds.add(kevlar_tpu.revcommin(
            kevlar_tpu.dna.revcom(genome[:4000])[pos:pos + 51]))
    seeds.add(kevlar_tpu.revcommin('TGCA' * 13)[:51])  # absent
    seeds.add(kevlar_tpu.revcommin(dup[505:556]))      # multicopy
    seeds.add('ACGTN' * 10 + 'A')                      # not a valid seed
    return refrseqs, seeds


@pytest.mark.parametrize('jax_backend', ['host', 'device'])
def test_device_backend_matches_jax(genome_case, jax_backend):
    refrseqs, seeds = genome_case
    want = JaxSeedIndex(refrseqs, 51, backend=jax_backend).lookup(seeds)
    index = SeedIndex(refrseqs, 51, backend='device', device='cpu')
    got = index.lookup(seeds)
    assert got == want
    assert any(len(v) == 2 for v in want.values())
    assert index.device_keys().dtype == torch.int64
    assert SeedIndex(refrseqs, 51, backend='host').lookup(seeds) == want


def test_device_backend_from_saved_index(genome_case, tmp_path):
    refrseqs, seeds = genome_case
    path = str(tmp_path / 'index.npz')
    SeedIndex(refrseqs, 51).save(path)
    index = SeedIndex.from_file(path, refrseqs, backend='device',
                                device='cpu')
    assert isinstance(index._keys, np.memmap)
    assert index.lookup(seeds) == JaxSeedIndex(refrseqs, 51).lookup(seeds)
    jax_index = JaxSeedIndex.from_file(path, refrseqs)
    assert index.lookup(seeds) == jax_index.lookup(seeds)


def test_seed_backend_env_override(genome_case, monkeypatch):
    refrseqs, seeds = genome_case
    monkeypatch.setenv('KEVLAR_SEED_BACKEND', 'device')
    index = SeedIndex(refrseqs, seedsize=51, device='cpu')
    assert index.backend == 'device'
    assert index.lookup(seeds) == JaxSeedIndex(refrseqs, 51).lookup(seeds)
    assert SeedIndex(refrseqs, 51, backend='host').backend == 'host'
    monkeypatch.setenv('KEVLAR_SEED_BACKEND', 'bogus')
    with pytest.raises(ValueError, match='unknown seed backend'):
        SeedIndex(refrseqs, seedsize=51)
    monkeypatch.delenv('KEVLAR_SEED_BACKEND')
    assert SeedIndex(refrseqs, 51).backend == 'host'


@pytest.mark.parametrize('how', ['argument', 'environment', 'from_file'])
def test_sharded_backend_is_refused_by_name(genome_case, monkeypatch,
                                            tmp_path, how):
    """The ``'sharded'`` backend, chosen by argument, by
    ``KEVLAR_SEED_BACKEND`` or on a loaded index, matches what
    ``kevlar_tpu``'s sharded backend matches (the keys cut over the CPU
    mesh here, over JAX's 8 virtual devices there)."""
    refrseqs, seeds = genome_case
    if how == 'argument':
        index = SeedIndex(refrseqs, 51, backend='sharded', device='cpu')
    elif how == 'environment':
        monkeypatch.setenv('KEVLAR_SEED_BACKEND', 'sharded')
        index = SeedIndex(refrseqs, 51, device='cpu')
    else:
        path = str(tmp_path / 'index.npz')
        SeedIndex(refrseqs, 51).save(path)
        index = SeedIndex.from_file(path, refrseqs, backend='sharded',
                                    device='cpu')
    assert index.backend == 'sharded'
    got = index.lookup(seeds)
    assert got == JaxSeedIndex(refrseqs, 51, backend='sharded').lookup(seeds)
    assert got == JaxSeedIndex(refrseqs, 51).lookup(seeds)
    mesh, shards, n_valid, base = index.sharded_keys()
    assert sum(n_valid) == len(index._keys) and base[0] == 0


@pytest.mark.parametrize('flags', [['-z', '25'], ['-z', '25', '-p', '2']],
                         ids=['seed25', 'part-id'])
def test_localize_with_device_seed_search_matches_jax(stages, tmp_path,
                                                      monkeypatch, flags):
    refr, _, contigs, _ = stages
    monkeypatch.setenv('KEVLAR_SEED_BACKEND', 'device')
    want, got = str(tmp_path / 'jax.fa'), str(tmp_path / 'port.fa')
    jax_cli.main(['localize'] + flags + ['-o', want, refr, contigs])
    cli.main(['localize', '--device', 'cpu'] + flags +
             ['-o', got, refr, contigs])
    assert _read(got) == _read(want)
    assert '>chr1_' in _read(want)
    cached = [index for key, index in reference._index_cache.items()
              if key[2:] == ('device', 'cpu')]
    assert len(cached) == 1 and cached[0].backend == 'device'
    assert cached[0]._device_index is not None


def test_autoindex_cache_follows_the_backend(stages, monkeypatch):
    refr = stages[0]
    monkeypatch.delenv('KEVLAR_SEED_BACKEND', raising=False)
    host = reference.autoindex(refr, 25, device='cpu')
    assert host.backend == 'host'
    assert reference.autoindex(refr, 25, device='cpu') is host
    monkeypatch.setenv('KEVLAR_SEED_BACKEND', 'device')
    dev = reference.autoindex(refr, 25, device='cpu')
    assert dev is not host and dev.backend == 'device'
    assert dev.device == 'cpu'
