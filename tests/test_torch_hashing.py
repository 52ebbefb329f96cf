"""The port's k-mer hashing, count gather and B10 scatter against the JAX
package.

Tolerance: none — hashes, counts and bincounts are integers.  On the CPU
the port's dispatchers run the plain PyTorch versions of the kernels in
``csrc/kmer.cu``; the ``cuda``-marked tests hold the kernels to those plain
versions on a card (they skip without one), as ``chip_smoke.py`` does at
the helium run's shapes.

The JAX package is imported inside the tests that compare with it, so the
``cuda`` tests also run where JAX is absent (the machine with the card):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_hashing.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch import batch, dna
from kevlar_tpu_torch.ops import hashing, kmer_cuda, sketch_ops

KSIZES = [21, 31, 33, 51]


def _bases(rng, nrows, L, nfrac=0.01):
    """Random reads with N bases; the last row is short, padded with 4."""
    bases = rng.integers(0, 4, (nrows, L), dtype=np.uint8)
    bases[rng.random((nrows, L)) < nfrac] = 4
    bases[-1, L // 3:] = 4
    return bases


def _wire(bases, device='cpu'):
    packed, badmask = batch.pack_bases(bases)
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(badmask).to(device))


@pytest.mark.parametrize('ksize', KSIZES)
def test_kmer_hashes_packed_matches_jax(ksize):
    from kevlar_tpu import dna as jax_dna
    from kevlar_tpu.ops import hashing as jax_hashing
    rng = np.random.default_rng(ksize)
    L = 157                              # not a multiple of 4 or 8
    bases = _bases(rng, 9, L)
    packed, badmask = _wire(bases)
    h1, h2, valid = hashing.kmer_hashes_packed(packed, badmask, L, ksize)
    assert h1.dtype == h2.dtype == torch.int32 and valid.dtype == torch.uint8
    assert h1.shape == (9, L - ksize + 1)
    j1, j2, jv = jax_hashing.kmer_hashes(
        jax_hashing.unpack_bases(packed.numpy(), badmask.numpy(), L), ksize)
    d1, d2, dv = jax_dna.kmer_hashes(bases, ksize)
    for mine, jax_out, host in ((h1, j1, d1), (h2, j2, d2)):
        u = mine.numpy().view(np.uint32)
        assert np.array_equal(u, np.asarray(jax_out))
        assert np.array_equal(u, host)
    assert np.array_equal(valid.numpy().astype(bool), np.asarray(jv))
    assert np.array_equal(valid.numpy().astype(bool), dv)
    assert 0 < int(valid.sum()) < valid.numel()


def test_wire_format_matches_jax():
    from kevlar_tpu import batch as jax_batch
    from kevlar_tpu.ops import hashing as jax_hashing
    rng = np.random.default_rng(3)
    for L in (1, 7, 8, 157, 160):
        bases = _bases(rng, 5, L, nfrac=0.2)
        packed, badmask = batch.pack_bases(bases)
        jp, jb = jax_batch.pack_bases(bases)
        assert np.array_equal(packed, jp) and np.array_equal(badmask, jb)
        got = hashing.unpack_bases(torch.from_numpy(packed),
                                   torch.from_numpy(badmask), L)
        assert np.array_equal(got.numpy(), np.asarray(
            jax_hashing.unpack_bases(jp, jb, L)))
        assert np.array_equal(got.numpy(), np.minimum(bases, 4))
        bad = hashing.unpack_badmask(torch.from_numpy(badmask), L)
        assert np.array_equal(bad.numpy(), bases >= 4)


def test_batching_matches_jax():
    """Record batching and chunking: the same rows in the same order (the
    novel stage's output follows it for reads of mixed lengths)."""
    from kevlar_tpu import batch as jax_batch
    from kevlar_tpu.sequence import Record as JaxRecord
    rng = np.random.default_rng(8)
    lens = [int(n) for n in rng.choice([50, 150, 200, 3000], 40)]
    seqs = [dna.decode(rng.integers(0, 4, n)) for n in lens]
    mine = [kevlar_tpu_torch.Record('r{}'.format(i), s)
            for i, s in enumerate(seqs)]
    theirs = [JaxRecord('r{}'.format(i), s) for i, s in enumerate(seqs)]
    chunked = list(batch.chunk_long_records(iter(mine), overlap=30))
    want = list(jax_batch.chunk_long_records(iter(theirs), overlap=30))
    assert [(r.name, r.sequence) for r in chunked] == \
        [(r.name, r.sequence) for r in want]
    for got, ref in zip(batch.batches_from_records(iter(chunked), 7),
                        jax_batch.batches_from_records(iter(want), 7)):
        assert [r.name for r in got.records] == [r.name for r in ref.records]
        assert np.array_equal(got.bases, ref.bases)
        assert np.array_equal(got.lengths, ref.lengths)
    assert batch.bucket_length(3000) == jax_batch.bucket_length(3000)


@pytest.mark.parametrize('ksize', KSIZES)
def test_host_hashing_copy_matches_jax(ksize):
    from kevlar_tpu import dna as jax_dna
    rng = np.random.default_rng(100 + ksize)
    bases = _bases(rng, 4, 120)
    for mine, ref in zip(dna.kmer_hashes(bases, ksize),
                         jax_dna.kmer_hashes(bases, ksize)):
        assert np.array_equal(mine, ref)
    kmer = dna.decode(bases[0, :ksize].clip(0, 3))
    assert dna.hash_kmer(kmer) == jax_dna.hash_kmer(kmer)
    assert dna.hash_kmer(kmer) == dna.hash_kmer(dna.revcom(kmer))
    assert dna.decode(bases[1]) == jax_dna.decode(bases[1])


def test_table_index_wraps_like_uint32():
    rng = np.random.default_rng(5)
    h1 = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32) | 1
    a = hashing.to_u32(torch.from_numpy(h1.view(np.int32)))
    b = hashing.to_u32(torch.from_numpy(h2.view(np.int32)))
    for t in range(4):
        want = (h1 + np.uint32(t) * h2) % np.uint32(999_983)
        assert np.array_equal(
            hashing.table_index(a, b, t, 999_983).numpy(), want)
    assert np.array_equal(hashing.to_i32_bits(a).numpy().view(np.uint32), h1)


@pytest.mark.parametrize('bits,tablesize', [(1, 10_007), (4, 10_005),
                                            (8, 10_003)])
def test_gather_counts_matches_jax(bits, tablesize):
    import jax.numpy as jnp
    from kevlar_tpu.ops import sketch_ops as jax_sketch_ops
    rng = np.random.default_rng(bits)
    width = sketch_ops.packed_width(tablesize, bits)
    tables = rng.integers(0, 256, (4, width), dtype=np.uint8)
    h1 = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    got = sketch_ops.gather_counts(
        torch.from_numpy(tables), torch.from_numpy(h1.view(np.int32)),
        torch.from_numpy(h2.view(np.int32)), bits, tablesize)
    want = jax_sketch_ops.gather_counts(
        jnp.asarray(tables), jnp.asarray(h1), jnp.asarray(h2),
        counter_bits=bits, tablesize=tablesize)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 1


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_pack_rows_matches_jax_layout(bits):
    from kevlar_tpu import sketch as jax_sketch
    rng = np.random.default_rng(20 + bits)
    values = rng.integers(0, sketch_ops.MAXCOUNT[bits] + 1, (4, 1001),
                          dtype=np.uint8)
    packed = sketch_ops.pack_rows(torch.from_numpy(values), bits)
    assert np.array_equal(packed.numpy(), jax_sketch._np_pack(values, bits))
    assert np.array_equal(
        sketch_ops.unpack_rows(packed, bits, 1001).numpy(), values)


def _probe():
    """``tools/scatter_probe.py``, the B10 Pallas kernel."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, 'tools'))
    try:
        import scatter_probe
    finally:
        sys.path.pop(0)
    return scatter_probe


def test_scatter_add_matches_pallas_b10():
    """4 tables of 1,001 buckets, one 131,072-entry chunk of indices with
    heavy duplicates and negative (skipped) entries, into a nonzero
    accumulator."""
    import jax.numpy as jnp
    probe = _probe()
    rng = np.random.default_rng(10)
    T, C = 4, 1001
    idx = rng.integers(-3, 40, (T, probe.CHUNK)).astype(np.int32)
    idx[:, ::7] = rng.integers(0, C, idx[:, ::7].shape)
    acc0 = rng.integers(0, 50, (T, C)).astype(np.int32)
    log2c = max(8, (-(-C // 8) - 1).bit_length())
    capacity = 8 << log2c
    tiled = np.zeros((T, capacity), np.int32)
    tiled[:, :C] = acc0
    want = np.asarray(probe.pallas_scatter_add(
        jnp.asarray(tiled.reshape(T, 8, capacity // 8)),
        jnp.asarray(idx.reshape(T, 1, probe.CHUNK_SUB, probe.CHUNK_LANES)),
        log2c, interpret=True)).reshape(T, capacity)
    got = sketch_ops.scatter_add(torch.from_numpy(acc0.copy()),
                                 torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), want[:, :C])
    assert not want[:, C:].any()
    bincount = np.stack([np.bincount(r[r >= 0], minlength=C) for r in idx])
    assert np.array_equal(got.numpy(), acc0 + bincount)


def test_scatter_add_skips_out_of_range_and_checks_inputs():
    acc = torch.zeros((2, 5), dtype=torch.int32)
    idx = torch.tensor([[0, 4, 5, -1, 4], [9, -7, 2, 2, 2]],
                       dtype=torch.int32)
    sketch_ops.scatter_add(acc, idx)
    assert acc.tolist() == [[1, 0, 0, 0, 2], [0, 0, 3, 0, 0]]
    with pytest.raises(ValueError):
        sketch_ops.scatter_add(acc.long(), idx)
    with pytest.raises(ValueError):
        sketch_ops.scatter_add(acc, idx[:1])
    with pytest.raises(ValueError):
        sketch_ops.scatter_add(acc.to('meta'), idx.to('meta'))


def test_dispatch_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(7)
    packed, badmask = _wire(_bases(rng, 3, 40))
    before = dict(kmer_cuda.launches)
    h1, h2, _ = hashing.kmer_hashes_packed(packed, badmask, 40, 21)
    tables = torch.zeros((4, 7), dtype=torch.uint8)
    sketch_ops.gather_counts(tables, h1[0].contiguous(), h2[0].contiguous(),
                             8, 7)
    assert kmer_cuda.launches == before      # CPU tensors: plain versions
    with pytest.raises(ValueError):
        hashing.kmer_hashes_packed(packed.to('meta'), badmask.to('meta'),
                                   40, 21)
    with pytest.raises(ValueError):
        hashing.kmer_hashes_packed(packed, badmask, 41, 21)
    with pytest.raises(ValueError):
        sketch_ops.gather_counts(tables, h1[0].contiguous(),
                                 h2[0].contiguous(), 4, 7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('ksize', KSIZES)
def test_kmer_kernel_matches_plain_on_card(cuda_device, ksize):
    rng = np.random.default_rng(ksize)
    L = 253
    packed, badmask = _wire(_bases(rng, 513, L), cuda_device)
    got = kmer_cuda.kmer_hashes_cuda(packed, badmask, L, ksize)
    want = hashing.kmer_hashes_packed_plain(packed, badmask, L, ksize)
    for mine, ref in zip(got, want):
        assert torch.equal(mine, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('bits,tablesize', [(1, 100_003), (4, 100_001),
                                            (8, 100_005)])
def test_gather_kernel_matches_plain_on_card(cuda_device, bits, tablesize):
    rng = np.random.default_rng(bits)
    width = sketch_ops.packed_width(tablesize, bits)
    tables = torch.from_numpy(rng.integers(0, 256, (4, width),
                                           dtype=np.uint8)).to(cuda_device)
    h = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 70_001),
                                      dtype=np.int64).astype(np.int32))
    h = h.to(cuda_device)
    got = kmer_cuda.gather_counts_cuda(tables, h[0], h[1], bits, tablesize)
    want = sketch_ops.gather_counts_plain(tables, h[0], h[1], bits,
                                          tablesize)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(-4, 1003, (4, 300_000)).astype(
        np.int32)).to(cuda_device)
    acc = torch.from_numpy(rng.integers(0, 9, (4, 1001)).astype(
        np.int32)).to(cuda_device)
    got = kmer_cuda.scatter_add_cuda(acc.clone(), idx)
    want = sketch_ops.scatter_add_plain(acc.clone(), idx)
    assert torch.equal(got, want)
