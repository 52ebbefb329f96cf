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
    """The wire format of ``kevlar_tpu`` unpacked by the port, then the
    codes entry, against JAX's unpack and hashing."""
    from kevlar_tpu import dna as jax_dna
    from kevlar_tpu.ops import hashing as jax_hashing
    rng = np.random.default_rng(ksize)
    L = 157                              # not a multiple of 4 or 8
    bases = _bases(rng, 9, L)
    packed, badmask = _wire(bases)
    h1, h2, valid = hashing.kmer_hashes_codes(
        hashing.unpack_bases(packed, badmask, L), ksize)
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


CODE_CASES = [(k, L) for k in (21, 31, 32, 33, 51)
              for L in (31, 37, 150, 1024) if L >= k]


@pytest.mark.parametrize('ksize,L', CODE_CASES)
def test_kmer_hashes_codes_matches_jax(ksize, L):
    """The codes entry on the reader's base codes (N bases as code 4, a
    short read, an all-padding row) against JAX, at every window."""
    from kevlar_tpu.ops import hashing as jax_hashing
    rng = np.random.default_rng(1000 * ksize + L)
    bases = _bases(rng, 7, L, nfrac=0.02)
    bases[3] = 4                         # a padding row
    bases[4, 0] = 4                      # N inside the first window
    bases[5, -1] = 4                     # N in the last window only
    h1, h2, valid = hashing.kmer_hashes_codes(torch.from_numpy(bases), ksize)
    assert h1.dtype == h2.dtype == torch.int32 and valid.dtype == torch.uint8
    assert h1.shape == h2.shape == valid.shape == (7, L - ksize + 1)
    j1, j2, jv = jax_hashing.kmer_hashes(bases, ksize)
    assert np.array_equal(h1.numpy().view(np.uint32), np.asarray(j1))
    assert np.array_equal(h2.numpy().view(np.uint32), np.asarray(j2))
    assert np.array_equal(valid.numpy().astype(bool), np.asarray(jv))
    assert not valid[3].any() and not valid[4, 0] and not valid[5, -1]


def _rolled(row, ksize):
    """K1's algorithm in Python integers: the first window of ``row``
    built base by base, every later one rolled from its predecessor with
    :func:`kmer_cuda.roll_constants`; (c_hi, c_lo, valid) per window."""
    M = 1 << 32
    out_hi, out_lo, m1k, m2k, m1km1, m2km1, m1inv, m2inv = \
        kmer_cuda.roll_constants(ksize)
    m1, m2 = dna.POLY_M1, dna.POLY_M2
    hi_len = max(0, ksize - 16)
    poly = ksize > 32
    w = [int(x) for x in row]
    c = [3 - min(x, 3) for x in w]
    f_lo = f_hi = r_lo = r_hi = r = 0
    last_bad = -1
    for i in range(ksize):
        if w[i] >= 4:
            last_bad = i
        if poly:
            f_lo = (f_lo * m1 + w[i]) % M
            f_hi = (f_hi * m2 + w[i]) % M
            r_lo = (r_lo + c[i] * pow(m1, i, M)) % M
            r_hi = (r_hi + c[i] * pow(m2, i, M)) % M
        else:
            if i < hi_len:
                f_hi = (f_hi * 4 + w[i]) % M
            else:
                f_lo = (f_lo * 4 + w[i]) % M
            r |= c[i] << (2 * i)
    out = []
    for j in range(len(w) - ksize + 1):
        if j:
            w_out, w_in = w[j - 1], w[j + ksize - 1]
            if w_in >= 4:
                last_bad = j + ksize - 1
            if poly:
                f_lo = (f_lo * m1 + w_in - w_out * m1k) % M
                f_hi = (f_hi * m2 + w_in - w_out * m2k) % M
                r_lo = ((r_lo - c[j - 1]) * m1inv +
                        c[j + ksize - 1] * m1km1) % M
                r_hi = ((r_hi - c[j - 1]) * m2inv +
                        c[j + ksize - 1] * m2km1) % M
            else:
                w_mid = w[j - 1 + hi_len]
                f_hi = (f_hi * 4 + w_mid - w_out * out_hi) % M
                f_lo = (f_lo * 4 + w_in - w_mid * out_lo) % M
                r = (r >> 2) | (c[j + ksize - 1] << (2 * (ksize - 1)))
        rl, rh = (r_lo, r_hi) if poly else (r % M, r >> 32)
        use_f = (f_hi, f_lo) <= (rh, rl)
        out.append((f_hi, f_lo, last_bad < j) if use_f else
                   (rh, rl, last_bad < j))
    return out


@pytest.mark.parametrize('ksize', [1, 5, 15, 16, 17, 21, 31, 32, 33, 51, 64])
def test_rolling_update_matches_kmer_codes(ksize):
    """The rolling update the kernel runs (Horner sums mod 2^32 with the
    wrapper's constants) gives the codes of the window-by-window definition
    at every window: bad bases (code 4, spilling into the next digit) and
    padding included."""
    rng = np.random.default_rng(ksize)
    bases = _bases(rng, 3, ksize + 40, nfrac=0.05)
    c_hi, c_lo, valid = hashing.kmer_codes(torch.from_numpy(bases), ksize)
    for n in range(3):
        want = list(zip(c_hi[n].tolist(), c_lo[n].tolist(),
                        valid[n].tolist()))
        assert _rolled(bases[n], ksize) == want


@pytest.mark.parametrize('tablesize', [
    1, 2, 3, 7, 1 << 16, 999_983, 124_999_999, 1 << 30, (1 << 30) + 1,
    (1 << 31) - 2, (1 << 31) - 1])
def test_mod_magic_reduces_like_modulo(tablesize):
    """K2's division-free ``x mod tablesize`` (multiply-high by the
    wrapper's reciprocal, multiply, subtract, one conditional subtract) in
    Python integers against ``%``, at the edges and at random."""
    magic = kmer_cuda.mod_magic(tablesize)
    assert 0 < magic < 1 << 32
    rng = np.random.default_rng(tablesize % 1000)
    xs = [0, 1, tablesize - 1, tablesize, tablesize + 1, 2 * tablesize - 1,
          2 * tablesize, (1 << 31) - 1, 1 << 31, (1 << 32) - 2,
          (1 << 32) - 1]
    xs += [(1 << 32) - 1 - (1 << 32) % tablesize]     # largest multiple - 1
    xs += rng.integers(0, 1 << 32, 20000, dtype=np.uint64).tolist()
    for x in xs:
        x = int(x) % (1 << 32)
        r = x - ((x * magic) >> 32) * tablesize
        assert 0 <= r < 2 * tablesize and r < 1 << 32
        assert (r - tablesize if r >= tablesize else r) == x % tablesize
    for bad in (0, 1 << 31):
        with pytest.raises(ValueError):
            kmer_cuda.mod_magic(bad)


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


def _mixed_samples(rng, nsamples, device='cpu'):
    """Sketches of mixed counter widths and odd, differing table sizes."""
    specs = [(8, 10_003), (1, 20_011), (4, 9_999)][:nsamples]
    return [(torch.from_numpy(rng.integers(
        0, 256, (4, sketch_ops.packed_width(size, bits)),
        dtype=np.uint8)).to(device), bits, size) for bits, size in specs]


@pytest.mark.parametrize('nsamples', [1, 2, 3])
def test_gather_counts_multi_matches_jax(nsamples):
    import jax.numpy as jnp
    from kevlar_tpu.ops import sketch_ops as jax_sketch_ops
    rng = np.random.default_rng(40 + nsamples)
    samples = _mixed_samples(rng, nsamples)
    h1 = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    h1[:4] = [0, 1, 2**32 - 1, 2**31]
    got = sketch_ops.gather_counts_multi(
        samples, torch.from_numpy(h1.view(np.int32)),
        torch.from_numpy(h2.view(np.int32)))
    assert got.dtype == torch.uint8 and got.shape == (nsamples, 5000)
    for s, (tables, bits, tablesize) in enumerate(samples):
        want = jax_sketch_ops.gather_counts(
            jnp.asarray(tables.numpy()), jnp.asarray(h1), jnp.asarray(h2),
            counter_bits=bits, tablesize=tablesize)
        assert np.array_equal(got[s].numpy(), np.asarray(want))


def test_gather_counts_multi_checks_inputs():
    rng = np.random.default_rng(2)
    samples = _mixed_samples(rng, 2)
    h = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_multi([], h, h)
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_multi(samples, h, h[:3])
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_multi(samples, h.long(), h.long())
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_multi(
            samples + [(samples[0][0], 8, 10_005)], h, h)
    with pytest.raises(ValueError):
        sketch_ops.gather_counts_multi(
            [(samples[0][0].to('meta'), 8, 10_003)], h, h)


def test_code_stager_on_cpu_hands_out_fresh_shared_buffers():
    stager = batch.CodeStager('cpu')
    first = stager.buffer((3, 5))
    first[:] = 2
    shipped = stager.ship()
    assert shipped.dtype == torch.uint8 and shipped.shape == (3, 5)
    assert shipped.numpy().base is not None and int(shipped.sum()) == 30
    second = stager.buffer((3, 5))
    second[:] = 1
    assert int(shipped.sum()) == 30      # the shipped batch is not reused
    assert int(stager.ship().sum()) == 15


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


@pytest.mark.parametrize('T', [1, 4])
def test_scatter_add_parts_plain_matches_stacked(T):
    """The owner's add over its received bins in place (strided views of
    the senders' send buffers, read up to each bin's population) equals
    the add over the stacked buffer whose unfilled slots hold the
    sentinel: empty bins, full and overflowing bins, garbage past the
    populations."""
    rng = np.random.default_rng(T)
    S, C, span = 3, 50, 1000
    parts, pops, stacked = [], [], []
    for j in range(S):
        send = torch.from_numpy(rng.integers(-5, span + 9, (T, S, C)).astype(
            np.int32))
        pop = torch.from_numpy(rng.integers(0, C + 20, (T, S)).astype(
            np.int32))
        pop[0, 1] = 0 if j else C
        filled = torch.arange(C) < pop.clamp(max=C)[:, :, None]
        clean = torch.where(filled, send.clamp(0, span - 1), span)
        send = torch.where(filled, clean, send)    # garbage past the fill
        parts.append(send[:, 1])
        pops.append(pop[:, 1])
        stacked.append(clean[:, 1])
    acc = torch.from_numpy(rng.integers(0, 9, (T, span)).astype(np.int32))
    got = sketch_ops.scatter_add_parts(acc.clone(), parts, pops)
    want = sketch_ops.scatter_add_plain(
        acc.clone(), torch.stack(stacked, dim=1).reshape(T, S * C))
    assert torch.equal(got, want)
    assert int((got - acc).sum()) == int(sum(p.clamp(max=C).sum()
                                             for p in pops))
    with pytest.raises(ValueError):
        sketch_ops.scatter_add_parts(acc, parts, pops[:-1])
    with pytest.raises(ValueError):
        sketch_ops.scatter_add_parts(acc, [p.long() for p in parts], pops)
    with pytest.raises(ValueError):
        sketch_ops.scatter_add_parts(acc, [p.t() for p in parts], pops)


def test_dispatch_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(_bases(rng, 3, 40))
    before = dict(kmer_cuda.launches)
    h1, h2, _ = hashing.kmer_hashes_codes(codes, 21)
    tables = torch.zeros((4, 7), dtype=torch.uint8)
    sketch_ops.gather_counts(tables, h1[0].contiguous(), h2[0].contiguous(),
                             8, 7)
    assert kmer_cuda.launches == before      # CPU tensors: plain versions
    with pytest.raises(ValueError):
        hashing.kmer_hashes_codes(codes.to('meta'), 21)
    with pytest.raises(ValueError):
        hashing.kmer_hashes_codes(codes, 41)
    with pytest.raises(ValueError):
        hashing.kmer_hashes_codes(codes.long(), 21)
    with pytest.raises(ValueError):
        hashing.kmer_hashes_codes(codes[:, ::2], 21)
    with pytest.raises(ValueError):
        sketch_ops.gather_counts(tables, h1[0].contiguous(),
                                 h2[0].contiguous(), 4, 7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('ksize', [15, 21, 31, 32, 33, 51])
@pytest.mark.parametrize('L', [61, 253, 1024])
def test_kmer_kernel_matches_plain_on_card(cuda_device, ksize, L):
    rng = np.random.default_rng(ksize + L)
    bases = _bases(rng, 513, L)
    bases[7] = 4
    # a view whose rows do not start on 16-byte boundaries
    codes = torch.from_numpy(np.concatenate(
        [np.zeros((1, L), np.uint8), bases])).to(cuda_device)[1:]
    got = kmer_cuda.kmer_hashes_cuda(codes, ksize)
    want = hashing.kmer_hashes_plain(codes, ksize)
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
    got = kmer_cuda.gather_counts_cuda([(tables, bits, tablesize)], h[0],
                                       h[1])
    want = sketch_ops.gather_counts_plain(tables, h[0], h[1], bits,
                                          tablesize)
    assert torch.equal(got[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize('nsamples', [2, 3, 5, 9])
def test_gather_kernel_multi_matches_plain_on_card(cuda_device, nsamples):
    """Mixed counter widths, more samples than one launch takes, and a
    sketch of three tables (the kernel's general instance)."""
    rng = np.random.default_rng(nsamples)
    samples = (_mixed_samples(rng, 3, cuda_device) * 3)[:nsamples]
    if nsamples == 5:
        samples[1] = (samples[1][0][:3].contiguous(),) + samples[1][1:]
    h = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 70_001),
                                      dtype=np.int64).astype(np.int32))
    h = h.to(cuda_device)
    got = kmer_cuda.gather_counts_cuda(samples, h[0], h[1])
    want = sketch_ops.gather_counts_multi_plain(samples, h[0], h[1])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['vector', 'scalar', 'unaligned'])
def test_scatter_kernel_matches_plain_on_card(cuda_device, form):
    """K3 from a [T, N] index tensor: rows on the 16-byte grid, a count that
    is no multiple of 4 and a tensor that starts 4 bytes off the grid."""
    rng = np.random.default_rng(11)
    n = 300_000 if form == 'vector' else 299_999
    flat = torch.from_numpy(rng.integers(-4, 1003, 4 * n + 1).astype(
        np.int32)).to(cuda_device)
    idx = flat[1:].view(4, n) if form == 'unaligned' else \
        flat[:4 * n].view(4, n)
    acc = torch.from_numpy(rng.integers(0, 9, (4, 1001)).astype(
        np.int32)).to(cuda_device)
    before = kmer_cuda.launches['scatter_add']
    got = sketch_ops.scatter_add(acc.clone(), idx)
    torch.cuda.synchronize()
    assert kmer_cuda.launches['scatter_add'] == before + 1
    want = sketch_ops.scatter_add_plain(acc.clone(), idx)
    assert torch.equal(got, want)


def _received_parts(rng, device, nsenders, T, capacity, offset=0):
    """Parts as an owner of a routed consume receives them: row s of
    ``nsenders`` [T, S, capacity] send buffers seen in place (rows at a
    stride of S * capacity), starting ``offset`` int32 into their storage,
    with populations [T] at a stride of S: some bins empty, some full or
    overflowing, the rest in between; slots past a population hold
    garbage that must not be read."""
    S = 3
    parts, pops = [], []
    for _ in range(nsenders):
        buf = torch.from_numpy(rng.integers(-7, 2000, T * S * capacity +
                                            offset).astype(np.int32))
        send = buf.to(device)[offset:].view(T, S, capacity)
        pop = torch.from_numpy(rng.integers(0, capacity + 50, (T, S)).astype(
            np.int32))
        pop[0, 1] = 0
        pop[-1, 1] = capacity
        parts.append(send[:, 1])
        pops.append(pop.to(device)[:, 1])
    return parts, pops


@pytest.mark.cuda
@pytest.mark.parametrize('nsenders,capacity,offset', [
    (4, 332_800, 0), (8, 40_000, 0), (3, 9_999, 0), (4, 20_000, 1),
    (70, 1_000, 0)])
def test_scatter_parts_kernel_matches_plain_on_card(cuda_device, nsenders,
                                                    capacity, offset):
    """K3 over received parts where they lie: strided views, empty, full
    and overflowing bins, parts off the 16-byte grid, more parts than one
    launch takes."""
    rng = np.random.default_rng(nsenders + capacity)
    parts, pops = _received_parts(rng, cuda_device, nsenders, 4, capacity,
                                  offset)
    acc = torch.from_numpy(rng.integers(0, 9, (4, 1999)).astype(
        np.int32)).to(cuda_device)
    before = kmer_cuda.launches['scatter_add_parts']
    got = sketch_ops.scatter_add_parts(acc.clone(), parts, pops)
    torch.cuda.synchronize()
    assert kmer_cuda.launches['scatter_add_parts'] == before + 1
    want = sketch_ops.scatter_add_parts_plain(acc.clone(), parts, pops)
    assert torch.equal(got, want)
    assert int((got - acc).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['all', 'band', 'mask<=', 'mask>=',
                                  'three tables', 'unaligned'])
def test_consume_kernel_matches_plain_on_card(cuda_device, mode):
    """K3 from hashes: duplicates, invalid windows, a band, a mask in both
    senses, an odd tablesize, a count of k-mers that is no multiple of 4,
    a sketch of three tables and inputs off the 16-byte grid."""
    rng = np.random.default_rng(len(mode))
    n = 300_003
    h = rng.integers(-2**31, 2**31, (2, n + 1), dtype=np.int64).astype(
        np.int32)
    h[:, 1000:60_000] = h[:, 1000:1001]              # one k-mer 59,000 times
    valid = (rng.random(n + 1) < 0.8).astype(np.uint8)
    mcnt = rng.integers(0, 3, n + 1).astype(np.uint8)
    h, valid, mcnt = (torch.from_numpy(x).to(cuda_device)
                      for x in (h, valid, mcnt))
    lo = 1 if mode == 'unaligned' else 0
    h1, h2 = h[0, lo:lo + n].contiguous(), h[1, lo:lo + n].contiguous()
    valid, mcnt = valid[lo:lo + n], mcnt[lo:lo + n]
    if mode == 'unaligned':
        h1, h2 = h[0, 1:], h[1, 1:]                  # views, 4 bytes off
    kw = {'band': dict(numbands=8, band=5),
          'mask<=': dict(mcnt=mcnt, mask_threshold=1),
          'mask>=': dict(mcnt=mcnt, mask_threshold=2, consume_masked=True),
          'unaligned': dict(mcnt=mcnt, mask_threshold=1)}.get(mode, {})
    T = 3 if mode == 'three tables' else 4
    acc = torch.from_numpy(rng.integers(0, 9, (T, 100_003)).astype(
        np.int32)).to(cuda_device)
    before = kmer_cuda.launches['consume']
    got = sketch_ops.consume_hashes(acc.clone(), h1, h2, valid, **kw)
    torch.cuda.synchronize()
    assert kmer_cuda.launches['consume'] == before + 1
    want = sketch_ops.consume_hashes_plain(acc.clone(), h1, h2, valid, **kw)
    assert torch.equal(got, want)
    assert int((got - acc).sum()) > 0


# -- the sharded sketch's kernels on a card: kt_route, and K2 and K3 with a
# bucket range (kevlar_tpu_torch.parallel) ----------------------------------

def _hashes_on(rng, n, device):
    h = rng.integers(-2**31, 2**31, (2, n), dtype=np.int64).astype(np.int32)
    h = torch.from_numpy(h).to(device)
    valid = torch.from_numpy((rng.random(n) < 0.9).astype(np.uint8))
    return h[0], h[1], valid.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('T,S,total,capacity', [
    (4, 4, 1_000_003, 80_000), (4, 8, 999_999, 40_000),
    (3, 2, 77_777, 200_000), (4, 4, 1_000_003, 1000),
    (2, 16, 999_999, 40_000), (4, 64, 1_000_003, 4_000),
    (1, 300, 3_000_001, 5_000)])
def test_route_kernel_matches_plain_on_card(cuda_device, T, S, total,
                                            capacity):
    """Every bin's filled prefix slot by slot, unsorted, and the
    populations: ballots (up to 8 shards) and __match_any_sync (16, 64,
    300 shards; more than 64 bins give a warp several rounds), and
    overflowing bins, which keep their first k-mers in k-mer order."""
    rng = np.random.default_rng(T * S)
    h1, h2, valid = _hashes_on(rng, 300_001, cuda_device)
    ss = -(-total // S)
    ss += (-ss) % 8
    before = kmer_cuda.launches['route']
    got, got_pop = sketch_ops.route(h1, h2, valid, T, S, ss, total, capacity)
    torch.cuda.synchronize()
    assert kmer_cuda.launches['route'] == before + 1
    want, want_pop = sketch_ops.route_plain(h1, h2, valid, T, S, ss, total,
                                            capacity)
    assert torch.equal(got_pop, want_pop)
    filled = want_pop.clamp(max=capacity).to(torch.int64)
    inside = torch.arange(capacity, device=cuda_device) < filled[:, :, None]
    assert torch.equal(got[inside], want[inside])


@pytest.mark.cuda
@pytest.mark.parametrize('bits', [1, 4, 8])
def test_range_gather_kernel_matches_plain_on_card(cuda_device, bits):
    rng = np.random.default_rng(bits)
    h1, h2, _ = _hashes_on(rng, 200_001, cuda_device)
    total, ss = 1_000_003, 250_008
    samples = []
    for s in range(4):
        width = sketch_ops.packed_width(ss, bits)
        tables = torch.from_numpy(rng.integers(0, 256, (4, width),
                                               dtype=np.uint8))
        samples.append((tables.to(cuda_device), bits, total, s * ss, ss))
    got = kmer_cuda.gather_counts_cuda(samples, h1, h2)
    want = sketch_ops.gather_counts_multi_plain(samples, h1, h2)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_range_consume_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(5)
    h1, h2, valid = _hashes_on(rng, 300_001, cuda_device)
    mcnt = torch.from_numpy(rng.integers(0, 3, 300_001).astype(
        np.uint8)).to(cuda_device)
    total, ss = 1_000_003, 250_008
    for s in range(4):
        for kw in ({}, dict(mcnt=mcnt, mask_threshold=1)):
            acc = torch.zeros((4, ss), dtype=torch.int32, device=cuda_device)
            got = kmer_cuda.consume_cuda(acc.clone(), h1, h2, valid,
                                         total=total, lo=s * ss, **kw)
            want = sketch_ops.consume_hashes_plain(acc.clone(), h1, h2, valid,
                                                   total=total, lo=s * ss,
                                                   **kw)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_sharded_count_on_one_card_matches_single(cuda_device):
    """Four shards on one card (the mesh names it four times): routed and
    replicate consumes give the single-device sketch's tables."""
    from kevlar_tpu_torch.parallel import ShardedSketch, make_mesh
    from kevlar_tpu_torch.sketch import Sketch
    KSIZE = 21
    bases = _bases(np.random.default_rng(9), 4096, 160)
    mesh = make_mesh(devices=['cuda:0'] * 4)
    single = Sketch(KSIZE, 1_000_003, 4, device=cuda_device)
    single.consume_batch(bases)
    for route in ('alltoall', 'replicate'):
        sk = ShardedSketch(mesh, KSIZE, 1_000_003, exact=True)
        sk.consume_batch(bases, route=route)
        np.testing.assert_array_equal(sk._host(), single._host())
