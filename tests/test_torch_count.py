"""The port's Count-Min consume and sketch files against ``kevlar_tpu``.

Tolerance: none — both packages must build the same counter tables from
the same reads (``--device cpu``: the plain PyTorch versions of the K1-K3
kernels on the port's side), and each must load the other's files with
equal arrays and metadata.
"""

import random

import numpy as np
import pytest
import torch

import kevlar_tpu_torch
from kevlar_tpu import count as jax_count
from kevlar_tpu import sketch as jax_sketch
from kevlar_tpu_torch import count, dna, reference, sketch
from kevlar_tpu_torch.ops import sketch_ops

from . import simdata

KSIZE = 21
TABLESIZE = 20_011


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """Reads of a 3 kb genome (with N bases and short reads), a FASTQ of
    poly-A reads that repeat one k-mer 390 times, and the genome as one
    40 kb FASTA record."""
    workdir = tmp_path_factory.mktemp('count')
    rng = random.Random(31)
    genome = simdata.make_genome(rng, 3000)
    reads = simdata.sample_reads(rng, genome, readlen=100, coverage=8)
    for r in reads[::17]:
        pos = rng.randrange(len(r.sequence))
        r.sequence = r.sequence[:pos] + 'N' + r.sequence[pos + 1:]
    reads += simdata.sample_reads(rng, genome, readlen=18, coverage=1,
                                  prefix='short')
    paths = {'reads': str(workdir / 'reads.fq'),
             'polya': str(workdir / 'polya.fq'),
             'genome': str(workdir / 'genome.fa'),
             'refr': str(workdir / 'refr.fa')}
    simdata.write_fastq(reads, paths['reads'])
    polya = [kevlar_tpu_torch.Record('a{}'.format(i), 'A' * 150, 'I' * 150)
             for i in range(3)] + reads[:20]
    simdata.write_fastq(polya, paths['polya'])
    big = simdata.make_genome(rng, 40_000)
    big = big[:5000] + 'NNN' + big[5003:]
    simdata.write_fasta({'chr1': big}, paths['genome'])
    simdata.write_fasta({'chr1': genome[:1500]}, paths['refr'])
    return paths


def _both(bits, path, mask=None, **kw):
    """(kevlar_tpu tables, port tables) after one consume of ``path``; the
    port reads it in batches of 50 reads."""
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits)
    jax_count.consume_seqfile(jsk, [path], mask=mask and mask[0], **kw)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                        device='cpu')
    count.consume_seqfile(psk, [path], mask=mask and mask[1],
                          batch_size=50, **kw)
    return np.asarray(jsk._host()), psk._host()


@pytest.fixture(scope='module')
def masks(inputs):
    """The first half of the genome as a 1-bit mask, in both packages."""
    jmask, pmask = (jax_sketch.Sketch(KSIZE, 9_999, 4, counter_bits=1),
                    sketch.Sketch(KSIZE, 9_999, 4, counter_bits=1,
                                  device='cpu'))
    jax_count.consume_seqfile(jmask, [inputs['refr']])
    count.consume_seqfile(pmask, [inputs['refr']])
    assert np.array_equal(np.asarray(jmask._host()), pmask._host())
    return jmask, pmask


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_consume_matches_jax(inputs, bits):
    want, got = _both(bits, inputs['reads'])
    assert np.array_equal(got, want)
    assert got.max() > 1 or bits == 1


@pytest.mark.parametrize('consume_masked', [False, True])
def test_masked_consume_matches_jax(inputs, masks, consume_masked):
    want, got = _both(8, inputs['reads'], mask=masks,
                      consume_masked=consume_masked)
    assert np.array_equal(got, want)
    unmasked, _ = _both(8, inputs['reads'])
    assert 0 < got.sum() < unmasked.sum()


def test_banded_consume_matches_jax(inputs):
    want, got = _both(8, inputs['reads'], numbands=4, band=2)
    assert np.array_equal(got, want)
    full, _ = _both(8, inputs['reads'])
    assert 0 < 3 * got.sum() < full.sum()


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_repeated_kmer_saturates_like_jax(inputs, bits):
    want, got = _both(bits, inputs['polya'])
    assert np.array_equal(got, want)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                        device='cpu', tables=got)
    assert psk.get('A' * KSIZE) == {1: 1, 4: 15, 8: 255}[bits]


def test_genome_record_chunks_with_overlap(inputs):
    """A 40 kb record is read in 1,024-base rows overlapping by k-1: every
    k-mer counts exactly once, as a direct count of the whole record."""
    want, got = _both(8, inputs['genome'])
    assert np.array_equal(got, want)
    with open(inputs['genome']) as fh:
        seq = ''.join(line.strip() for line in fh if line[0] != '>')
    h1, h2, valid = dna.kmer_hashes(dna.encode(seq), KSIZE)
    direct = np.stack([np.bincount(
        ((h1 + np.uint32(t) * h2) % np.uint32(TABLESIZE))[valid],
        minlength=TABLESIZE) for t in range(4)]).clip(max=255)
    assert np.array_equal(got, direct)


def test_accumulator_saturates_before_int32_wraps(monkeypatch):
    monkeypatch.setattr(sketch_ops, '_I32_HEADROOM', 5)
    acc = sketch_ops.Accumulator(torch.zeros((1, 3), dtype=torch.uint8), 8,
                                 3)
    # four windows that all land in bucket 0: h1 = 0, 3, 6, 9 and even h2
    h1 = torch.tensor([0, 3, 6, 9], dtype=torch.int32)
    h2 = torch.tensor([0, 6, 12, 300], dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.uint8)
    acc.acc[0, 0] = 1000           # stands in for a counter near the limit
    acc.add(h1, h2, valid)
    acc.add(h1, h2, valid)         # 8 windows > 5: saturate first
    assert acc.acc.tolist() == [[259, 0, 0]]
    acc.add_indices(torch.zeros((1, 4), dtype=torch.int32))   # and again
    assert acc.acc.tolist() == [[259, 0, 0]]
    assert acc.tables().tolist() == [[255, 0, 0]]


@pytest.mark.parametrize('last_read', [-1, 0, 6, 11])
def test_consume_codes_skips_padding_rows(last_read):
    """On the CPU a batch is hashed only up to its last read: the padding
    rows after it (all codes 4) hold no valid window, so the tables and
    the count of kept k-mers are those of every row hashed (a padding row
    between reads stays; a batch of padding alone hashes one row)."""
    from kevlar_tpu_torch.ops import hashing
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (12, 40), dtype=np.uint8)
    codes[0, 5] = 4
    codes[last_read + 1:] = 4
    if last_read > 1:
        codes[1] = 4
    codes = torch.from_numpy(codes)
    tables = torch.zeros((4, TABLESIZE), dtype=torch.uint8)
    got = sketch_ops.Accumulator(tables, 8, TABLESIZE)
    got_kept = sketch_ops.consume_batch(got, codes, KSIZE, numbands=2,
                                        band=0)
    want = sketch_ops.Accumulator(tables, 8, TABLESIZE)
    want_kept = torch.zeros(1, dtype=torch.int64)
    h1, h2, valid = hashing.kmer_hashes_plain(codes, KSIZE)
    want.add(h1.reshape(-1), h2.reshape(-1), valid.reshape(-1), numbands=2,
             band=0, nkept=want_kept)
    assert int(got_kept) == int(want_kept[0])
    assert (int(got_kept) > 0) == (last_read >= 0)
    assert torch.equal(got.tables(), want.tables())


CONSUME_MODES = {
    'all': {},
    'band': dict(numbands=4, band=1),
    'mask<=': dict(mask_threshold=0, consume_masked=False),
    'mask>=': dict(mask_threshold=1, consume_masked=True),
}


@pytest.mark.parametrize('mode', sorted(CONSUME_MODES))
@pytest.mark.parametrize('bits', [1, 4, 8])
def test_consume_hashes_plain_matches_jax(bits, mode):
    """K3's plain version (hashes, validity and mask counts in, accumulator
    updated) against ``kevlar_tpu``'s consume of the same base codes: with
    a band, with a mask in both senses, with N bases, and with a k-mer
    repeated 560 times so that every counter width saturates."""
    import jax.numpy as jnp
    from kevlar_tpu_torch.ops import hashing
    rng = np.random.default_rng(bits)
    L = 300
    bases = rng.integers(0, 4, (12, L), dtype=np.uint8)
    bases[rng.random(bases.shape) < 0.01] = 4
    bases[3:5] = 0                               # poly-A: 2 x 280 windows
    bases[7, 100:] = 4                           # a short read
    kw = dict(CONSUME_MODES[mode])
    masked = mode.startswith('mask')
    jmask = pmask = None
    if masked:
        jmask = jax_sketch.Sketch(KSIZE, 4_999, 4, counter_bits=1)
        jmask.consume_batch(jnp.asarray(bases[:6]))
        pmask = torch.from_numpy(np.array(jmask.tables))
        assert pmask.shape == (4, sketch_ops.packed_width(4_999, 1))
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits)
    jsk.consume_batch(jnp.asarray(bases), mask=jmask, **kw)
    want = np.asarray(jsk._host())

    h1, h2, valid = (x.reshape(-1) for x in hashing.kmer_hashes_codes(
        torch.from_numpy(bases), KSIZE))
    mcnt = sketch_ops.gather_counts(pmask, h1, h2, 1, 4_999) \
        if masked else None
    acc = torch.zeros((4, TABLESIZE), dtype=torch.int32)
    out = sketch_ops.consume_hashes(acc, h1, h2, valid, mcnt=mcnt, **kw)
    assert out is acc
    got = acc.clamp(max=sketch_ops.MAXCOUNT[bits]).numpy()
    assert np.array_equal(got, want)
    if mode in ('all', 'mask>='):            # the poly-A k-mer is kept
        assert got.max() == sketch_ops.MAXCOUNT[bits]
    assert 0 < got.sum()
    # the accumulator itself is not saturated: the repeated k-mer counts on
    if mode == 'all':
        assert int(acc.max()) >= 560


def test_consume_hashes_checks_inputs():
    acc = torch.zeros((4, 11), dtype=torch.int32)
    h = torch.zeros(5, dtype=torch.int32)
    v = torch.ones(5, dtype=torch.uint8)
    sketch_ops.consume_hashes(acc, h, h, v, mcnt=v, mask_threshold=1)
    assert acc[:, 0].tolist() == [5] * 4 and int(acc.sum()) == 20
    for bad in (lambda: sketch_ops.consume_hashes(acc.long(), h, h, v),
                lambda: sketch_ops.consume_hashes(acc, h.long(), h, v),
                lambda: sketch_ops.consume_hashes(acc, h, h[:3], v),
                lambda: sketch_ops.consume_hashes(acc, h, h, v.bool()),
                lambda: sketch_ops.consume_hashes(acc, h, h, v, mcnt=v[:2]),
                lambda: sketch_ops.consume_hashes(acc, h[::2], h[::2],
                                                  v[::2]),
                lambda: sketch_ops.consume_hashes(
                    acc.to('meta'), h.to('meta'), h.to('meta'),
                    v.to('meta'))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize('bits,ext', [(1, '.nt'), (4, '.sct'), (8, '.ct')])
def test_sketch_files_load_in_both_packages(inputs, tmp_path, bits, ext):
    want, tables = _both(bits, inputs['reads'])
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                        tables=tables, device='cpu')
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                            tables=want)
    port_file = str(tmp_path / ('port' + ext))
    jax_file = str(tmp_path / ('jax' + ext))
    psk.save(port_file)
    jsk.save(jax_file)
    from_port = jax_sketch.load(port_file, cache=False)
    from_jax = sketch.load(jax_file, device='cpu')
    for loaded in (from_port, from_jax):
        assert (loaded.ksize(), loaded.tablesize, loaded.ntables,
                loaded.counter_bits) == (KSIZE, TABLESIZE, 4, bits)
        assert np.array_equal(np.asarray(loaded._host()), want)
        assert loaded.n_occupied() == jsk.n_occupied()
    assert np.array_equal(
        sketch_ops.unpack_rows(from_jax.tables, bits, TABLESIZE).numpy(),
        want)
    port_npz, jax_npz = np.load(port_file), np.load(jax_file)
    assert sorted(port_npz.files) == sorted(jax_npz.files)
    for member in jax_npz.files:
        assert np.array_equal(port_npz[member], jax_npz[member])
        assert port_npz[member].dtype == jax_npz[member].dtype


def test_npz_loader_uses_public_numpy_api(tmp_path, monkeypatch):
    """Later numpy 2 releases dropped the private
    ``np.lib.format._read_array_header``, which the port's mmap loader once
    called: the loader must work with the public names alone."""
    import types
    path = str(tmp_path / 'x.ct')
    sketch.Sketch(KSIZE, 101, 4, device='cpu').save(path)
    public = types.SimpleNamespace(**{
        name: getattr(np.lib.format, name) for name in dir(np.lib.format)
        if not name.startswith('_')})
    monkeypatch.setattr(reference, 'np', types.SimpleNamespace(
        lib=types.SimpleNamespace(format=public), memmap=np.memmap,
        fromfile=np.fromfile))
    data = reference._load_npz_mmap(path)
    assert data is not None and isinstance(data['tables'], np.memmap)
    assert int(data['tablesize']) == 101


@pytest.mark.parametrize('bits,memory', [(1, 1e5), (4, 1e5), (8, 1e5),
                                         (8, 4e5 + 8)])
def test_allocate_forces_odd_tablesize_like_jax(bits, memory):
    mine = sketch.allocate_from_memory(KSIZE, memory, counter_bits=bits,
                                       device='cpu')
    ref = jax_sketch.allocate_from_memory(KSIZE, memory, counter_bits=bits)
    assert mine.tablesize == ref.tablesize
    assert mine.tablesize % 2 == 1
    assert mine.tables.shape == (4, sketch_ops.packed_width(mine.tablesize,
                                                            bits))


def test_fpr_bailout_raises(inputs, tmp_path):
    with pytest.raises(sketch.KevlarUnsuitableFPRError):
        count.load_sample_seqfile([inputs['reads']], KSIZE, 400, maxfpr=0.01,
                                  device='cpu')
    path = str(tmp_path / 'full.ct')
    count.load_sample_seqfile([inputs['reads']], KSIZE, 4000, maxfpr=1.0,
                              outfile=path, device='cpu')
    assert sketch.load_sketchfiles([path], maxfpr=1.0, device='cpu')
    with pytest.raises(sketch.KevlarUnsuitableFPRError):
        sketch.load_sketchfiles([path], maxfpr=1e-9, device='cpu')
    with pytest.raises(sketch.KevlarSketchTypeError):
        sketch.load(str(tmp_path / 'full.txt'), device='cpu')


@pytest.mark.parametrize('batch_size', [5, 16])
def test_native_base_batches_match_jax(tmp_path, batch_size):
    """The count's reader path (one reused parse buffer, no names, batches
    written into the caller's arrays) yields the batches of
    ``kevlar_tpu.batch.native_base_batches``: reads that shorten and
    lengthen from batch to batch, N bases, a record chunked with overlap,
    a ragged last batch."""
    from kevlar_tpu import batch as jax_batch
    from kevlar_tpu_torch import batch
    rng = random.Random(batch_size)
    lens = [rng.choice([40, 150, 151, 200, 90]) for _ in range(37)] + [2500]
    path = str(tmp_path / 'reads.fa')
    with open(path, 'w') as fh:
        for i, n in enumerate(lens):
            fh.write('>r{}\n{}\n'.format(i, ''.join(
                rng.choice('ACGTN') for _ in range(n))))
    handed = []

    def alloc(shape):
        handed.append(np.zeros(shape, np.uint8))
        return handed[-1]

    mine = list(batch.native_base_batches(path, batch_size, overlap=30,
                                          alloc=alloc))
    plain = list(batch.native_base_batches(path, batch_size, overlap=30))
    want = list(jax_batch.native_base_batches(path, batch_size, overlap=30))
    assert len(mine) == len(plain) == len(want) >= 3
    for k, ((b1, l1), (b2, l2), (b3, l3)) in enumerate(zip(mine, plain,
                                                           want)):
        assert b1 is handed[k]
        assert np.array_equal(b1, b3) and np.array_equal(b2, b3)
        assert np.array_equal(l1, l3) and np.array_equal(l2, l3)
