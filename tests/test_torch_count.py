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
    idx = torch.zeros((1, 4), dtype=torch.int32)
    acc.acc[0, 0] = 1000           # stands in for a counter near the limit
    acc.add(idx)
    acc.add(idx)                   # 8 windows > 5: saturate first
    assert acc.acc.tolist() == [[259, 0, 0]]
    assert acc.tables().tolist() == [[255, 0, 0]]


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
