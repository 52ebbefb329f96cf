"""The port's ``filter`` subcommand against ``kevlar_tpu``'s.

Tolerance: none — on the same novel reads both CLIs must write identical
augmented FASTQ: without a mask, with the reference mask in the npz format
(the port loads it with ``--device cpu``), with a khmer-format mask, and in
the FPR bailout, where both refuse with the same message.  The input is the
JAX package's ``novel`` output on a seeded 20 kb trio counted into small
sketches, so some annotations carry inflated case counts.
"""

import random

import pytest

import kevlar_tpu
import kevlar_tpu_torch
from kevlar_tpu import cli as jax_cli
from kevlar_tpu_torch import cli

from . import simdata

KSIZE = 21


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


def make_novel_case(workdir, seed=2026, genome_len=20000):
    """A seeded trio through ``kevlar_tpu``'s count and novel: the proband
    carries four SNVs, a 12 bp insertion and a 9 bp deletion (one variant
    near another, so two loci share reads), the parents none.  Returns
    {'refr', 'novel', 'mask', 'khmer_mask', 'case', 'mother', 'father'}
    paths; 'case' is counted into a deliberately small table."""
    rng = random.Random(seed)
    genome = simdata.make_genome(rng, genome_len)
    child = genome
    for pos in (16000, 12000, 12060, 7000):
        child, _, _ = simdata.apply_snv(child, pos, rng=rng)
    child = simdata.apply_deletion(child, 9000, 9)
    child = simdata.apply_insertion(child, 3000, 'GATTACAGATTA')
    paths = {'refr': str(workdir / 'refr.fa')}
    simdata.write_fasta({'chr1': genome}, paths['refr'])
    for who, reads in (
            ('proband', simdata.sample_reads(rng, child, coverage=12,
                                             prefix='c') +
             simdata.sample_reads(rng, genome, coverage=12, prefix='h')),
            ('mother', simdata.sample_reads(rng, genome, coverage=20,
                                            prefix='m')),
            ('father', simdata.sample_reads(rng, genome, coverage=20,
                                            prefix='f'))):
        paths[who + '.fq'] = str(workdir / (who + '.fq'))
        simdata.write_fastq(reads, paths[who + '.fq'])
    paths['mask'] = str(workdir / 'mask.nt')
    jax_cli.main(['count', '-k', str(KSIZE), '-c', '1', '-M', '100K',
                  '--max-fpr', '1.0', paths['mask'], paths['refr']])
    paths['khmer_mask'] = str(workdir / 'khmer_mask.nt')
    jax_cli.main(['count', '-k', str(KSIZE), '-c', '1', '-M', '100K',
                  '--max-fpr', '1.0', '--sketch-format', 'khmer',
                  paths['khmer_mask'], paths['refr']])
    for who, mem in (('proband', '30K'), ('mother', '200K'),
                     ('father', '200K')):
        paths[who] = str(workdir / (who + '.ct'))
        jax_cli.main(['count', '-k', str(KSIZE), '-M', mem, '--max-fpr',
                      '1.0', paths[who], paths[who + '.fq']])
    paths['novel'] = str(workdir / 'novel.augfastq')
    jax_cli.main(['novel', '-k', str(KSIZE), '--case', paths['proband.fq'],
                  '--case-counts', paths['proband'], '--control-counts',
                  paths['mother'], paths['father'], '--case-min', '5',
                  '--ctrl-max', '1', '--max-fpr', '1.0', '-o',
                  paths['novel']])
    return paths


@pytest.fixture(scope='module')
def novel_case(tmp_path_factory):
    return make_novel_case(tmp_path_factory.mktemp('filter'))


def _both(tmp_path, args, name):
    want, got = str(tmp_path / (name + '.jax')), str(tmp_path / name)
    jax_cli.main(['filter'] + args + ['-o', want])
    cli.main(['filter', '--device', 'cpu'] + args + ['-o', got])
    with open(want) as fh:
        expected = fh.read()
    with open(got) as fh:
        return fh.read(), expected


@pytest.mark.parametrize('mask', [None, 'mask', 'khmer_mask'])
def test_filter_matches_jax(novel_case, tmp_path, mask):
    args = ['--case-min', '5', '--ctrl-max', '1', '--max-fpr', '0.5']
    if mask:
        args += ['--mask', novel_case[mask]]
    got, want = _both(tmp_path, args + [novel_case['novel']], 'filtered')
    assert got == want
    with open(novel_case['novel']) as fh:
        before = fh.read()
    nreads = want.count('\n+\n')
    assert 0 < nreads < before.count('\n+\n')


def test_filter_small_recount_memory_matches_jax(novel_case, tmp_path):
    """A 20 KB recount: collisions inflate some recounts, so the
    survivors differ from the roomy recount's — identically in both."""
    args = ['-M', '20K', '--max-fpr', '1.0', '--case-min', '5',
            novel_case['novel']]
    got, want = _both(tmp_path, args, 'small')
    assert got == want and want


def test_filter_fpr_bailout_matches_jax(novel_case, tmp_path, capsys):
    from kevlar_tpu.sketch import KevlarUnsuitableFPRError as JaxFPRError
    from kevlar_tpu_torch.sketch import KevlarUnsuitableFPRError
    args = ['-M', '2K', '--max-fpr', '0.001', novel_case['novel'], '-o',
            str(tmp_path / 'out')]
    with pytest.raises(JaxFPRError) as want:
        jax_cli.main(['filter'] + args)
    with pytest.raises(KevlarUnsuitableFPRError) as got:
        cli.main(['filter', '--device', 'cpu'] + args)
    assert str(got.value) == str(want.value)
    assert 'FPR too high, bailing out' in str(got.value)


def test_filter_function_with_live_device_mask(novel_case):
    """The workflow hands filter the live mask sketch it just counted (a
    device sketch on ``cpu`` here): same reads as with the file."""
    from kevlar_tpu import filter as jax_filter
    from kevlar_tpu import sketch as jax_sketch
    from kevlar_tpu_torch import count, filter as port_filter
    mask = count.load_sample_seqfile([novel_case['refr']], KSIZE, 100e3,
                                     maxfpr=1.0, count=False, device='cpu')
    got = [(r.name, [(k.offset, k.abund) for k in r.annotations])
           for r in port_filter.filter(novel_case['novel'], mask=mask,
                                       casemin=5, maxfpr=0.5)]
    want = [(r.name, [(k.offset, k.abund) for k in r.annotations])
            for r in jax_filter.filter(
                novel_case['novel'], mask=jax_sketch.load(
                    novel_case['mask'], cache=False),
                casemin=5, maxfpr=0.5)]
    assert got == want and got


def test_port_sketch_host_backend_matches_jax():
    """The host backend of the recount: counts, saturation and the
    ``valid`` argument of point queries, as ``kevlar_tpu``'s."""
    import numpy as np
    from kevlar_tpu.sketch import Sketch as JaxSketch
    from kevlar_tpu_torch.sketch import Sketch
    rng = np.random.default_rng(5)
    h1 = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    h2 = (rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
          | np.uint32(1))
    h1[:300] = h1[0]             # one k-mer 300 times: saturates at 15
    h2[:300] = h2[0]
    keep = rng.random(5000) < 0.8
    port = Sketch(KSIZE, 1009, 4, counter_bits=4, backend='host')
    jax = JaxSketch(KSIZE, 1009, 4, counter_bits=4, backend='host')
    assert port.consume_hashes(h1, h2, keep) == \
        jax.consume_hashes(h1, h2, keep)
    np.testing.assert_array_equal(port.tables, jax.tables)
    valid = rng.random(5000) < 0.5
    np.testing.assert_array_equal(port._host_counts(h1, h2, valid),
                                  jax._host_counts(h1, h2, valid))
    assert port.n_occupied() == jax.n_occupied()
    assert isinstance(port.tables, np.ndarray) and port.device is None


def test_port_sketch_device_consume_hashes_matches_host():
    """``consume_hashes`` of a device sketch (the accumulator path, plain
    versions on ``cpu``) counts as the host backend does."""
    import numpy as np
    from kevlar_tpu_torch.sketch import Sketch
    rng = np.random.default_rng(6)
    h1 = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    h1[:40] = h1[0]
    h2[:40] = h2[0]
    for bits in (1, 4, 8):
        dev = Sketch(KSIZE, 777, 4, counter_bits=bits, device='cpu')
        host = Sketch(KSIZE, 777, 4, counter_bits=bits, backend='host')
        assert dev.consume_hashes(h1, h2) == host.consume_hashes(h1, h2)
        np.testing.assert_array_equal(dev._host(), host.tables)


def test_save_async_and_process_cache(novel_case, tmp_path):
    """``load_sample_seqfile(save_async=True)`` saves on a thread; a load
    of the file joins it and, with the cache, returns the live sketch."""
    import numpy as np
    from kevlar_tpu import sketch as jax_sketch
    from kevlar_tpu_torch import count, sketch
    out = str(tmp_path / 'refr.sct')
    sk = count.load_sample_seqfile([novel_case['refr']], KSIZE, 50e3,
                                   maxfpr=1.0, smallcount=True, outfile=out,
                                   device='cpu', save_async=True)
    assert sk._save_thread is not None
    assert sketch.load(out, device='cpu') is sk
    assert sk._save_thread is None
    host = sketch.load(out, backend='host', cache=False)
    assert host is not sk and host.backend == 'host'
    want = jax_sketch.load(out, backend='host', cache=False)
    np.testing.assert_array_equal(host.tables, want.tables)
    with open(novel_case['refr']) as fh:
        seq = kevlar_tpu.seqio.parse_seq_dict(fh)['chr1']
    assert host.get_kmer_counts(seq[:500]) == want.get_kmer_counts(seq[:500])
