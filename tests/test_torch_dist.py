"""The port's ``dist`` subcommand and the ``Sketch`` batch API against
``kevlar_tpu``'s.

Tolerance: none.  ``dist``: on the same seeded reads and mask both command
lines must print the same JSON (mu and sigma to the last digit) and write
the same TSV; the abundance dictionary must have the same entries in the
same order (the order fixes sigma's rounding); a tracking sketch crowded
enough to lose k-mers to its false positives must lose the same ones; a
khmer-format mask takes the host engine in both.  The port runs with
``--device cpu``: both of its passes go through the plain PyTorch versions
of K1, K2 and K3's consume, batch by batch in ``kevlar_tpu``'s order.

``Sketch``: ``consume_batch`` (a band, a mask in both senses, 1/4/8-bit
counters, duplicates that saturate), ``consume_batch_stack``, ``consume``,
``add``/``count``, ``query_batch``, the hashing helpers,
``abundance_distribution``, ``allocate`` and ``autoload`` must give
``kevlar_tpu``'s tables, counts and return values, on a device sketch
(``device='cpu'``) and on a host-backend one.
"""

import json
import random

import numpy as np
import pytest
import torch

import kevlar_tpu
import kevlar_tpu_torch
from kevlar_tpu import cli as jax_cli, dist as jax_dist, sketch as jax_sketch
from kevlar_tpu.batch import batches_from_records as jax_batches
from kevlar_tpu_torch import cli, dist, sketch
from kevlar_tpu_torch.batch import batches_from_records
from kevlar_tpu_torch.ops import hashing, sketch_ops

from . import simdata

KSIZE = 21
TABLESIZE = 49_999


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    """Reads of two lengths over a 6 kb genome (N bases, some reads
    shorter than k, more than one batch of 4,096), and masks of the genome's
    first two thirds: native 1-bit, native 8-bit, khmer-format."""
    workdir = tmp_path_factory.mktemp('dist')
    rng = random.Random(2027)
    genome = simdata.make_genome(rng, 6000)
    reads = simdata.sample_reads(rng, genome, readlen=100, coverage=80)
    reads += simdata.sample_reads(rng, genome, readlen=150, coverage=30,
                                  prefix='long')
    reads += simdata.sample_reads(rng, genome, readlen=18, coverage=1,
                                  prefix='short')
    rng.shuffle(reads)
    for r in reads[::13]:
        pos = rng.randrange(len(r.sequence))
        r.sequence = r.sequence[:pos] + 'N' + r.sequence[pos + 1:]
    assert len(reads) > 4096
    paths = {'reads': str(workdir / 'reads.fq'),
             'more': str(workdir / 'more.fq'),
             'refr': str(workdir / 'refr.fa')}
    simdata.write_fastq(reads, paths['reads'])
    simdata.write_fastq(simdata.sample_reads(rng, genome, coverage=5,
                                             prefix='more'), paths['more'])
    simdata.write_fasta({'chr1': genome[:4000]}, paths['refr'])
    for name, flags in (('mask.nt', ['-c', '1']), ('mask.ct', ['-c', '8']),
                        ('khmer.nt', ['-c', '1', '--sketch-format',
                                      'khmer'])):
        paths[name] = str(workdir / name)
        jax_cli.main(['count', '-k', str(KSIZE), '-M', '40K', '--max-fpr',
                      '1.0'] + flags + [paths[name], paths['refr']])
    paths['genome'] = genome
    return paths


def _run_dist(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize('maskname,memory,infiles', [
    ('mask.nt', '400K', ['reads']), ('mask.ct', '400K', ['reads', 'more']),
    ('mask.nt', '6K', ['more', 'reads']), ('khmer.nt', '400K', ['reads'])],
    ids=['1-bit-mask', '8-bit-mask-two-files', 'crowded-tracking',
         'khmer-mask'])
def test_dist_cli_matches_jax(case, tmp_path, capsys, maskname, memory,
                              infiles):
    argv = ['dist', '-k', str(KSIZE), '-M', memory]
    files = [case[maskname]] + [case[name] for name in infiles]
    want = _run_dist(jax_cli.main, argv + ['--tsv', str(tmp_path / 'jax.tsv')]
                     + files, capsys)
    got = _run_dist(cli.main, argv + ['--device', 'cpu', '--tsv',
                                      str(tmp_path / 'port.tsv')] + files,
                    capsys)
    assert got == want
    stats = json.loads(want.strip().splitlines()[-1])
    assert 20 < stats['mu'] < (120 if memory == '400K' else 255)
    assert stats['sigma'] > 1
    with open(str(tmp_path / 'jax.tsv')) as fh:
        table = fh.read()
    with open(str(tmp_path / 'port.tsv')) as fh:
        assert fh.read() == table
    assert table.startswith('Abundance\tCount\t') and table.count('\n') > 10


@pytest.mark.parametrize('memory', [4e5, 6e3], ids=['roomy', 'crowded'])
def test_abundance_dictionary_matches_jax_entry_for_entry(case, memory):
    jmask = jax_sketch.load(case['mask.nt'])
    pmask = sketch.load(case['mask.nt'], device='cpu')
    jcounts = jax_sketch.Sketch(KSIZE, int(memory) // 4, 4, counter_bits=8)
    pcounts = sketch.Sketch(KSIZE, int(memory) // 4, 4, counter_bits=8,
                            device='cpu')
    files = [case['more'], case['reads']]
    jax_dist.count_first_pass(files, jcounts, jmask)
    dist.count_first_pass(files, pcounts, pmask)
    np.testing.assert_array_equal(pcounts._host(),
                                  np.asarray(jcounts._host()))
    want = jax_dist.count_second_pass(files, jcounts, jmask)
    got = dist.count_second_pass(files, pcounts, pmask)
    assert list(got.items()) == list(want.items())
    # masked k-mers only: two thirds of the genome's, less those that a
    # crowded tracking sketch, filled by the first file, takes for seen
    # when they first appear in the second
    distinct = sum(want.values())
    if memory == 4e5:
        assert 3960 < distinct <= 4000 - KSIZE + 1 + 40
    else:
        assert distinct < 3960


def test_dist_with_a_host_backend_mask(case):
    """A mask loaded for host lookups is packed and shipped."""
    want = dist.dist([case['more']], sketch.load(case['mask.nt'],
                                                 device='cpu'),
                     ksize=KSIZE, memory=4e5, device='cpu')
    got = dist.dist([case['more']], sketch.load(
        case['mask.nt'], backend='host', cache=False), ksize=KSIZE,
        memory=4e5, device='cpu')
    assert got == want


def test_dist_zero_abundance_raises_like_jax(case):
    empty = sketch.Sketch(KSIZE, 999, 4, counter_bits=1, device='cpu')
    with pytest.raises(dist.KevlarZeroAbundanceDistError):
        dist.dist([case['more']], empty, ksize=KSIZE, memory=4e4,
                  device='cpu')
    with pytest.raises(jax_dist.KevlarZeroAbundanceDistError):
        jax_dist.dist([case['more']], jax_sketch.Sketch(
            KSIZE, 999, 4, counter_bits=1), ksize=KSIZE, memory=4e4)


def test_dist_plot_is_skipped_or_written_like_jax(case, tmp_path, capsys):
    """Without matplotlib both say so and write no plot."""
    outs = []
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        png = tmp_path / (name + '.png')
        out = _run_dist(main, ['dist', '-k', str(KSIZE), '-M', '400K',
                               '--plot', str(png)] + extra +
                        [case['mask.nt'], case['more']], capsys)
        outs.append((out, png.exists()))
    assert outs[0] == outs[1]


# -- the Sketch batch API ---------------------------------------------------

def _batches(path, batches_fn, open_fn):
    pkg = kevlar_tpu if batches_fn is jax_batches else kevlar_tpu_torch
    return [b.bases for b in batches_fn(pkg.seqio.multi_file_iter([path]))]


@pytest.fixture(scope='module')
def batches(case):
    want = _batches(case['reads'], jax_batches, None)
    got = _batches(case['reads'], batches_from_records, None)
    assert len(want) == len(got) >= 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    return got


@pytest.fixture(scope='module')
def masks(case):
    return (jax_sketch.load(case['mask.ct']),
            sketch.load(case['mask.ct'], device='cpu'))


CONSUME_MODES = {
    'plain': {},
    'band': dict(numbands=4, band=1),
    'mask-out': dict(mask=True, mask_threshold=0),
    'mask-out-threshold': dict(mask=True, mask_threshold=2),
    'mask-in': dict(mask=True, mask_threshold=1, consume_masked=True),
    'band-mask-in': dict(numbands=2, band=0, mask=True, mask_threshold=1,
                         consume_masked=True),
}


@pytest.mark.parametrize('backend', ['device', 'host'])
@pytest.mark.parametrize('mode', sorted(CONSUME_MODES))
@pytest.mark.parametrize('bits', [1, 4, 8])
def test_consume_batch_matches_jax(batches, masks, bits, mode, backend):
    kw = dict(CONSUME_MODES[mode])
    jkw, pkw = dict(kw), dict(kw)
    if kw.get('mask'):
        jkw['mask'], pkw['mask'] = masks
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                        device='cpu', backend=backend)
    for bases in batches:
        want_n = int(jsk.consume_batch(bases, **jkw))
        got_n = psk.consume_batch(bases, **pkw)
        assert int(got_n) == want_n
        if backend == 'device':
            assert torch.is_tensor(got_n) and got_n.dim() == 0
    want = np.asarray(jsk._host())
    np.testing.assert_array_equal(psk._host(), want)
    assert psk.n_occupied() == jsk.n_occupied()
    assert want.max() == {1: 1, 4: 15, 8: 255}[bits] or mode != 'plain' \
        or bits == 8
    assert want.sum() > 0


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_duplicates_in_a_batch_saturate_like_jax(bits):
    bases = np.zeros((300, 128), dtype=np.uint8)        # poly-A rows
    bases[:, 100:] = 4
    bases[7, 50] = 4
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                        device='cpu')
    for _ in range(2):
        assert int(psk.consume_batch(bases)) == \
            int(jsk.consume_batch(bases)) == 300 * 80 - KSIZE
    np.testing.assert_array_equal(psk._host(), np.asarray(jsk._host()))
    assert psk.get('A' * KSIZE) == {1: 1, 4: 15, 8: 255}[bits]


@pytest.mark.parametrize('backend', ['device', 'host'])
def test_consume_batch_stack_matches_jax(batches, masks, backend):
    stack = np.stack([b for b in batches if b.shape == batches[0].shape][:2]
                     + [np.full_like(batches[0], 4)])
    assert stack.shape[0] == 3
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=4)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=4, device='cpu',
                        backend=backend)
    kw = dict(numbands=2, band=1, mask_threshold=1, consume_masked=True)
    assert jsk.consume_batch_stack(stack, mask=masks[0], **kw) is None
    assert psk.consume_batch_stack(stack, mask=masks[1], **kw) is None
    np.testing.assert_array_equal(psk._host(), np.asarray(jsk._host()))
    assert psk._host().sum() > 0


def test_ops_level_counterparts_match_jax(batches, masks):
    """``sketch_ops.consume_batch``, ``consume_batch_stack`` and
    ``query_batch`` against ``kevlar_tpu.ops.sketch_ops``'s."""
    from kevlar_tpu.ops import sketch_ops as jax_ops
    import jax.numpy as jnp
    bases = batches[0]
    codes = torch.from_numpy(bases)
    jtables = jnp.zeros((4, TABLESIZE), jnp.uint8)
    jtables, want_n = jax_ops.consume_batch(
        jtables, jnp.asarray(bases), ksize=KSIZE, maxcount=255, numbands=2,
        band=1, counter_bits=8, tablesize=TABLESIZE)
    acc = sketch_ops.Accumulator(torch.zeros((4, TABLESIZE),
                                             dtype=torch.uint8), 8, TABLESIZE)
    got_n = sketch_ops.consume_batch(acc, codes, KSIZE, numbands=2, band=1)
    assert int(got_n) == int(want_n) > 0
    stack = np.stack([bases, bases])
    jtables = jax_ops.consume_batch_stack(
        jtables, jnp.asarray(stack), ksize=KSIZE, maxcount=255,
        counter_bits=8, tablesize=TABLESIZE)
    sketch_ops.consume_batch_stack(acc, torch.from_numpy(stack), KSIZE)
    tables = acc.tables()
    np.testing.assert_array_equal(tables.numpy(), np.asarray(jtables))
    want_counts, want_valid = jax_ops.query_batch(
        jtables, jnp.asarray(bases), KSIZE, counter_bits=8,
        tablesize=TABLESIZE)
    counts, valid = sketch_ops.query_batch(tables, codes, KSIZE, 8,
                                           TABLESIZE)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(valid.numpy().astype(bool),
                                  np.asarray(want_valid))
    assert counts.max() >= 2


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_query_batch_matches_jax_and_the_host_mirror(batches, case, bits):
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=bits,
                        device='cpu')
    for bases in batches[:2]:
        jsk.consume_batch(bases)
        psk.consume_batch(bases)
    probe = batches[-1]
    want_counts, want_valid = jsk.query_batch(probe)
    counts, valid = psk.query_batch(probe)
    assert counts.dtype == valid.dtype == torch.uint8
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(valid.numpy().astype(bool),
                                  np.asarray(want_valid))
    seq = case['genome'][1000:1100]
    row = np.full((1, 128), 4, dtype=np.uint8)
    row[0, :100] = kevlar_tpu_torch.dna.encode(seq)
    counts, valid = psk.query_batch(row)
    assert counts[0, :80].tolist() == psk.get_kmer_counts(seq) == \
        jsk.get_kmer_counts(seq)
    assert int(valid.sum()) == 80 and max(psk.get_kmer_counts(seq)) > 0
    with pytest.raises(ValueError, match='device sketch'):
        sketch.Sketch(KSIZE, 99, backend='host').query_batch(row)


@pytest.mark.parametrize('backend', ['device', 'host'])
def test_string_api_matches_jax(case, backend):
    genome = case['genome']
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4, backend=backend)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, device='cpu', backend=backend)
    for seq in (genome[:300], genome[100:180] + 'N' + genome[181:400],
                genome[:KSIZE - 1], genome[:KSIZE], genome[:2000]):
        assert psk.consume(seq) == jsk.consume(seq)
    kmer = genome[40:40 + KSIZE]
    assert psk.add(kmer) is None and jsk.add(kmer) is None
    assert psk.count(kmer) is None and jsk.count(kmer) is None
    assert psk.get(kmer) == jsk.get(kmer) == 4
    assert psk.hash(kmer) == jsk.hash(kmer)
    assert psk.hash(kevlar_tpu_torch.revcom(kmer)) == psk.hash(kmer)
    seq = genome[90:200] + 'N' + genome[201:260]
    assert psk.get_kmers(seq) == jsk.get_kmers(seq)
    assert psk.get_kmer_hashes(seq) == jsk.get_kmer_hashes(seq)
    assert len(psk.get_kmer_hashes(seq)) == len(seq) - KSIZE + 1 - KSIZE
    for sk in (psk, jsk):
        with pytest.raises(ValueError, match='reverse hashing'):
            sk.reverse_hash(12345)
    np.testing.assert_array_equal(psk._host(), np.asarray(jsk._host()))


def test_abundance_distribution_matches_jax(case):
    jsk = jax_sketch.Sketch(KSIZE, TABLESIZE, 4)
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, device='cpu')
    jax_dist.count_first_pass([case['more']], jsk, None)
    for bases in _batches(case['more'], batches_from_records, None):
        psk.consume_batch(bases)
    jtrack = jax_sketch.Sketch(KSIZE, 2999, 4, counter_bits=1,
                               backend='host')
    ptrack = sketch.Sketch(KSIZE, 2999, 4, counter_bits=1, backend='host')
    want = jsk.abundance_distribution(case['more'], jtrack)
    got = psk.abundance_distribution(case['more'], ptrack)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ptrack.tables, jtrack.tables)
    assert want[1:].sum() > 1000
    # a second call sees everything tracked already
    assert psk.abundance_distribution(case['more'], ptrack).sum() == 0


def test_allocate_and_autoload_match_jax(case, tmp_path):
    from kevlar_tpu.oxli import OxliSketch as JaxOxli
    from kevlar_tpu_torch.oxli import OxliSketch
    for kw, bits in ((dict(), 1), (dict(count=True), 8),
                     (dict(count=True, smallcount=True), 4)):
        want = jax_sketch.allocate(KSIZE, 1e4, 3, **kw)
        got = sketch.allocate(KSIZE, 1e4, 3, device='cpu', **kw)
        assert (got.counter_bits, got.tablesize, got.ntables, got.backend) \
            == (want.counter_bits, want.tablesize, want.ntables,
                want.backend) == (bits, 10000, 3, 'device')
    graph = sketch.allocate(KSIZE, 1e4, graph=True, count=True, device='cpu')
    assert isinstance(graph, OxliSketch) and graph.hash_mode == 'twobit'
    assert isinstance(jax_sketch.allocate(KSIZE, 1e4, graph=True,
                                          count=True), JaxOxli)
    # a sketch file loads; anything else is counted as sequence
    loaded = sketch.autoload(case['mask.ct'], device='cpu')
    assert loaded.counter_bits == 8 and loaded.ksize() == KSIZE
    for kw in (dict(), dict(num_bands=2, band=1), dict(count=False)):
        want = jax_sketch.autoload(case['more'], ksize=KSIZE,
                                   table_size=20011, **kw)
        got = sketch.autoload(case['more'], ksize=KSIZE, table_size=20011,
                              device='cpu', **kw)
        np.testing.assert_array_equal(got._host(), np.asarray(want._host()))
        assert got._host().sum() > 0
    want = jax_sketch.autoload(case['more'], graph=True, ksize=KSIZE,
                               table_size=20011)
    got = sketch.autoload(case['more'], graph=True, ksize=KSIZE,
                          table_size=20011, device='cpu')
    seq = case['genome'][500:600]
    assert got.get_kmer_counts(seq) == want.get_kmer_counts(seq)


def test_a_consuming_block_holds_one_accumulator(batches):
    """Batch consumes inside a ``consuming()`` block share one int32
    accumulator, packed once at the block's end; outside a block each is a
    block of its own, and the counters come out the same."""
    psk = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=4, device='cpu')
    with psk.consuming() as acc:
        assert psk.tables is None
        for bases in batches[:2]:
            psk.consume_batch(bases)
            with psk.consuming() as inner:          # nests, does not close
                assert inner is acc
            assert psk.tables is None
        with pytest.raises(ValueError, match='consuming'):
            psk.table_spec()
    once = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=4, device='cpu')
    for bases in batches[:2]:
        once.consume_batch(bases)
        assert once.tables.dtype == torch.uint8     # closed after each batch
    assert torch.equal(psk.table_spec()[0], once.tables)
    assert psk.tables.sum() > 0 and psk.n_occupied() == once.n_occupied()
    with psk.consuming() as again:
        assert again is not acc
    assert torch.equal(psk.tables, once.tables)
    with pytest.raises(ValueError, match='no accumulator'):
        with sketch.Sketch(KSIZE, 99, backend='host').consuming():
            pass
    with pytest.raises(ValueError, match='khmer'):
        from kevlar_tpu_torch.oxli import OxliSketch
        psk.consume_batch(batches[0], mask=OxliSketch(KSIZE, 1e4, 4,
                                                      counter_bits=1))


def _hashed(bases):
    h1, h2, valid = hashing.kmer_hashes_codes(torch.from_numpy(bases), KSIZE)
    return h1.reshape(-1), h2.reshape(-1), valid.reshape(-1)


@pytest.mark.parametrize('mode', sorted(CONSUME_MODES))
def test_mark_hashes_sets_what_a_one_bit_consume_sets(batches, masks, mode):
    """K3's mark mode (its plain version here): the 8-bit presence table
    holds 1 exactly where a 1-bit sketch's consume of the same k-mers under
    the same predicates holds 1, however often a k-mer came."""
    kw = dict(CONSUME_MODES[mode])
    onebit = sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=1, device='cpu')
    marks = torch.zeros((4, TABLESIZE), dtype=torch.uint8)
    mask = masks[1] if kw.pop('mask', False) else None
    for bases in batches[:2] + batches[:1]:
        onebit.consume_batch(bases, mask=mask, **kw)
        h1, h2, valid = _hashed(bases)
        mcnt = None if mask is None else sketch_ops.gather_counts(
            *mask.table_spec()[:1], h1, h2, *mask.table_spec()[1:])
        assert sketch_ops.mark_hashes(marks, h1, h2, valid, mcnt=mcnt,
                                      **kw) is marks
    np.testing.assert_array_equal(marks.numpy(), onebit._host())
    assert 0 < int(marks.sum()) < marks.numel() and int(marks.max()) == 1
    with pytest.raises(ValueError, match='uint8'):
        sketch_ops.mark_hashes(marks.to(torch.int32), h1, h2, valid)


def test_the_consume_counts_what_it_kept(batches, masks):
    """``nkept`` is raised by the consume itself, call after call; the
    counters do not depend on whether it is asked for."""
    h1, h2, valid = _hashed(batches[0])
    mcnt = sketch_ops.gather_counts(masks[1].table_spec()[0], h1, h2,
                                    *masks[1].table_spec()[1:])
    kw = dict(mcnt=mcnt, mask_threshold=1, consume_masked=True, numbands=2,
              band=1)
    want = int(((valid != 0) & (mcnt >= 1) &
                ((hashing.to_u32(h1) & 1) == 1)).sum())
    nkept = torch.zeros(1, dtype=torch.int64)
    acc = torch.zeros((4, TABLESIZE), dtype=torch.int32)
    sketch_ops.consume_hashes(acc, h1, h2, valid, nkept=nkept, **kw)
    assert int(nkept) == want > 0
    sketch_ops.consume_hashes(acc, h1, h2, valid, nkept=nkept)
    assert int(nkept) == want + int(valid.sum())
    bare = torch.zeros((4, TABLESIZE), dtype=torch.int32)
    sketch_ops.consume_hashes(bare, h1, h2, valid, **kw)
    sketch_ops.consume_hashes(bare, h1, h2, valid)
    assert torch.equal(acc, bare) and int(acc[0].sum()) == int(nkept)
    with pytest.raises(ValueError, match='nkept'):
        sketch_ops.consume_hashes(acc, h1, h2, valid,
                                  nkept=torch.zeros(1, dtype=torch.int32))


# -- batches made a block of reads at a time --------------------------------

def _write_mixed(path, kind, rng):
    """FASTQ/FASTA with reads of every length bucket (and beyond 1,024),
    blank lines, lower case, N and other letters, in an order that fills
    several buckets' batches mid-stream."""
    import gzip
    lengths = [rng.choice((30, 100, 128, 129, 150, 160, 161, 250, 300, 600,
                           1024, 1025, 3000)) for _ in range(700)]
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'wt') as fh:
        for i, n in enumerate(lengths):
            seq = ''.join(rng.choice('ACGTacgtNRY') for _ in range(n))
            if kind == 'fastq':
                fh.write('@r{} extra\n{}\n+\n{}\n'.format(i, seq, 'I' * n))
                if i % 50 == 0:
                    fh.write('\n')
            else:
                fh.write('>r{}\n'.format(i))
                for lo in range(0, n, 70):
                    fh.write(seq[lo:lo + 70] + '\n')


@pytest.mark.parametrize('name,kind', [('mixed.fq', 'fastq'),
                                       ('mixed.fq.gz', 'fastq'),
                                       ('mixed.fa', 'fasta')])
@pytest.mark.parametrize('batch_size', [16, 64])
def test_block_batches_equal_record_batches(tmp_path, name, kind,
                                            batch_size):
    from kevlar_tpu_torch.batch import base_batches_from_files
    paths = [str(tmp_path / ('a' + name)), str(tmp_path / ('b' + name))]
    for seed, path in enumerate(paths):
        _write_mixed(path, kind, random.Random(seed))
    want = [b.bases for b in batches_from_records(
        kevlar_tpu_torch.seqio.multi_file_iter(paths),
        batch_size=batch_size)]
    jax_want = [np.asarray(b.bases) for b in jax_batches(
        kevlar_tpu.seqio.multi_file_iter(paths), batch_size=batch_size)]
    got = list(base_batches_from_files(paths, batch_size=batch_size))
    assert len(got) == len(want) == len(jax_want) > 1400 // batch_size
    for g, w, j in zip(got, want, jax_want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    assert len({g.shape[1] for g in got}) >= 7


def test_block_batches_of_the_case_reads(case, batches):
    from kevlar_tpu_torch.batch import base_batches_from_files
    got = list(base_batches_from_files([case['reads']]))
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        np.testing.assert_array_equal(g, w)


def test_cut_short_fastq_is_refused(tmp_path):
    from kevlar_tpu_torch.batch import base_batches_from_files
    path = str(tmp_path / 'cut.fq')
    with open(path, 'w') as fh:
        fh.write('@r1\nACGT\n+\nIIII\n@r2\nACGT\n')
    with pytest.raises(ValueError, match='cut short'):
        list(base_batches_from_files([path]))
    empty = str(tmp_path / 'empty.fq')
    open(empty, 'w').close()
    assert list(base_batches_from_files([empty])) == []
