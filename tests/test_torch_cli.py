"""The nine subcommands the port's command line gained (``augment``,
``assemble``, ``localize``, ``call``, ``split``, ``unband``, ``mutate``,
``gentrio``, ``dist`` — the last in test_torch_dist.py) and its other
entry points against ``kevlar_tpu``'s.

Tolerance: none.  On the same seeded inputs both command lines must write
identical text: contigs, cutouts, VCF records, split shards, merged band
outputs, simulated genomes and truth VCFs (same seed, same draws),
``mutsim`` histograms, khmer-format sketch files byte for byte.  The port
runs with ``--device cpu`` (the plain PyTorch versions of its kernels); the
JAX side aligns through its Pallas kernel in interpret mode.  ``split`` +
per-shard ``assemble``/``localize``/``call`` must give ``alac``'s records.
"""

import inspect
import io
import json
import os
import random

import numpy as np
import pytest

import kevlar_tpu
import kevlar_tpu_torch
from kevlar_tpu import cli as jax_cli
from kevlar_tpu_torch import cli

from . import simdata
from .test_torch_alac import mini_trio, _jax_native_loaded  # noqa: F401
from .test_torch_filter import make_novel_case

KSIZE = 21


@pytest.fixture(autouse=True)
def _pallas_backend(monkeypatch):
    monkeypatch.setenv('KEVLAR_ALIGN_BACKEND', 'pallas')
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


def _read(path, mode='r'):
    with open(path, mode) as fh:
        return fh.read()


def _records(path):
    """A VCF's lines without the header's date."""
    return [line for line in _read(path).split('\n')
            if not line.startswith('##fileDate')]


def _both(tmp_path, argv, name, device=False):
    """Run ``argv + ['-o', out]`` through both command lines; returns
    (the port's text, ``kevlar_tpu``'s text)."""
    want, got = str(tmp_path / (name + '.jax')), str(tmp_path / name)
    jax_cli.main(argv + ['-o', want])
    cli.main(argv[:1] + (['--device', 'cpu'] if device else []) + argv[1:] +
             ['-o', got])
    return _read(got), _read(want)


@pytest.fixture(scope='module')
def stages(mini_trio, tmp_path_factory):
    """``kevlar_tpu``'s contigs and cutouts of the mini trio: (reference,
    partitioned reads, contigs, cutouts)."""
    workdir = tmp_path_factory.mktemp('stages')
    refr, reads = mini_trio
    contigs = str(workdir / 'contigs.augfasta')
    cutouts = str(workdir / 'cutouts.fa')
    jax_cli.main(['assemble', '-o', contigs, reads])
    jax_cli.main(['localize', '-z', '25', '-o', cutouts, refr, contigs])
    return refr, reads, contigs, cutouts


def test_port_has_the_sixteen_subcommands():
    want = sorted(set(jax_cli.SUBPARSER_FUNCS) - {'warm'})
    assert sorted(cli.SUBPARSER_FUNCS) == want
    assert sorted(cli.mains()) == want
    assert len(want) == 16
    helptext = cli.parser().format_help()
    for name in want:
        assert name in helptext


@pytest.mark.parametrize('flags', [[], ['-p', '1'], ['--max-reads', '5']],
                         ids=['all', 'part-id', 'max-reads'])
def test_assemble_matches_jax(stages, tmp_path, flags):
    got, want = _both(tmp_path, ['assemble'] + flags + [stages[1]],
                      'contigs')
    assert got == want
    assert ('>contig1' in want) == (flags != ['--max-reads', '5'])


def test_augment_matches_jax(stages, tmp_path):
    refr, reads, contigs, _ = stages
    naked = str(tmp_path / 'naked.fa')
    with open(naked, 'w') as fh:
        for rec in kevlar_tpu.parse_augmented_fastx(open(contigs)):
            fh.write('>{}\n{}\n'.format(rec.name, rec.sequence))
    got, want = _both(tmp_path, ['augment', reads, naked], 'augmented')
    assert got == want == _read(contigs)
    assert '#\n' in got


@pytest.mark.parametrize('flags', [['-z', '25'], ['-z', '25', '-d', '10'],
                                   ['-z', '25', '-p', '2'],
                                   ['-z', '25', '--exclude', 'chr']],
                         ids=['seed25', 'delta', 'part-id', 'exclude'])
def test_localize_matches_jax(stages, tmp_path, flags):
    refr, _, contigs, _ = stages
    want, got = str(tmp_path / 'jax.fa'), str(tmp_path / 'port.fa')
    jax_cli.main(['localize'] + flags + ['-o', want, refr, contigs])
    cli.main(['localize'] + flags + ['-o', got, refr, contigs])
    assert _read(got) == _read(want)
    assert ('>chr1_' in _read(want)) == ('--exclude' not in flags)


@pytest.mark.parametrize('flags', [[], ['-E', '1', '-O', '4'],
                                   ['--no-homopoly-filter', '--debug'],
                                   ['--max-target-length', '150']],
                         ids=['default', 'scores', 'nofilter-debug',
                              'nocall'])
def test_call_matches_jax(stages, tmp_path, flags):
    refr, _, contigs, cutouts = stages
    argv = ['call', '-k', str(KSIZE), '--refr', refr] + flags
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    jax_cli.main(argv + ['-o', want, contigs, cutouts])
    cli.main(argv + ['--device', 'cpu', '-o', got, contigs, cutouts])
    assert _records(got) == _records(want)
    assert any('\tPASS\t' in line or '\t.\t.\t.\t' in line
               for line in _records(want))


def test_call_gen_mask_matches_jax(stages, tmp_path):
    refr, _, contigs, cutouts = stages
    masks = []
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        mask = str(tmp_path / (name + '.nt'))
        main(['call', '-k', str(KSIZE), '--gen-mask', mask, '--mask-mem',
              '10K'] + extra + ['-o', str(tmp_path / (name + '.vcf')),
                                contigs, cutouts])
        masks.append(_read(mask, 'rb'))
    assert masks[0] == masks[1] and len(masks[0]) > 1000


def test_split_matches_jax(stages, tmp_path):
    reads = stages[1]
    jax_cli.main(['split', reads, '3', str(tmp_path / 'jax')])
    cli.main(['split', reads, '3', str(tmp_path / 'port')])
    sizes = []
    for i in range(3):
        want = _read(str(tmp_path / 'jax.{}.augfastx'.format(i)))
        assert _read(str(tmp_path / 'port.{}.augfastx'.format(i))) == want
        sizes.append(len(want))
    assert sizes[0] > 0 and sizes[1] > 0


def test_split_then_call_per_shard_equals_alac(stages, tmp_path):
    """The scatter/gather route (``split``, then ``assemble``, ``localize``
    and ``call`` a shard) gives the records of one ``alac`` run; both
    sorted, since ``alac`` sorts by position and a shard keeps partition
    order."""
    refr, reads, _, _ = stages
    alac_vcf = str(tmp_path / 'alac.vcf')
    cli.main(['alac', '-k', str(KSIZE), '-z', '25', '--device', 'cpu', '-o',
              alac_vcf, reads, refr])
    cli.main(['split', reads, '2', str(tmp_path / 'shard')])
    gathered = []
    for i in range(2):
        shard = str(tmp_path / 'shard.{}.augfastx'.format(i))
        contigs = str(tmp_path / 'contigs{}.augfasta'.format(i))
        cutouts = str(tmp_path / 'cutouts{}.fa'.format(i))
        calls = str(tmp_path / 'calls{}.vcf'.format(i))
        cli.main(['assemble', '-o', contigs, shard])
        cli.main(['localize', '-z', '25', '-o', cutouts, refr, contigs])
        cli.main(['call', '-k', str(KSIZE), '--refr', refr, '--device',
                  'cpu', '-o', calls, contigs, cutouts])
        gathered += [line for line in _records(calls)
                     if line and line[0] != '#']
    want = [line for line in _records(alac_vcf) if line and line[0] != '#']
    assert len(want) >= 2
    # contig numbers restart in each shard: compare without CONTIG names
    def strip(line):
        return ';'.join(f for f in line.split(';')
                        if not f.startswith('CONTIG='))
    assert sorted(map(strip, gathered)) == sorted(map(strip, want))


@pytest.fixture(scope='module')
def novel_case(tmp_path_factory):
    return make_novel_case(tmp_path_factory.mktemp('cli'))


def test_banded_count_novel_then_unband_matches_jax(novel_case, tmp_path):
    """Two hash bands counted and screened apart, merged by ``unband``."""
    texts = {}
    for name, main, extra in (('jax', jax_cli.main, []),
                              ('port', cli.main, ['--device', 'cpu'])):
        outdir = tmp_path / name
        outdir.mkdir()
        bands = []
        for band in ('1', '2'):
            banding = ['--num-bands', '2', '--band', band]
            tables = {}
            for who in ('proband', 'mother', 'father'):
                tables[who] = str(outdir / '{}.{}.ct'.format(who, band))
                main(['count', '-k', str(KSIZE), '-M', '200K', '--max-fpr',
                      '1.0'] + banding + extra +
                     [tables[who], novel_case[who + '.fq']])
            bands.append(str(outdir / 'novel.{}.augfastq'.format(band)))
            main(['novel', '-k', str(KSIZE), '--case',
                  novel_case['proband.fq'], '--case-counts',
                  tables['proband'], '--control-counts', tables['mother'],
                  tables['father'], '--case-min', '5', '--ctrl-max', '1',
                  '--max-fpr', '1.0'] + banding + extra + ['-o', bands[-1]])
        merged = str(outdir / 'merged.augfastq')
        main(['unband', '-n', '4', '-o', merged] + bands)
        texts[name] = [_read(p) for p in bands + [merged]]
    assert texts['port'] == texts['jax']
    band1, band2, merged = texts['jax']
    assert band1 and band2 and band1 != band2
    assert merged.count('#\n') == band1.count('#\n') + band2.count('#\n')


@pytest.mark.parametrize('argv', [
    ['-i', '4', '-d', '2', '--seed', '42'],
    ['-i', '6', '-d', '3', '--seed', '7', '--weights',
     'snv=0.4,ins=0.3,del=0.3', '--indel-sizes', '5-20,40-60']],
    ids=['default-weights', 'indel-bands'])
def test_gentrio_same_seed_same_text(tmp_path, argv):
    genomefile = str(tmp_path / 'genome.fa')
    simdata.write_fasta(
        {'chr1': simdata.make_genome(random.Random(7), 3000),
         'chr2': simdata.make_genome(random.Random(8), 2500)}, genomefile)
    outputs = {}
    for name, main in (('jax', jax_cli.main), ('port', cli.main)):
        prefix = str(tmp_path / (name + 'trio'))
        vcf = str(tmp_path / (name + '.vcf'))
        main(['gentrio', '--vcf', vcf, '--prefix', prefix] + argv +
             [genomefile])
        outputs[name] = [_read(vcf)] + [
            _read('{}-{}.fasta'.format(prefix, who))
            for who in ('proband', 'mother', 'father')]
    assert outputs['port'] == outputs['jax']
    assert sum(1 for line in outputs['jax'][0].split('\n')
               if line and line[0] != '#') == \
        int(argv[1]) + int(argv[3])


def test_mutate_matches_jax(tmp_path):
    genomefile = str(tmp_path / 'genome.fa')
    genome = simdata.make_genome(random.Random(3), 2000)
    simdata.write_fasta({'chr1': genome, 'chr2': genome[::-1]}, genomefile)
    mutfile = str(tmp_path / 'muts.txt')
    with open(mutfile, 'w') as fh:
        fh.write('# seq pos type data\n'
                 'chr1\t100\tsnv\t1\nchr1\t900\tins\tGATTACA\n'
                 'chr1\t1500\tdel\t12\nchr2\t300\tinv\t40\n'
                 'chr2\t20\tsnv\t3\n')
    got, want = _both(tmp_path, ['mutate', mutfile, genomefile], 'mutated')
    assert got == want
    seqs = kevlar_tpu.seqio.parse_seq_dict(io.StringIO(got))
    assert seqs['chr1'][100] != genome[100] and 'GATTACA' in seqs['chr1']
    assert len(seqs['chr1']) == 2000 + 7 - 12
    with open(mutfile, 'a') as fh:
        fh.write('chr1\t5\tdup\t2\n')
    for module in (kevlar_tpu.mutate, kevlar_tpu_torch.mutate):
        with pytest.raises(ValueError, match='invalid variant type'):
            module.load_mutations(open(mutfile))


@pytest.mark.parametrize('argv', [['-t', 'snv'], ['-t', 'del', '-z', '4'],
                                  ['-t', 'snv', '-r', '0.3', '-s', '5'],
                                  ['-t', 'del', '-l', '50', '-m', '8']],
                         ids=['snv', 'del', 'sampled', 'limit'])
def test_mutsim_matches_jax(novel_case, capsys, argv):
    from kevlar_tpu import mutsim as jax_mutsim
    from kevlar_tpu_torch import mutsim
    args = ['-k', str(KSIZE)] + argv + [novel_case['refr'],
                                        novel_case['mother']]
    jax_mutsim.main(args)
    want = capsys.readouterr().out
    mutsim.main(['--device', 'cpu'] + args)
    got = capsys.readouterr().out
    assert got == want
    assert want.count('[') == 2 and len(want) > 40


def test_mutsim_queries_a_device_sketch_with_query_batch(novel_case,
                                                         monkeypatch, capsys):
    """Whatever device but the CPU is asked for, the counttable loads as a
    device sketch there and every batch of windows is one ``query_batch``
    (K1 and K2 on a card); the histograms are those of the host lookups."""
    from kevlar_tpu_torch import mutsim, sketch
    args = ['-k', str(KSIZE), '-l', '200', novel_case['refr'],
            novel_case['mother']]
    mutsim.main(['--device', 'cpu'] + args)
    want = capsys.readouterr().out

    asked, queries = [], []
    load, query = sketch.load, sketch.Sketch.query_batch

    def load_on_cpu(filename, device='cuda', **kw):
        asked.append((device, kw))
        return load(filename, device='cpu', **kw)

    def counting_query(self, bases):
        queries.append(bases.shape)
        return query(self, bases)

    monkeypatch.setattr(sketch, 'load', load_on_cpu)
    monkeypatch.setattr(sketch.Sketch, 'query_batch', counting_query)
    mutsim.main(args)
    assert capsys.readouterr().out == want
    assert asked == [('cuda', {})]
    assert queries and all(shape[1] == 2 * KSIZE - 1 for shape in queries)


@pytest.mark.parametrize('bits,ext', [(1, '.nt'), (4, '.sct'), (8, '.ct')])
def test_khmer_format_count_is_byte_identical(novel_case, tmp_path, bits,
                                              ext):
    argv = ['count', '-k', str(KSIZE), '-c', str(bits), '-M', '80K',
            '--max-fpr', '1.0', '--sketch-format', 'khmer']
    want, got = str(tmp_path / ('jax' + ext)), str(tmp_path / ('port' + ext))
    jax_cli.main(argv + [want, novel_case['mother.fq']])
    cli.main(argv + ['--device', 'cpu', got, novel_case['mother.fq']])
    assert _read(got, 'rb') == _read(want, 'rb')
    assert _read(want, 'rb')[:4] == b'OXLI'


@pytest.mark.parametrize('flags', [[], ['--count-masked'],
                                   ['--num-bands', '2', '--band', '2']],
                         ids=['masked-out', 'count-masked', 'banded'])
def test_count_with_khmer_mask_matches_jax(novel_case, tmp_path, flags):
    """A khmer-format mask pulls the whole count into khmer's hash space:
    the saved table is khmer-format, and byte-identical."""
    argv = ['count', '-k', str(KSIZE), '-M', '80K', '--max-fpr', '1.0',
            '--mask', novel_case['khmer_mask']] + flags
    want, got = str(tmp_path / 'jax.ct'), str(tmp_path / 'port.ct')
    jax_cli.main(argv + [want, novel_case['proband.fq']])
    cli.main(argv + ['--device', 'cpu', got, novel_case['proband.fq']])
    assert _read(got, 'rb') == _read(want, 'rb')
    assert _read(want, 'rb')[:4] == b'OXLI'
    # and the table loads, through the in-process cache and from the file
    from kevlar_tpu_torch import oxli, sketch
    assert isinstance(sketch.load(got, device='cpu'), oxli.OxliSketch)
    assert isinstance(sketch.load(got, device='cpu', cache=False),
                      oxli.OxliSketch)


def test_khmer_format_refuses_a_native_mask(novel_case, tmp_path):
    from kevlar_tpu_torch import count, sketch
    mask = sketch.load(novel_case['mask'], device='cpu')
    with pytest.raises(ValueError, match='khmer-format mask'):
        count.load_sample_seqfile([novel_case['mother.fq']], KSIZE, 8e4,
                                  mask=mask, sketch_format='khmer',
                                  device='cpu')


# -- faults of the earlier slices -------------------------------------------

@pytest.mark.parametrize('argv', [
    ['count', '--shards', '2', 'out.ct', 'reads.fq'],
    ['novel', '--shards', '2', '--case', 'reads.fq'],
    ['alac', '--shards', '2', 'reads.augfastq', 'refr.fa'],
    ['call', '--shards', '2', 'contigs.fa', 'targets.fa']],
    ids=lambda argv: argv[0])
def test_shards_is_refused_by_name(argv, capsys, monkeypatch):
    """``--shards S`` is taken as ``kevlar_tpu`` takes it (with ``--device
    cpu`` too), and a shard count the devices cannot fill is refused by
    both with the mesh's error before any work: 3 on 2 cards here, on 8
    virtual devices there."""
    import torch
    want = jax_cli.parser().parse_args(argv)
    got = cli.parser().parse_args(argv[:1] + ['--device', 'cpu'] + argv[1:])
    assert got.shards == want.shards == 2
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    three = [arg if arg != '2' else '3' for arg in argv]
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as exit_info:
            main(three)
        assert exit_info.value.code == 1
        err = capsys.readouterr().err
        assert 'cannot build a' in err and 'mesh from' in err, err


def test_run_mark1_takes_a_logstream_like_jax():
    from kevlar_tpu import workflow as jax_workflow
    from kevlar_tpu_torch import workflow
    want = inspect.signature(jax_workflow.run_mark1).parameters
    got = inspect.signature(workflow.run_mark1).parameters
    assert list(got) == list(want) == ['config', 'logstream']
    assert got['logstream'].default is None
    # the argument is taken before anything runs: what fails is the
    # config's missing reference, in both
    for run in (workflow.run_mark1, jax_workflow.run_mark1):
        with pytest.raises(KeyError, match='reference'):
            run({'shards': 2}, logstream=io.StringIO())


def test_banded_view_load_takes_a_backend_like_jax(novel_case, tmp_path):
    from kevlar_tpu import sketch as jax_sketch
    from kevlar_tpu_torch import sketch
    files = []
    for band in ('1', '2'):
        files.append(str(tmp_path / 'band{}.ct'.format(band)))
        cli.main(['count', '-k', str(KSIZE), '-M', '200K', '--max-fpr',
                  '1.0', '--num-bands', '2', '--band', band, '--device',
                  'cpu', files[-1], novel_case['mother.fq']])
    want = jax_sketch.BandedSketchView.load(files, backend='host')
    seq = kevlar_tpu.seqio.parse_seq_dict(
        open(novel_case['refr']))['chr1'][500:700]
    for view in (sketch.BandedSketchView.load(files, backend='host'),
                 sketch.BandedSketchView.load(files),
                 sketch.BandedSketchView.load(files, backend='device',
                                              device='cpu')):
        assert view.get_kmer_counts(seq) == want.get_kmer_counts(seq)
        assert view.get(seq[:KSIZE]) == want.get(seq[:KSIZE])
    assert max(want.get_kmer_counts(seq)) > 5


def test_profile_flag_writes_a_chrome_trace(stages, tmp_path):
    tracedir = str(tmp_path / 'trace')
    cli.main(['--profile', tracedir, 'split', stages[1], '2',
              str(tmp_path / 'shard')])
    with open(os.path.join(tracedir, 'split.trace.json')) as fh:
        trace = json.load(fh)
    assert trace['traceEvents']
    assert os.path.exists(str(tmp_path / 'shard.1.augfastx'))


def test_mutable_string_matches_jax():
    from kevlar_tpu.support import MutableString as Want
    from kevlar_tpu_torch.support import MutableString as Got
    out = []
    for cls in (Want, Got):
        s = cls('ACGTACGTAC')
        s[2] = 'T'
        s[4:6] = 'GGGG'
        del s[0]
        del s[3:5]
        s += 'TTA'
        t = s + 'CC'
        out.append((str(s), str(t), len(t), s[1], s[2:5], 'GGT' in t,
                    s == str(s), repr(cls(s))))
    assert out[0] == out[1]
    assert out[0][0] == 'CTTGGGTACTTA'


def test_evaluate_compact_matches_jax():
    from kevlar_tpu import evaluate as jax_evaluate, vcf as jax_vcf
    from kevlar_tpu_torch import evaluate, vcf
    bed = 'chr1\t100\t101\nchr1\t500\t520\n# note\nchr2\t40\t41\n'
    rows = [('chr1', 104, 'A', 'C', 'PASS', 'c1', '50.0'),
            ('chr1', 300, 'A', 'G', 'PASS', 'c1', '70.0'),
            ('chr1', 900, 'T', 'G', 'PASS', 'c2', '30.0'),
            ('chr1', 905, 'T', 'A', 'PASS', 'c2', '20.0'),
            ('chr2', 40, 'G', 'GTT', 'PASS', None, '10.0'),
            ('chr2', 45, 'G', 'C', 'PASS', None, '-3.0'),
            ('chr1', 510, 'C', 'T', 'Homopolymer', 'c3', '90.0')]
    out = []
    for ev, v in ((jax_evaluate, jax_vcf), (evaluate, vcf)):
        index = ev.populate_index_from_bed(io.StringIO(bed))
        calls = []
        for seqid, pos, ref, alt, filt, cls, score in rows:
            call = v.Variant(seqid, pos, ref, alt, LIKESCORE=score)
            if cls:
                call.annotate('CALLCLASS', cls)
            if filt != 'PASS':
                call.filter(v.VariantFilter.Homopolymer)
            calls.append(call)
        out.append([(c.seqid, c.position, c.attribute('EVAL'))
                    for c in ev.compact(calls, index, delta=10)])
    assert out[0] == out[1]
    assert out[0] == [('chr1', 104, 'True'), ('chr1', 900, 'False'),
                      ('chr2', 40, None)]
