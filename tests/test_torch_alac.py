"""The port's ``alac`` slice against ``kevlar_tpu.alac``.

Tolerance: none — the VCF text must be identical.  The JAX side runs with
``KEVLAR_ALIGN_BACKEND=pallas``, so its alignments go through the Pallas
kernel in interpret mode (and, for buckets above its 512 cap, the XLA
wavefront it delegates to); the port runs with ``device='cpu'``, the plain
PyTorch version of its CUDA kernel.
"""

import io
import os
import random
import subprocess
import sys
import time

import pytest

import chip_smoke
import kevlar_tpu
import kevlar_tpu_torch
from kevlar_tpu import alac as jax_alac
from kevlar_tpu.batch import batches_from_records
from kevlar_tpu.novel import novel
from kevlar_tpu.partition import partition
from kevlar_tpu.sketch import Sketch
from kevlar_tpu_torch import alac

from . import simdata

KSIZE = 21


@pytest.fixture(autouse=True)
def _pallas_backend(monkeypatch):
    monkeypatch.setenv('KEVLAR_ALIGN_BACKEND', 'pallas')
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


@pytest.fixture(scope='module', autouse=True)
def _jax_native_loaded():
    """``kevlar_tpu`` quietly falls back to a pure-Python assembler while
    its native library is missing — or still being compiled by another
    test worker.  Its contigs are only comparable once the library is
    loaded, so wait for it here."""
    from kevlar_tpu import native as jax_native
    deadline = time.time() + 300
    while jax_native.load() is None:
        if time.time() > deadline:
            pytest.fail('kevlar_tpu native library unavailable')
        time.sleep(2)


@pytest.fixture(scope='module')
def mini_trio(tmp_path_factory):
    """The golden mini-trio of tests/test_golden.py, run through the JAX
    package up to ``partition``: (reference FASTA, partitioned reads)."""
    workdir = tmp_path_factory.mktemp('minitrio')
    rng = random.Random(777)
    genome = simdata.make_genome(rng, 4000)
    child, _, _ = simdata.apply_snv(genome, 1000, rng=rng)
    tail = next(b for b in 'ACGT' if b != genome[2999])
    head = next(b for b in 'ACGT' if b != genome[3000] and b != tail)
    child = simdata.apply_insertion(child, 3000, head + 'CATCATC' + tail)
    child_reads = (simdata.tiled_reads(child, 100, 10, 'cA') +
                   simdata.tiled_reads(genome, 100, 10, 'cB'))

    def count(reads):
        ct = Sketch(KSIZE, 1000003, 4, counter_bits=8)
        for b in batches_from_records(iter(reads)):
            ct.consume_batch(b.bases)
        return ct

    case = count(child_reads)
    mom = count(simdata.tiled_reads(genome, 100, 5, 'm'))
    dad = count(simdata.tiled_reads(genome, 100, 5, 'd'))
    refr = str(workdir / 'refr.fa')
    simdata.write_fasta({'chr1': genome}, refr)
    reads = str(workdir / 'partitioned.augfastq')
    novelreads = list(novel(iter(child_reads), [case], [mom, dad],
                            ksize=KSIZE, casemin=6, ctrlmax=0))
    with open(reads, 'w') as out:
        for _, members in partition(iter(novelreads), minabund=2,
                                    maxabund=200):
            for record in members:
                kevlar_tpu.print_augmented_fastx(record, out)
    return refr, reads


@pytest.fixture(scope='module')
def generated(tmp_path_factory):
    """chip_smoke.py's generator at a small size: 20 loci over 200 kb."""
    workdir = tmp_path_factory.mktemp('generated')
    return chip_smoke.make_alac_case(str(workdir), genome_len=200000,
                                     nloci=20, seed=11)


def _vcf_text(pkg, alac_fn, refr, reads, **kw):
    pstream = pkg.seqio.parse_partitioned_reads(
        pkg.parse_augmented_fastx(pkg.open(reads, 'r')))
    out = io.StringIO()
    writer = pkg.vcf.VCFWriter(out, source='kevlar::alac', refr=refr)
    writer.write_header(skipdate=True)
    for call in alac_fn(pstream, refr, **kw):
        writer.write(call)
    return out.getvalue()


def test_alac_matches_jax_on_mini_trio(mini_trio, monkeypatch):
    from kevlar_tpu.ops import align_pallas
    refr, reads = mini_trio
    kw = dict(ksize=KSIZE, seedsize=51, delta=50)
    pallas_calls = []
    batch_fn = align_pallas.align_batch_pallas

    def spy(*args, **kwargs):
        pallas_calls.append(len(args[0]))
        return batch_fn(*args, **kwargs)

    monkeypatch.setattr(align_pallas, 'align_batch_pallas', spy)
    want = _vcf_text(kevlar_tpu, jax_alac.alac, refr, reads, **kw)
    assert pallas_calls    # the JAX side ran the Pallas kernel
    got = _vcf_text(kevlar_tpu_torch, alac.alac, refr, reads, device='cpu',
                    **kw)
    assert got == want
    assert sum(1 for line in got.split('\n')
               if line and not line.startswith('#')) >= 2


def test_alac_cli_matches_jax(mini_trio, tmp_path):
    from kevlar_tpu import cli as jax_cli
    from kevlar_tpu_torch import cli
    refr, reads = mini_trio
    want, got = str(tmp_path / 'jax.vcf'), str(tmp_path / 'port.vcf')
    jax_cli.main(['alac', '-k', str(KSIZE), '-E', '1', '-o', want, reads,
                  refr])
    cli.main(['alac', '-k', str(KSIZE), '-E', '1', '--device', 'cpu', '-o',
              got, reads, refr])
    with open(want) as fh:
        expected = fh.read()
    with open(got) as fh:
        assert fh.read() == expected
    assert '\tPASS\t' in expected


def test_alac_matches_jax_on_generated_case(generated):
    refr, reads, truth = generated
    kw = dict(ksize=31, seedsize=51, delta=50)
    want = _vcf_text(kevlar_tpu, jax_alac.alac, refr, reads, **kw)
    got = _vcf_text(kevlar_tpu_torch, alac.alac, refr, reads, device='cpu',
                    **kw)
    assert got == want
    calls = []
    for line in got.split('\n'):
        f = line.split('\t')
        if line and not line.startswith('#') and f[3] != '.':
            calls.append((int(f[1]) - 1, f[3], f[4], f[6]))
    with open(refr) as fh:
        genome = ''.join(line.strip() for line in fh if line[0] != '>')
    score = chip_smoke.score_calls(genome, calls, truth)
    assert score['total'] == 20
    assert score['recall_pass'] >= chip_smoke.MIN_RECALL


def test_generator_class_mix_and_partitions(generated):
    refr, reads, truth = generated
    counts = chip_smoke._class_counts(1500)
    assert list(counts) == [c[3] for c in chip_smoke.CLASSES]
    assert sorted(t[3] for t in truth) == sorted(
        name for (name, *_), n in zip(chip_smoke.CLASSES,
                                      chip_smoke._class_counts(20))
        for _ in range(n))
    parts = list(kevlar_tpu_torch.seqio.parse_partitioned_reads(
        kevlar_tpu_torch.parse_augmented_fastx(open(reads))))
    assert [p for p, _ in parts] == [str(k) for k in range(1, 21)]
    assert all(r.annotations for _, members in parts for r in members)


def test_port_imports_no_jax():
    code = ('import sys\n'
            'import kevlar_tpu_torch.cli, kevlar_tpu_torch.alac\n'
            'import kevlar_tpu_torch.ops.align_cuda, kevlar_tpu_torch.call\n'
            'import kevlar_tpu_torch.count, kevlar_tpu_torch.novel\n'
            'import kevlar_tpu_torch.ops.kmer_cuda\n'
            'import kevlar_tpu_torch.filter, kevlar_tpu_torch.partition\n'
            'import kevlar_tpu_torch.simlike, kevlar_tpu_torch.workflow\n'
            'import kevlar_tpu_torch.oxli, kevlar_tpu_torch.ops.cc_cuda\n'
            'import kevlar_tpu_torch.varfilter, kevlar_tpu_torch.readgraph\n'
            'import kevlar_tpu_torch.split, kevlar_tpu_torch.unband\n'
            'import kevlar_tpu_torch.augment, kevlar_tpu_torch.assemble\n'
            'import kevlar_tpu_torch.localize, kevlar_tpu_torch.mutate\n'
            'import kevlar_tpu_torch.gentrio, kevlar_tpu_torch.mutsim\n'
            'import kevlar_tpu_torch.evaluate, kevlar_tpu_torch.dist\n'
            'import kevlar_tpu_torch.sketch, kevlar_tpu_torch.support\n'
            'import kevlar_tpu_torch.reference, kevlar_tpu_torch.native\n'
            'import kevlar_tpu_torch.ops.seed_ops\n'
            'import kevlar_tpu_torch.ops.simlike_ops\n'
            'import kevlar_tpu_torch.sandbox.compact\n'
            'import kevlar_tpu_torch.sandbox.get_partitions\n'
            'import kevlar_tpu_torch.sandbox.subsketch\n'
            'import kevlar_tpu_torch.workflows.bam_preproc\n'
            'import kevlar_tpu_torch.cli as c\n'
            'assert len(c.mains()) == len(c.SUBPARSER_FUNCS) == 16\n'
            'for name in c.SUBPARSER_FUNCS:\n'
            '    c.mains()[name]\n'
            'c.parser()\n'
            'from kevlar_tpu_torch import native\n'
            'for src in (native.ASM_SOURCE, native.FASTX_SOURCE):\n'
            '    assert "/kevlar_tpu_torch/csrc/" in src, src\n'
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "kevlar_tpu.")) or m == "kevlar_tpu"]\n'
            'assert not bad, bad\n'
            'print("ok")\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'
