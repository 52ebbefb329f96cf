"""The port's host modules against their ``kevlar_tpu`` originals.

Tolerance: none.  These modules are copies of integer and string code, so
every output — augmented FASTX text, seed matches, index arrays, contigs,
cutouts, CIGARs and VCF rows — must be identical.
"""

import io
import random
import time

import numpy as np
import pytest

import chip_smoke
import kevlar_tpu
import kevlar_tpu_torch
from kevlar_tpu import assemble as jax_assemble
from kevlar_tpu import dna as jax_dna
from kevlar_tpu import localize as jax_localize
from kevlar_tpu import native as jax_native
from kevlar_tpu import reference as jax_reference
from kevlar_tpu import varmap as jax_varmap
from kevlar_tpu_torch import (
    assemble, dna, localize, native, reference, seqio, varmap)

from . import simdata


@pytest.fixture(autouse=True)
def _reset_port_logstream():
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
def case(tmp_path_factory):
    """A small generated alac input: 12 loci over 120 kb."""
    workdir = tmp_path_factory.mktemp('hostcase')
    refr, reads, truth = chip_smoke.make_alac_case(
        str(workdir), genome_len=120000, nloci=12, seed=5)
    return refr, reads, truth


def _partitions(pkg, path):
    return list(pkg.seqio.parse_partitioned_reads(
        pkg.parse_augmented_fastx(pkg.open(path, 'r'))))


def _afx_text(pkg, records):
    out = io.StringIO()
    for record in records:
        pkg.print_augmented_fastx(record, out)
    return out.getvalue()


def test_augmented_fastx_round_trip(case):
    rng = random.Random(3)
    genome = simdata.make_genome(rng, 400)
    fasta = kevlar_tpu.Record('fa1 kvcc=2', genome[:120])
    fasta.annotate(genome[10:31], 10, (12, 0, 1))
    fasta.annotate(genome[50:71], 50, (9, 2))
    fasta.add_mate(genome[200:300])
    fastq = kevlar_tpu.Record('fq1', genome[100:250], quality='I' * 150)
    fastq.annotate(genome[140:171], 40, (30, 0, 0))
    text = _afx_text(kevlar_tpu, [fasta, fastq])
    with open(case[1]) as fh:
        text += fh.read()

    ported = list(kevlar_tpu_torch.parse_augmented_fastx(io.StringIO(text)))
    assert _afx_text(kevlar_tpu_torch, ported) == text
    back = list(kevlar_tpu.parse_augmented_fastx(
        io.StringIO(_afx_text(kevlar_tpu_torch, ported))))
    assert _afx_text(kevlar_tpu, back) == text
    assert [(r.name, r.sequence, r.quality, r.annotations, r.mates)
            for r in ported] == [(r.name, r.sequence, r.quality,
                                  r.annotations, r.mates) for r in back]
    assert [(p, [r.name for r in reads])
            for p, reads in _partitions(kevlar_tpu_torch, case[1])] == \
        [(p, [r.name for r in reads])
         for p, reads in _partitions(kevlar_tpu, case[1])]


def test_dna_helpers_match():
    rng = np.random.default_rng(9)
    iupac = 'ACGTNRYSWKMBDHVacgtn'
    seqs = [''.join(iupac[k] for k in rng.integers(0, len(iupac), n))
            for n in (0, 1, 17, 64)]
    for s in seqs:
        assert dna.revcom(s) == jax_dna.revcom(s)
        assert dna.revcommin(s) == jax_dna.revcommin(s)
    for mine, theirs in zip(dna.encode_batch(seqs, pad_to=70),
                            jax_dna.encode_batch(seqs, pad_to=70)):
        np.testing.assert_array_equal(mine, theirs)
    bases = rng.integers(0, 5, 9000).astype(np.uint8)    # > 4096: stream
    for arr in (bases, bases[:300].reshape(3, 100)):
        for size in (21, 51, 100):
            for mine, theirs in zip(dna.seed_codes(arr, size),
                                    jax_dna.seed_codes(arr, size)):
                np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize('chunk', [1000, 5000])
def test_seed_index_in_chunks_equals_jax(monkeypatch, chunk):
    """The index built in chunks of seed positions on threads, and sorted
    in eight parts, holds JAX's arrays: repeats (equal keys in index
    order), N runs and a sequence with no valid seed, across chunk edges
    (chunks of 1,000 take the generic packing, of 5,000 the stream)."""
    monkeypatch.setattr(reference, '_INDEX_CHUNK', chunk)
    rng = random.Random(7)
    chr1 = simdata.make_genome(rng, 23000)
    chr1 = (chr1[:4900] + chr1[:700] + 'N' * 40 + chr1[5640:9950] +
            chr1[100:900] + chr1[10750:])
    seqs = {'chr1': chr1, 'chr2': chr1[2000:9000] + 'N' * 3 + chr1[:3000],
            'chr3': 'N' * 80}
    mine = reference.SeedIndex(seqs, 51)
    theirs = jax_reference.SeedIndex(seqs, 51)
    assert np.any(theirs._keys[1:] == theirs._keys[:-1])
    for name in ('_keys', '_seqidx', '_pos'):
        want = getattr(theirs, name)
        got = getattr(mine, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_seed_index_lookup_and_index_files(tmp_path):
    rng = random.Random(21)
    chr1 = simdata.make_genome(rng, 6000)
    chr2 = chr1[1000:1400] + simdata.make_genome(rng, 3000) + 'N' * 60
    seqs = {'chr1': chr1, 'chr2': chr2}
    refr = str(tmp_path / 'refr.fa')
    simdata.write_fasta(seqs, refr)
    seeds = {dna.revcommin(s) for s in
             [chr1[p:p + 51] for p in range(0, 5900, 97)] +
             [chr2[p:p + 51] for p in range(0, 3300, 131)] +
             [simdata.make_genome(rng, 51), 'N' * 51]}

    mine = reference.SeedIndex(seqs, 51)
    theirs = jax_reference.SeedIndex(seqs, 51)
    want = theirs.lookup(seeds)
    assert mine.lookup(seeds) == want
    assert any(len(hits) > 1 for hits in want.values())   # shared segment

    # JAX-written index, read by the port (autoindex picks it up by name)
    jax_reference._index_cache.clear()
    reference._index_cache.clear()
    jax_reference.autoindex(refr, 51)
    path = reference.index_path(refr, 51)
    assert path == jax_reference.index_path(refr, 51)
    loaded = reference.autoindex(refr, 51)
    assert isinstance(loaded._keys, np.memmap)
    assert loaded.lookup(seeds) == want
    # port-written index, read by the JAX package
    mine.save(str(tmp_path / 'port'))
    back = jax_reference.SeedIndex.from_file(str(tmp_path / 'port.npz'),
                                             seqs)
    assert back.lookup(seeds) == want
    for name in ('_keys', '_seqidx', '_pos', '_seqids'):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(theirs, name))
    jax_reference._index_cache.clear()
    reference._index_cache.clear()


def _contigs(pkg, path):
    return [(p, c.name, c.sequence, c.annotations)
            for p, c in pkg.assemble.assemble(_partitions(pkg, path))]


def test_assemble_contigs_match(case):
    mine = _contigs(kevlar_tpu_torch, case[1])
    assert len({p for p, *_ in mine}) == 12
    assert mine == _contigs(kevlar_tpu, case[1])
    reads = _partitions(kevlar_tpu_torch, case[1])[0][1]
    assert list(assemble.greedy_asm(reads)) == \
        list(jax_assemble.greedy_asm(reads))
    noisy = [r.sequence for r in reads]
    noisy[0] = noisy[0][:60] + ('A' if noisy[0][60] != 'A' else 'C') + \
        noisy[0][61:]
    fixed = native.correct(noisy)
    assert fixed == jax_native.correct(noisy)
    assert fixed[0] == reads[0].sequence


def test_localize_cutouts_and_varmap_calls_match(case):
    refr = case[0]
    by_part = {}
    for partid, contig in assemble.assemble(
            _partitions(kevlar_tpu_torch, refr.replace(
                'refr.fa', 'partitioned.augfastq'))):
        by_part.setdefault(partid, []).append(contig)
    parts = sorted(by_part.items())
    mine = list(localize.localize(parts, refr, seedsize=51, delta=50))
    theirs = list(jax_localize.localize(parts, refr, seedsize=51, delta=50))
    assert [(p, c.defline, c.sequence) for p, c in mine] == \
        [(p, c.defline, c.sequence) for p, c in theirs]
    assert len(mine) >= 12

    rows = []
    for partid, cutout in mine:
        for contig in by_part[partid]:
            ported = varmap.VariantMapping(contig, cutout, gapopen=5,
                                           gapextend=1)
            ref = jax_varmap.VariantMapping(contig, cutout, gapopen=5,
                                            gapextend=1)
            assert (ported.score, ported.cigar, ported.strand,
                    ported.vartype) == (ref.score, ref.cigar, ref.strand,
                                        ref.vartype)
            got = [c.vcf for c in ported.call_variants(31)]
            assert got == [c.vcf for c in ref.call_variants(31)]
            rows += got
    assert any('\tPASS\t' in row for row in rows)
    assert seqio.parse_seq_dict(open(refr))['chr1'][:80] == \
        open(refr).read().split('\n')[1]


def _code_of(source):
    """C++ source without its comments or blank lines."""
    import re
    text = re.sub(r'/\*.*?\*/', '', source.decode(), flags=re.S)
    lines = (re.sub(r'//.*$', '', line).rstrip()
             for line in text.splitlines())
    return [line for line in lines if line]


def test_align_source_equals_jax_but_for_comments():
    """The single-pair aligner builds from the port's own copy,
    ``csrc/align.cpp``: ``kevlar_tpu/native/align.cpp`` but for comments,
    into a library of its own name."""
    import os
    here = os.path.dirname(os.path.abspath(native.__file__))
    assert native.ALIGN_SOURCE == os.path.join(here, 'csrc', 'align.cpp')
    with open(os.path.join(os.path.dirname(jax_native.__file__),
                           'align.cpp'), 'rb') as fh:
        original = fh.read()
    with open(native.ALIGN_SOURCE, 'rb') as fh:
        copy = fh.read()
    assert _code_of(copy) == _code_of(original)
    path = native.build_align()
    assert os.path.basename(path) == 'libkevlar_hostalign.so'
    assert os.path.dirname(path) == native.BUILD_DIR


def _public_names(module):
    """Public top-level names an ``ast`` walk finds in ``module``'s source:
    definitions, assignments and imports."""
    import ast
    import inspect
    names = set()
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split('.')[0]
                         for a in node.names)
    return {n for n in names if not n.startswith('_')}


# what ROADMAP A.10 leaves out by design: the ``warm`` stage, and ``os``,
# which kevlar_tpu's top level imports only to set up the XLA compile cache
NOT_PORTED = {'warm', 'os'}


def test_port_resolves_every_public_name_of_kevlar_tpu():
    """Every public top-level name of ``kevlar_tpu`` and every module of its
    ``_STAGE_MODULES`` resolves on ``kevlar_tpu_torch`` (A.10's excepted),
    and the port's stage modules are ``kevlar_tpu_torch``'s own."""
    wanted = (_public_names(kevlar_tpu) |
              set(kevlar_tpu._STAGE_MODULES)) - NOT_PORTED
    assert {'same_seq', 'Timer', 'ProgressIndicator', 'MutableString',
            'parallel', 'workflows'} <= wanted
    missing = sorted(n for n in wanted if not hasattr(kevlar_tpu_torch, n))
    assert not missing
    for name in kevlar_tpu._STAGE_MODULES:
        if name not in NOT_PORTED:
            assert getattr(kevlar_tpu_torch, name).__name__ == \
                'kevlar_tpu_torch.' + name
    assert issubclass(kevlar_tpu_torch.novel.KevlarCaseSampleMismatchError,
                      ValueError)
    for a, b in (('ACGTT', 'AACGT'), ('ACGTT', 'ACGTT'), ('ACG', 'ACC')):
        assert kevlar_tpu_torch.same_seq(a, b) == kevlar_tpu.same_seq(a, b)
        assert dna.same_seq(a, b, jax_dna.revcom(b)) == \
            jax_dna.same_seq(a, b)


@pytest.mark.parametrize('name', ['asm.cpp', 'fastx.cpp'])
def test_native_builds_from_the_ports_own_sources(name):
    """The port compiles its own copies of the C++ sources, byte for byte
    those of ``kevlar_tpu`` but for the reference's source path in a
    comment, named as the port's Python copies name it (a test may read
    kevlar_tpu/, the port may not)."""
    import os
    import re
    source = {'asm.cpp': native.ASM_SOURCE,
              'fastx.cpp': native.FASTX_SOURCE}[name]
    here = os.path.dirname(os.path.abspath(native.__file__))
    assert source == os.path.join(here, 'csrc', name)
    with open(os.path.join(os.path.dirname(jax_native.__file__), name),
              'rb') as fh:
        original = fh.read()
    with open(source, 'rb') as fh:
        copy = fh.read()
    # the original names the reference's checkout by its absolute path
    path = re.compile(rb'\((/\w+/)?reference[ /]kevlar/')
    assert len(path.findall(original)) == 1
    assert path.sub(b'(kevlar/', copy) == path.sub(b'(kevlar/', original)
    assert copy != original and len(copy) < len(original)
