"""The port's trio workflow (``run_mark1``) against ``kevlar_tpu``'s.

Tolerance: none — on the small trio of ``tests/test_workflow.py`` both
packages must write the same final VCF, bar its ``##fileDate`` line, and
byte-identical ``callmask.nt``.  The port runs with ``device: cpu``: the
plain PyTorch version of every kernel on its path.  Also: the ``profile``
key writes a ``torch.profiler`` trace with one span per stage, and the
``shards`` key is refused.
"""

import gzip
import os
import random
import subprocess
import sys

import pytest

import kevlar_tpu_torch
from kevlar_tpu import workflow as jax_workflow
from kevlar_tpu_torch import workflow

from . import simdata


@pytest.fixture(autouse=True)
def _reset_port_logstream():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


def _trio(tmp_path, seed=31337):
    """tests/test_workflow.py's trio: a 6 kb genome, a het SNV in the
    proband at 2,500, tiled reads.  Returns the config minus outdir."""
    rng = random.Random(seed)
    genome = simdata.make_genome(rng, 6000)
    child, _, _ = simdata.apply_snv(genome, 2500, rng=rng)
    refrfile = str(tmp_path / 'refr.fa')
    simdata.write_fasta({'chr1': genome}, refrfile)
    paths = {}
    for who, reads in (('child', simdata.tiled_reads(child, 100, 10, 'cA') +
                        simdata.tiled_reads(genome, 100, 10, 'cB')),
                       ('mom', simdata.tiled_reads(genome, 100, 5, 'mom')),
                       ('dad', simdata.tiled_reads(genome, 100, 5, 'dad'))):
        paths[who] = str(tmp_path / (who + '.fq'))
        simdata.write_fastq(reads, paths[who])
    return {
        'ksize': 21,
        'reference': {'fasta': refrfile},
        'case': {'fastx': [paths['child']], 'label': 'Kid', 'memory': '8M',
                 'max_fpr': 0.6},
        'controls': [
            {'fastx': [paths['mom']], 'label': 'Mom', 'memory': '8M',
             'max_fpr': 0.5},
            {'fastx': [paths['dad']], 'label': 'Dad', 'memory': '8M',
             'max_fpr': 0.5},
        ],
        'mask': {'memory': '8M', 'max_fpr': 0.9},
        'novel': {'case_min': 6, 'ctrl_max': 1},
        'simlike': {'mu': 10.0, 'sigma': 3.0},
    }


def _vcf_body(path):
    with gzip.open(path, 'rt') as fh:
        return [line for line in fh if not line.startswith('##fileDate')]


def test_run_mark1_matches_jax(tmp_path):
    config = _trio(tmp_path)
    want = jax_workflow.run_mark1(dict(config, outdir=str(tmp_path / 'jax')))
    got = workflow.run_mark1(dict(config, outdir=str(tmp_path / 'port'),
                                  device='cpu'))
    assert _vcf_body(got) == _vcf_body(want)
    passing = [line for line in _vcf_body(got)
               if not line.startswith('#') and '\tPASS\t' in line]
    assert len(passing) == 1 and passing[0].split('\t')[1] == '2501'
    for name in ('callmask.nt', 'calls.prelim.vcf'):
        with open(str(tmp_path / 'jax' / name), 'rb') as fh:
            expected = fh.read()
        with open(str(tmp_path / 'port' / name), 'rb') as fh:
            assert fh.read() == expected, name
    for artifact in ('mask.nt', 'refr.sct', 'case.ct', 'novel.augfastq.gz',
                     'filtered.augfastq.gz', 'partitioned.augfastq.gz',
                     'calls.prelim.vcf', 'calls.scored.sorted.vcf.gz'):
        assert os.path.exists(str(tmp_path / 'port' / artifact))
    stages = dict(workflow.run_mark1.last_stage_times)
    assert list(stages) == [s for s, _ in jax_workflow.run_mark1
                            .last_stage_times]
    assert all(t >= 0 for t in stages.values())


def test_run_mark1_profile_writes_trace(tmp_path):
    config = _trio(tmp_path, seed=404)
    tracedir = str(tmp_path / 'trace')
    workflow.run_mark1(dict(config, outdir=str(tmp_path / 'out'),
                            device='cpu', profile=tracedir))
    tracefile = os.path.join(tracedir, 'workflow.trace.json')
    with open(tracefile) as fh:
        trace = fh.read()
    for stage in ('creating reference mask', 'novel k-mer screen',
                  'partitioning reads', 'scoring calls (simlike)'):
        assert '"workflow::{}"'.format(stage) in trace


def test_run_mark1_refuses_shards(tmp_path):
    with pytest.raises(ValueError, match='shards'):
        workflow.run_mark1({'shards': 4, 'outdir': str(tmp_path),
                            'reference': {'fasta': 'unused.fa'}})


def test_workflow_module_entry_point(tmp_path):
    """``python -m kevlar_tpu_torch.workflow config.json`` runs and refuses
    like ``run_mark1`` (here: an unsupported key, before any work)."""
    config = tmp_path / 'config.json'
    config.write_text('{"shards": 2, "reference": {"fasta": "x.fa"}}')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, '-m', 'kevlar_tpu_torch.workflow', str(config)],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'shards' in proc.stderr
