"""kevlar_tpu_torch: the PyTorch + CUDA port of kevlar_tpu.

The port runs the trio workflow (:mod:`kevlar_tpu_torch.workflow`) on one
NVIDIA GPU: ``count``, ``novel``, ``filter``, ``partition``, ``alac`` —
assemble, localize, align and call — ``varfilter`` and ``simlike``; and
the other subcommands of ``kevlar_tpu``'s command line
(:mod:`kevlar_tpu_torch.cli`), ``dist`` among them on the GPU.  Their
device work goes through CUDA kernels written for Hopper: k-mer hashing,
the Count-Min gather and scatter (:mod:`kevlar_tpu_torch.ops.kmer_cuda`),
the read-graph components (:mod:`kevlar_tpu_torch.ops.cc_cuda`) and
the contig x cutout ksw2 alignments
(:mod:`kevlar_tpu_torch.ops.align_cuda`); the rest is torch and host code
copied from ``kevlar_tpu`` with its imports rewritten.  It imports
``torch`` and numpy, never ``jax`` and never ``kevlar_tpu``, so it runs on a
machine that has no JAX.  Module names follow ``kevlar_tpu``, so each
counterpart sits at the same path.
"""

import builtins
from gzip import open as gzopen
from os import makedirs
from os.path import dirname
import re
import sys

__version__ = '0.1.0'

logstream = None
teelog = False


def plog(*args, **kwargs):
    """Print logging output to the configured log stream."""
    if logstream is not None:
        print(*args, **kwargs, file=logstream)
    if logstream is None or teelog:
        print(*args, **kwargs, file=sys.stderr)


def open(filename, mode):
    """gz-aware text open; '-'/None mean stdin/stdout."""
    if mode not in ('r', 'w'):
        raise ValueError('invalid mode "{}"'.format(mode))
    if filename in ('-', None):
        return sys.stdin if mode == 'r' else sys.stdout
    if str(filename).endswith('.gz'):
        return gzopen(filename, mode + 't')
    return builtins.open(filename, mode)


def mkdirp(path, trim=False):
    outdir = dirname(path) if trim else path
    makedirs(outdir, exist_ok=True)
    return outdir


def parse_bed(instream):
    """Yield (chrom, start, end, extra-fields) from BED text."""
    for line in instream:
        row = line.strip()
        if not row or row.startswith('#'):
            continue
        chrom, start, end, *extra = re.split(r'\s+', row)
        yield chrom, int(start), int(end), extra


def bedstream(bedfilelist):
    for bedfile in bedfilelist:
        yield from parse_bed(open(bedfile, 'r'))


# Core substrate
from kevlar_tpu_torch.dna import revcom, revcommin  # noqa: E402
from kevlar_tpu_torch.sequence import (  # noqa: E402
    Record, KmerOfInterest, parse_augmented_fastx, print_augmented_fastx,
)
from kevlar_tpu_torch import dna  # noqa: E402
from kevlar_tpu_torch import seqio  # noqa: E402
from kevlar_tpu_torch.seqio import (  # noqa: E402
    parse_partitioned_reads, parse_single_partition,
)

# Pipeline stages, imported lazily via __getattr__ to keep startup light.
_STAGE_MODULES = (
    'count', 'novel', 'filter', 'partition', 'sketch', 'batch', 'support',
    'assemble', 'augment', 'localize', 'reference', 'call', 'varmap',
    'cigar', 'alac', 'varfilter', 'simlike', 'vcf', 'readgraph', 'readpair',
    'intervalforest', 'oxli', 'workflow', 'cli', 'ops', 'native',
    'split', 'unband', 'mutate', 'gentrio', 'mutsim', 'evaluate', 'dist',
)


def __getattr__(name):
    if name in _STAGE_MODULES:
        import importlib
        module = importlib.import_module('kevlar_tpu_torch.' + name)
        globals()[name] = module
        return module
    raise AttributeError('module kevlar_tpu_torch has no attribute ' + name)


def multi_file_iter(filenames):
    from kevlar_tpu_torch.seqio import multi_file_iter as mfi
    return mfi(filenames)


def vcf_header(outstream, version='4.2', source='kevlar', infoheader=False):
    print('##fileformat=VCFv', version, sep='', file=outstream)
    print('##source=', source, sep='', file=outstream)
    if infoheader:
        print('##INFO=<GT,Number=3,Type=String,Description="Genotypes of each '
              'individual in the trio (proband, mother, father)">',
              file=outstream)
    print('##INFO=<VW,Number=1,Type=String,Description="Genomic interval '
          'bounding all k-mers that contain the alternate allele">',
          file=outstream)
    print('##INFO=<RW,Number=1,Type=String,Description="Genomic interval '
          'bounding all k-mers that contain the reference allele">',
          file=outstream)
    print('#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER', 'INFO',
          sep='\t', file=outstream)
