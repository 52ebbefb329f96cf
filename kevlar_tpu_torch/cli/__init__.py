"""Command-line interface of the port: the 16 subcommands of
``kevlar_tpu.cli`` (the trio workflow itself is ``python -m
kevlar_tpu_torch.workflow``).

Flag names, defaults and semantics follow ``kevlar_tpu.cli`` (and the
reference's kevlar/cli/*.py), plus ``--device`` where a stage touches a
device: the torch device of its kernels (default ``cuda``; ``cpu`` runs
their plain PyTorch versions).  ``--profile DIR`` writes a
``torch.profiler`` chrome trace of the run.  ``--shards S`` spreads
``count``'s and ``novel``'s sketches over S shards and ``call``'s and
``alac``'s alignment batches over S devices of a mesh
(:mod:`kevlar_tpu_torch.parallel`; on ``cuda`` S must divide the card
count, on ``cpu`` the CPU stands in for every mesh device).  ``warm`` has no
counterpart: there is no compile cache to fill, the kernels build once at
first use.
"""

import argparse
import os
import re
import sys

import kevlar_tpu_torch
from kevlar_tpu_torch import support


def memory_setting(value):
    """Parse a memory string like '1e6', '500M', '8G' into bytes (float)."""
    if isinstance(value, (int, float)):
        return float(value)
    value = value.strip()
    match = re.match(r'^([\d.e+]+)\s*([KMGT]?)B?$', value, re.IGNORECASE)
    if not match:
        raise argparse.ArgumentTypeError(
            'cannot parse memory setting "{}"'.format(value))
    number = float(match.group(1))
    suffix = match.group(2).upper()
    multipliers = {'': 1, 'K': 1e3, 'M': 1e6, 'G': 1e9, 'T': 1e12}
    return number * multipliers[suffix]


def _add_threads_arg(sp):
    sp.add_argument('-t', '--threads', type=int, default=1, metavar='T',
                    help='kept for kevlar_tpu\'s command line, which takes '
                    'any number and ignores it')


def _add_shards_arg(sp):
    """``--shards`` of ``call`` and ``alac``."""
    sp.add_argument('--shards', type=int, metavar='S', default=None,
                    help='shard the global contig x cutout alignment batch '
                    'across S devices (the device-parallel analog of the '
                    "reference's N parallel call shard processes)")


def _add_device_arg(sp, what):
    sp.add_argument('--device', default='cuda', metavar='DEV',
                    help='torch device of {}: "cuda" (default; the CUDA '
                    'kernels) or "cpu" (their plain PyTorch versions)'
                    .format(what))


def _count_subparser(subparsers):
    sp = subparsers.add_parser(
        'count', description='Compute k-mer abundances for the provided '
        'sample. Supports k-mer banding.')
    sp.add_argument('-k', '--ksize', type=int, default=31, metavar='K',
                    help='k-mer size; default is 31')
    sp.add_argument('-c', '--counter-size', type=int, choices=(1, 4, 8),
                    metavar='C', default=8, help='bits per counter: 1/4/8')
    sp.add_argument('-M', '--memory', type=memory_setting, default=1e6,
                    metavar='MEM', help='memory for the count table')
    sp.add_argument('--max-fpr', type=float, default=0.2, metavar='FPR')
    sp.add_argument('--mask', metavar='MSK', help='sketch of k-mers to '
                    'ignore when counting')
    sp.add_argument('--count-masked', action='store_true',
                    help='count only k-mers in the mask')
    sp.add_argument('--num-bands', type=int, metavar='N', default=None)
    sp.add_argument('--band', type=int, metavar='I', default=None,
                    help='band between 1 and N (inclusive) to process')
    sp.add_argument('--shards', type=int, metavar='S', default=None,
                    help='hash-shard the count table across S devices of '
                    'the mesh (supersedes banding; remaining devices become '
                    'the data-parallel axis)')
    _add_threads_arg(sp)
    sp.add_argument('--sketch-format', choices=('native', 'khmer'),
                    default='native', help='on-disk sketch format: "native" '
                    '(device-backed, npz) or "khmer" (byte-compatible with '
                    'khmer/reference-kevlar count tables, host engine)')
    _add_device_arg(sp, 'the sketch and the counting kernels')
    sp.add_argument('counttable', type=str, help='output count table file')
    sp.add_argument('seqfile', type=str, nargs='+',
                    help='input Fastq/Fasta files')


def _novel_subparser(subparsers):
    sp = subparsers.add_parser(
        'novel', description='Identify "interesting" (potentially novel) '
        'k-mers and output the corresponding reads.')
    sp.add_argument('--case', metavar='F', nargs='+', required=True,
                    action='append', help='FASTA/FASTQ files for a case '
                    'sample; repeatable')
    sp.add_argument('--case-counts', metavar='F', nargs='+',
                    help='counttable file(s), one per case sample')
    sp.add_argument('--control', metavar='F', nargs='+', action='append',
                    help='FASTA/FASTQ files for a control sample; repeatable')
    sp.add_argument('--control-counts', metavar='F', nargs='+',
                    help='counttable file(s), one per control sample')
    sp.add_argument('-x', '--ctrl-max', metavar='X', type=int, default=1)
    sp.add_argument('-y', '--case-min', metavar='Y', type=int, default=6)
    sp.add_argument('-M', '--memory', default=1e6, type=memory_setting,
                    metavar='MEM')
    sp.add_argument('--max-fpr', type=float, default=0.2, metavar='FPR')
    sp.add_argument('--num-bands', type=int, metavar='N', default=None)
    sp.add_argument('--band', type=int, metavar='I', default=None)
    sp.add_argument('--shards', type=int, metavar='S', default=None,
                    help='hash-shard every sample sketch across S devices '
                    'and run the novel screen over the mesh (supersedes '
                    'banding)')
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('--save-case-counts', metavar='CT', nargs='+')
    sp.add_argument('--save-ctrl-counts', metavar='CT', nargs='+')
    sp.add_argument('-k', '--ksize', type=int, default=31, metavar='K')
    sp.add_argument('--abund-screen', type=int, default=None, metavar='INT')
    _add_threads_arg(sp)
    sp.add_argument('--skip-until', type=str, metavar='ID')
    _add_device_arg(sp, 'the sample sketches and the screen')


def _filter_subparser(subparsers):
    sp = subparsers.add_parser(
        'filter', description='Discard k-mers and reads whose abundances '
        'were inflated during the preliminary k-mer counting stage.')
    sp.add_argument('-M', '--memory', type=memory_setting, default=1e6,
                    metavar='MEM')
    sp.add_argument('--max-fpr', type=float, default=0.01, metavar='FPR')
    sp.add_argument('--mask', metavar='MSK')
    sp.add_argument('-x', '--ctrl-max', metavar='X', type=int, default=1)
    sp.add_argument('-y', '--case-min', metavar='Y', type=int, default=6)
    sp.add_argument('-o', '--out', metavar='FILE')
    _add_device_arg(sp, 'the mask sketch')
    sp.add_argument('augfastq', help='novel reads in augmented Fastq format')


def _augment_subparser(subparsers):
    sp = subparsers.add_parser(
        'augment', description='Transfer interesting k-mer annotations.')
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('augseqs', help='augmented sequence file')
    sp.add_argument('seqs', help='sequences to annotate')


def _assemble_subparser(subparsers):
    sp = subparsers.add_parser(
        'assemble', description='Assemble reads into contigs representing '
        'putative variants')
    sp.add_argument('-p', '--part-id', type=str, metavar='ID')
    sp.add_argument('--max-reads', type=int, metavar='N', default=10000)
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('augfastq', help='annotated reads in augmented format')


def _mutate_subparser(subparsers):
    sp = subparsers.add_parser(
        'mutate', description='Apply a mutation table to a genome.')
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('mutations', help='mutations file')
    sp.add_argument('genome', help='genome to mutate')


def _gentrio_subparser(subparsers):
    sp = subparsers.add_parser(
        'gentrio', description='Simulate a trio with inherited and de novo '
        'variants.')
    sp.add_argument('-i', '--inherited', type=int, metavar='I', default=20)
    sp.add_argument('-d', '--de-novo', type=int, metavar='D', default=10)
    sp.add_argument('--vcf', metavar='FILE')
    sp.add_argument('--prefix', metavar='PFX', default='trio')
    sp.add_argument('--weights', metavar='WT',
                    default='snv=0.8,ins=0.1,del=0.1')
    sp.add_argument('--indel-sizes', metavar='BANDS', default=None,
                    help='comma-separated LO-HI size bands; each indel '
                         'picks a band uniformly, then a size uniformly '
                         'within it (default: uniform 5-350)')
    sp.add_argument('-s', '--seed', metavar='S', default=None, type=int)
    sp.add_argument('genome', help='genome to mutate')


def _partition_subparser(subparsers):
    sp = subparsers.add_parser(
        'partition', description='Group reads by shared interesting k-mers.')
    sp.add_argument('-s', '--strict', action='store_true')
    sp.add_argument('--min-abund', metavar='X', type=int, default=2)
    sp.add_argument('--max-abund', metavar='Y', type=int, default=200)
    sp.add_argument('--no-dedup', dest='dedup', action='store_false',
                    default=True)
    sp.add_argument('--gml', metavar='FILE')
    sp.add_argument('--split', type=str, metavar='OUTPREFIX')
    sp.add_argument('-o', '--out', metavar='FILE')
    _add_device_arg(sp, 'the read-graph components (at or above 200,000 '
                    'read-k-mer pairs)')
    sp.add_argument('infile', help='input reads in augmented format')


def _localize_subparser(subparsers):
    sp = subparsers.add_parser(
        'localize', description='Compute the reference target sequence for '
        'each partition (native exact seed matching; no bwa needed).')
    sp.add_argument('-d', '--delta', type=int, metavar='D', default=50)
    sp.add_argument('-p', '--part-id', type=str, metavar='ID')
    sp.add_argument('-o', '--out', metavar='FILE', default='-')
    sp.add_argument('-z', '--seed-size', type=int, metavar='Z', default=51)
    sp.add_argument('-x', '--max-diff', type=int, metavar='X', default=None)
    sp.add_argument('--include', metavar='REGEX', type=str)
    sp.add_argument('--exclude', metavar='REGEX', type=str)
    _add_device_arg(sp, 'the seed search when KEVLAR_SEED_BACKEND=device '
                    'selects it (else unused: numpy on the host)')
    sp.add_argument('refr', help='reference genome Fasta')
    sp.add_argument('contigs', nargs='+', help='augmented contig files')


def _add_score_args(sp):
    sp.add_argument('-A', '--match', type=int, default=1, metavar='A')
    sp.add_argument('-B', '--mismatch', type=int, default=2, metavar='B')
    sp.add_argument('-O', '--open', type=int, default=5, metavar='O')
    sp.add_argument('-E', '--extend', type=int, default=0, metavar='E')


def _add_mask_args(sp):
    sp.add_argument('--gen-mask', metavar='FILE')
    sp.add_argument('--mask-mem', type=memory_setting, default=1e6,
                    metavar='MEM')
    sp.add_argument('--mask-max-fpr', type=float, default=0.01, metavar='FPR')


def _call_subparser(subparsers):
    sp = subparsers.add_parser(
        'call', description='Align contigs to reference targets and call '
        'variants.')
    _add_score_args(sp)
    _add_mask_args(sp)
    sp.add_argument('-d', '--debug', action='store_true')
    sp.add_argument('--no-homopoly-filter', action='store_true')
    sp.add_argument('--max-target-length', type=int, default=10000,
                    metavar='L')
    sp.add_argument('--refr', metavar='FILE')
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('-k', '--ksize', type=int, default=31, metavar='K')
    _add_shards_arg(sp)
    _add_device_arg(sp, 'the contig x cutout alignments (one batch across '
                    'all partitions)')
    sp.add_argument('queryseq', help='assembled contigs (augmented Fasta)')
    sp.add_argument('targetseq', help='reference target cutouts (Fasta)')


def _alac_subparser(subparsers):
    sp = subparsers.add_parser(
        'alac', description='Assemble, localize, align, call.')
    sp.add_argument('-p', '--part-id', type=str, metavar='ID')
    sp.add_argument('--max-reads', type=int, metavar='N', default=10000)
    sp.add_argument('-z', '--seed-size', type=int, default=51, metavar='Z')
    sp.add_argument('-d', '--delta', type=int, default=50, metavar='D')
    sp.add_argument('-x', '--max-diff', type=int, metavar='X', default=None)
    sp.add_argument('--include', metavar='REGEX', type=str)
    sp.add_argument('--exclude', metavar='REGEX', type=str)
    sp.add_argument('--max-target-length', type=int, default=10000,
                    metavar='L')
    _add_score_args(sp)
    _add_mask_args(sp)
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('-i', '--min-ikmers', metavar='I', type=int, default=None)
    sp.add_argument('-k', '--ksize', type=int, default=31, metavar='K')
    sp.add_argument('-t', '--threads', type=int, default=1, metavar='T')
    _add_shards_arg(sp)
    _add_device_arg(sp, 'the contig x cutout alignments')
    sp.add_argument('infile', help='partitioned reads in augmented format')
    sp.add_argument('refr', help='reference genome in Fasta format')


def _varfilter_subparser(subparsers):
    sp = subparsers.add_parser(
        'varfilter', description='Filter out calls overlapping the given '
        'BED regions.')
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('filt', help='BED file containing regions to filter out')
    sp.add_argument('vcf', nargs='+', help='VCF file(s) with calls to filter')


def _simlike_subparser(subparsers):
    sp = subparsers.add_parser(
        'simlike', description='Sort variant calls by likelihood score.')
    sp.add_argument('--case', metavar='CT', required=True,
                    help='k-mer counttable for case/proband')
    sp.add_argument('--controls', nargs='+', metavar='CT', required=True,
                    help='k-mer counttables for controls/parents')
    sp.add_argument('--refr', metavar='REFR', required=True,
                    help='k-mer smallcounttable for reference genome')
    sp.add_argument('--ctrl-max', metavar='X', type=int, default=1)
    sp.add_argument('--case-min', metavar='Y', type=int, default=6)
    sp.add_argument('--mu', metavar='M', type=float, default=30.0)
    sp.add_argument('--sigma', metavar='S', type=float, default=8.0)
    sp.add_argument('--epsilon', metavar='E', type=float, default=0.001)
    sp.add_argument('--ctrl-abund-high', metavar='H', type=int, default=4)
    sp.add_argument('--case-abund-low', metavar='L', type=int, default=5)
    sp.add_argument('--case-abund-gate', metavar='G', type=float,
                    default=300.0,
                    help='rescind sole CaseAbundance/Homopolymer filters '
                         'when LIKESCORE exceeds G (the likelihood verdict '
                         'overrides the heuristics); 0 restores '
                         'reference semantics [300.0]')
    sp.add_argument('--shared-kmer-min', metavar='S', type=int,
                    default=None,
                    help='mask ALT-window k-mers with abundance >= S in '
                         'EVERY control (family background cannot carry '
                         'de novo evidence; only a minority of the window '
                         'may be masked); 0 disables [case-min]')
    sp.add_argument('--min-like-score', metavar='S', type=float, default=0.0)
    sp.add_argument('--drop-outliers', action='store_true')
    sp.add_argument('--ambig-thresh', metavar='A', type=int, default=10)
    sp.add_argument('--sample-labels', metavar='LBL', type=str, nargs='+')
    sp.add_argument('-f', '--fast-mode', action='store_true')
    sp.add_argument('-o', '--out', metavar='OUT', default='-')
    _add_device_arg(sp, 'the count tables and the scoring when '
                    'KEVLAR_SIMLIKE_BATCH=1 or KEVLAR_SIMLIKE_DEVICE=1 '
                    'selects them (else unused: host memory maps)')
    sp.add_argument('vcf', nargs='+')


def _split_subparser(subparsers):
    sp = subparsers.add_parser(
        'split', description='Split partitions across N output files.')
    sp.add_argument('infile', help='partitioned reads (augmented format)')
    sp.add_argument('numfiles', type=int, help='number of output files')
    sp.add_argument('base', help='prefix of all output files')


def _dist_subparser(subparsers):
    sp = subparsers.add_parser(
        'dist', description='Abundance distribution of masked k-mers.')
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('-k', '--ksize', metavar='K', type=int, default=31)
    sp.add_argument('-M', '--memory', type=memory_setting, default=1e6,
                    metavar='MEM')
    sp.add_argument('-t', '--threads', type=int, metavar='T', default=1)
    sp.add_argument('-p', '--plot', metavar='PNG')
    sp.add_argument('--tsv', metavar='TSV')
    sp.add_argument('--plot-xlim', metavar=('MIN', 'MAX'), type=int, nargs=2,
                    default=(0, 100))
    _add_device_arg(sp, 'the mask, the counts and the tracking sketch of '
                    'both passes')
    sp.add_argument('mask', help='nodetable containing target k-mers')
    sp.add_argument('infiles', nargs='+', help='input Fastq/Fasta files')


def _unband_subparser(subparsers):
    sp = subparsers.add_parser(
        'unband', description='Merge per-band novel outputs.')
    sp.add_argument('-n', '--n-batches', metavar='N', type=int, default=16)
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('infile', nargs='+',
                    help='input files in augmented format')


SUBPARSER_FUNCS = {
    'count': _count_subparser,
    'novel': _novel_subparser,
    'filter': _filter_subparser,
    'augment': _augment_subparser,
    'assemble': _assemble_subparser,
    'mutate': _mutate_subparser,
    'gentrio': _gentrio_subparser,
    'partition': _partition_subparser,
    'localize': _localize_subparser,
    'call': _call_subparser,
    'alac': _alac_subparser,
    'varfilter': _varfilter_subparser,
    'simlike': _simlike_subparser,
    'split': _split_subparser,
    'dist': _dist_subparser,
    'unband': _unband_subparser,
}


def mains():
    import kevlar_tpu_torch as kt
    return {
        'count': kt.count.main,
        'novel': kt.novel.main,
        'filter': kt.filter.main,
        'augment': kt.augment.main,
        'assemble': kt.assemble.main,
        'mutate': kt.mutate.main,
        'gentrio': kt.gentrio.main,
        'partition': kt.partition.main,
        'localize': kt.localize.main,
        'call': kt.call.main,
        'alac': kt.alac.main,
        'varfilter': kt.varfilter.main,
        'simlike': kt.simlike.main,
        'split': kt.split.main,
        'dist': kt.dist.main,
        'unband': kt.unband.main,
    }


def parser():
    bubbletext = ('kevlar-tpu-torch: reference-free variant discovery, '
                  'PyTorch + CUDA')
    subcommandstr = '", "'.join(sorted(SUBPARSER_FUNCS.keys()))
    p = argparse.ArgumentParser(
        description=bubbletext,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p._positionals.title = 'Subcommands'
    p._optionals.title = 'Global arguments'
    p.add_argument('-v', '--version', action='version',
                   version='kevlar-tpu-torch v{}'.format(
                       kevlar_tpu_torch.__version__))
    p.add_argument('-l', '--logfile', metavar='F',
                   help='log file for diagnostic messages')
    p.add_argument('--tee', action='store_true',
                   help='write diagnostics to logfile AND terminal (stderr)')
    p.add_argument('--profile', metavar='DIR', default=None,
                   help='capture a torch.profiler trace of this run into '
                   'DIR/<cmd>.trace.json (chrome trace format)')
    subparsers = p.add_subparsers(dest='cmd', metavar='cmd',
                                  help='"' + subcommandstr + '"')
    for func in SUBPARSER_FUNCS.values():
        func(subparsers)
    return p


def parse_args(arglist=None):
    args = parser().parse_args(arglist)
    kevlar_tpu_torch.logstream = sys.stderr
    if args.logfile and args.logfile != '-':
        kevlar_tpu_torch.logstream = kevlar_tpu_torch.open(args.logfile, 'w')
    kevlar_tpu_torch.teelog = args.tee
    return args


def main(arglist=None):
    args = parse_args(arglist)
    if args.cmd is None:
        parser().parse_args(['-h'])
        return
    tracer = None
    if args.profile:
        import torch
        tracer = support.start_profile(args.profile,
                                       torch.cuda.is_available())
        kevlar_tpu_torch.plog('[kevlar] profiler trace ->', args.profile)
    try:
        mains()[args.cmd](args)
    except BrokenPipeError:
        sys.exit(0)
    except (ValueError, OSError) as err:
        # friendly one-line error instead of a traceback; set KEVLAR_DEBUG
        # for the full stack
        if os.environ.get('KEVLAR_DEBUG'):
            raise
        print('[kevlar::{}] error: {}'.format(args.cmd, err),
              file=sys.stderr)
        sys.exit(1)
    finally:
        if tracer is not None:
            support.stop_profile(tracer, os.path.join(
                args.profile, args.cmd + '.trace.json'))
