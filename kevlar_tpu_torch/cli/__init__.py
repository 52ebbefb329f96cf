"""Command-line interface of the port: the ``alac`` subcommand.

Flag names, defaults and semantics follow ``kevlar_tpu.cli`` (and the
reference's kevlar/cli/alac.py), plus ``--device``.  The other subcommands
arrive with the later slices of the port.
"""

import argparse
import os
import sys

import kevlar_tpu_torch


def _add_score_args(sp):
    sp.add_argument('-A', '--match', type=int, default=1, metavar='A')
    sp.add_argument('-B', '--mismatch', type=int, default=2, metavar='B')
    sp.add_argument('-O', '--open', type=int, default=5, metavar='O')
    sp.add_argument('-E', '--extend', type=int, default=0, metavar='E')


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
    sp.add_argument('-o', '--out', metavar='FILE')
    sp.add_argument('-i', '--min-ikmers', metavar='I', type=int, default=None)
    sp.add_argument('-k', '--ksize', type=int, default=31, metavar='K')
    sp.add_argument('-t', '--threads', type=int, default=1, metavar='T')
    sp.add_argument('--device', default='cuda', metavar='DEV',
                    help='torch device of the contig x cutout alignments: '
                    '"cuda" (default; the CUDA kernel) or "cpu" (its plain '
                    'PyTorch version)')
    sp.add_argument('infile', help='partitioned reads in augmented format')
    sp.add_argument('refr', help='reference genome in Fasta format')


SUBPARSER_FUNCS = {
    'alac': _alac_subparser,
}


def mains():
    import kevlar_tpu_torch as kt
    return {
        'alac': kt.alac.main,
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
