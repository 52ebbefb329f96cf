"""Extract named partitions from a partitioned augmented-FASTX stream.

Selects the reads labeled with the requested ``kvcc=`` partition IDs and
writes them to one file, stdout, or one file per partition via a
``{}``-placeholder pattern (behavior spec:
reference kevlar/sandbox/get-partitions.py).
"""

import argparse
import sys

import kevlar_tpu_torch
from kevlar_tpu_torch.seqio import parse_partitioned_reads
from kevlar_tpu_torch.sequence import parse_augmented_fastx, print_augmented_fastx


def main(argv=None):
    cli = argparse.ArgumentParser(prog='kevlar-tpu-torch-get-partitions')
    cli.add_argument('-o', '--out', metavar='FILE', help='output filename')
    cli.add_argument('-p', '--out-pattern', metavar='REGEX',
                     help='out file name pattern with a {} placeholder '
                          'for partition ID')
    cli.add_argument('augfastx')
    cli.add_argument('partition', nargs='+')
    args = cli.parse_args(argv)

    if args.out and args.out_pattern:
        raise ValueError('cannot give outfile and outpattern together')
    out = kevlar_tpu_torch.open(args.out, 'w') if args.out else sys.stdout

    partids = set(args.partition)
    with kevlar_tpu_torch.open(args.augfastx, 'r') as fh:
        reader = parse_augmented_fastx(fh)
        for partid, partition in parse_partitioned_reads(reader):
            if partid not in partids:
                continue
            if args.out_pattern:
                outfile = str(args.out_pattern).format(partid)
                with kevlar_tpu_torch.open(outfile, 'w') as pout:
                    for read in partition:
                        print_augmented_fastx(read, pout)
            else:
                for read in partition:
                    print_augmented_fastx(read, out)


if __name__ == '__main__':
    main()
