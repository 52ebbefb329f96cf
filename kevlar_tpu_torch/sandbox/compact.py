"""Compact a VCF against known reference calls in BED format.

Loads the BED regions into an interval forest, matches each prediction by
CALLCLASS, and keeps the best call per matched class — the same
evaluation-compaction the ``evaluate`` module provides, exposed as a
stream tool (behavior spec: reference kevlar/sandbox/compact.py).
"""

import argparse
import sys

import kevlar_tpu_torch
from kevlar_tpu_torch import evaluate, vcf


def main(argv=None):
    cli = argparse.ArgumentParser(prog='kevlar-tpu-torch-compact')
    cli.add_argument('-d', '--delta', metavar='D', type=int, default=10,
                     help='support approximate matches by extending each '
                          'query by D bp each direction')
    cli.add_argument('reference',
                     help='location of reference calls in BED format')
    cli.add_argument('vcf', help='variant predictions in VCF format')
    args = cli.parse_args(argv)

    with kevlar_tpu_torch.open(args.reference, 'r') as bedstream:
        index = evaluate.populate_index_from_bed(bedstream)

    vcfstream = kevlar_tpu_torch.open(args.vcf, 'r')
    reader = vcf.VCFReader(vcfstream)
    calls = list(reader)

    writer = vcf.VCFWriter(sys.stdout, source='kevlar::sandbox::compact')
    writer.register_samples_from_reader(reader)
    writer.write_header()
    for varcall in evaluate.compact(calls, index, delta=args.delta):
        writer.write(varcall)


if __name__ == '__main__':
    main()
