"""``varfilter`` stage: mark calls that fall inside user-supplied regions.

Port of ``kevlar_tpu.varfilter``.  Calls are indexed once into an interval
forest; each BED region then stamps every overlapping call with the
``UserFilter`` code (contract: kevlar/varfilter.py:13-35). Emission order
is forest iteration order, as in the reference.
"""

import kevlar_tpu_torch
from kevlar_tpu_torch.intervalforest import IntervalForest


def load_predictions(varcalls):
    kevlar_tpu_torch.plog('[kevlar::varfilter] Loading predictions to '
                          'filter')
    forest = IntervalForest()
    for call in varcalls:
        forest.insert(*call.region, data=call)
    return forest


def varfilter(callstream, maskstream):
    from kevlar_tpu_torch.vcf import VariantFilter
    forest = load_predictions(callstream)
    kevlar_tpu_torch.plog('[kevlar::varfilter] Filtering preliminary '
                          'variant calls')
    for chrom, start, end, _extra in maskstream:
        for hit in forest.query(chrom, start, end):
            hit.data.filter(VariantFilter.UserFilter)
    yield from forest


def main(args):
    from kevlar_tpu_torch import vcf
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    try:
        writer = vcf.VCFWriter(outstream, source='kevlar::varfilter')
        writer.write_header()
        calls = vcf.vcfstream(args.vcf)
        regions = kevlar_tpu_torch.parse_bed(
            kevlar_tpu_torch.open(args.filt, 'r'))
        for call in varfilter(calls, regions):
            writer.write(call)
    finally:
        if args.out not in (None, '-'):
            outstream.close()
