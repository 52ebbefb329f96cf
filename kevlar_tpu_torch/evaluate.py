"""Accuracy evaluation: reconcile PASS calls against truth intervals.

Calls sharing a CALLCLASS describe the same candidate event; per class,
keep the call that matches a truth interval (annotated ``EVAL=True``), or
the best-scoring call annotated ``EVAL=False`` when none match. Contract:
reference kevlar/evaluate.py:16-79 (input assumed sorted by LIKESCORE;
output re-sorted, non-positive scores dropped).
"""

import sys

from kevlar_tpu_torch.intervalforest import IntervalForest


def populate_index_from_bed(instream):
    truth = IntervalForest()
    for line in instream:
        row = line.strip()
        if not row or row.startswith('#'):
            continue
        fields = row.split()
        chrom, start, end = fields[0], int(fields[1]), int(fields[2])
        truth.insert(chrom, start, end,
                     '{:s}:{:d}-{:d}'.format(chrom, start, end))
    return truth


def _reconcile_class(callclass, calllist, truth, delta):
    """Pick one call for a CALLCLASS group: the first (= highest-scoring)
    truth match, else the group's best call flagged as a false call."""
    matches = [c for c in calllist
               if truth.query(c.seqid, c.position, delta=delta)]
    if not matches:
        calllist[0].annotate('EVAL', 'False')
        return calllist[0]
    if len(matches) > 1:
        print('WARNING: found', len(matches), 'matches for CALLCLASS',
              callclass, file=sys.stderr)
    matches[0].annotate('EVAL', 'True')
    return matches[0]


def compact(variants, index, delta=10):
    keep = []
    groups = {}
    for call in variants:
        if call.filterstr != 'PASS':
            continue
        callclass = call.attribute('CALLCLASS')
        if callclass is None:
            keep.append(call)
        else:
            groups.setdefault(callclass, []).append(call)
    for callclass, calllist in groups.items():
        keep.append(_reconcile_class(callclass, calllist, index, delta))
    scored = [(float(c.attribute('LIKESCORE')), c) for c in keep]
    scored.sort(key=lambda pair: pair[0], reverse=True)
    return [c for score, c in scored if score > 0.0]
