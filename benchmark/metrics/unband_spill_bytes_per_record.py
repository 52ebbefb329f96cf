"""``unband_spill_bytes_per_record``: compressed bytes the unband buckets
took a record read in (the ``spilled_bytes`` counter over
``records_in``, over the window's passes)."""

from benchmark import unband_program


def read(ctx):
    counts = unband_program.counts()
    if counts is None or not counts.get('records_in'):
        return None
    return counts['spilled_bytes'] / counts['records_in']
