"""``unband_merge_s``: seconds an unband pass spends reading its buckets
back, parsing them, grouping the records by name and sorting them
(``unband::merge``, one a bucket, summed a pass), the mean over the
window's passes; the caller's time between yields is not in it."""

from benchmark import unband_program


def read(ctx):
    return unband_program.seconds('merge')
