"""``kt_screen_reads_roofline``: ``kt_screen_reads``'s share of its
roofline in the traced window (``benchmark/roofline.py``)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, 'kt_screen_reads')
