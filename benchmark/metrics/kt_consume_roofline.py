"""``kt_consume_roofline``: ``kt_consume``'s share of its roofline in
the traced window (``benchmark/roofline.py``)."""

from benchmark import roofline


def read(ctx):
    return roofline.share(ctx, 'kt_consume')
