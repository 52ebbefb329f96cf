"""``kt_consume_roofline.count``: ``kt_consume_roofline`` in the cells
whose step counts alone."""

from benchmark.metrics.kt_consume_roofline import read  # noqa: F401
