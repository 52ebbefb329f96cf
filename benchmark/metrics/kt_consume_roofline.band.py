"""``kt_consume_roofline.band``: ``kt_consume_roofline`` in the cells whose
step counts in hash bands."""

from benchmark.metrics.kt_consume_roofline import read  # noqa: F401
