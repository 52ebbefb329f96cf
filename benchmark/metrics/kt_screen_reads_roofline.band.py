"""``kt_screen_reads_roofline.band``: ``kt_screen_reads_roofline`` in the
cells whose step screens in hash bands."""

from benchmark.metrics.kt_screen_reads_roofline import read  # noqa: F401
