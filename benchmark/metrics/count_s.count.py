"""``count_s.count``: ``count_s`` in the cells whose step counts alone."""

from benchmark.metrics.count_s import read  # noqa: F401
