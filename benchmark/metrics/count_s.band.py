"""``count_s.band``: ``count_s`` in the cells whose step counts and screens in
hash bands."""

from benchmark.metrics.count_s import read  # noqa: F401
