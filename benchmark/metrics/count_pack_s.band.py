"""``count_pack_s.band``: ``count_pack_s`` in the cells whose step counts and
screens in hash bands."""

from benchmark.metrics.count_pack_s import read  # noqa: F401
