"""``count_pack_s.count``: ``count_pack_s`` in the cells whose step counts
alone."""

from benchmark.metrics.count_pack_s import read  # noqa: F401
