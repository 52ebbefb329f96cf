"""``screen_sync_s.band``: ``screen_sync_s`` in the cells whose step counts
and screens in hash bands."""

from benchmark.metrics.screen_sync_s import read  # noqa: F401
