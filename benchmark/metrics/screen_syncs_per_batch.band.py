"""``screen_syncs_per_batch.band``: ``screen_syncs_per_batch`` in the cells
whose step counts and screens in hash bands."""

from benchmark.metrics.screen_syncs_per_batch import read  # noqa: F401
