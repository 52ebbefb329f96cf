"""``screen_stage_s.band``: ``screen_stage_s`` in the cells whose step counts
and screens in hash bands."""

from benchmark.metrics.screen_stage_s import read  # noqa: F401
