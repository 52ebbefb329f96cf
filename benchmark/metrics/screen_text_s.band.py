"""``screen_text_s.band``: ``screen_text_s`` in the cells whose step counts
and screens in hash bands."""

from benchmark.metrics.screen_text_s import read  # noqa: F401
