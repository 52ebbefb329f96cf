"""``screen_rescreens.band``: ``screen_rescreens`` in the cells whose step
counts and screens in hash bands."""

from benchmark.metrics.screen_rescreens import read  # noqa: F401
