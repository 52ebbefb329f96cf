"""``screen_readback_s.band``: ``screen_readback_s`` in the cells whose step
counts and screens in hash bands."""

from benchmark.metrics.screen_readback_s import read  # noqa: F401
