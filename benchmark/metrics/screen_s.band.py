"""``screen_s.band``: ``screen_s`` in the cells whose step screens in hash
bands (a band's screen)."""

from benchmark.metrics.screen_s import read  # noqa: F401
