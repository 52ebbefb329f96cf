"""``device_idle_pct.count``: ``device_idle_pct`` in the cells whose step
counts alone."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
