"""``device_idle_pct.band``: ``device_idle_pct`` in the cells whose step runs
in hash bands."""

from benchmark.metrics.device_idle_pct import read  # noqa: F401
