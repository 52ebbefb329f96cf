"""``trio_reads_per_s.band``: ``trio_reads_per_s`` in the cells whose step
runs in hash bands (each sample's reads once a step, however many bands
read them)."""

from benchmark.metrics.trio_reads_per_s import read  # noqa: F401
