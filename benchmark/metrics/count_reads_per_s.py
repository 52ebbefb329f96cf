"""``count_reads_per_s``: ``reads_per_s`` in the cells whose step counts
alone: reads counted, each sample's once, times the steps, over the
window's seconds to its last synchronise."""

from benchmark.metrics.reads_per_s import read  # noqa: F401
