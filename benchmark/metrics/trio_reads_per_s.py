"""``trio_reads_per_s``: ``reads_per_s`` of a cell whose whole step is too
host-bound for an end-to-end bound: reads of the cell's samples carried
through every stage of a step, each sample's once, times the steps, over
the window's seconds to its last synchronise."""

from benchmark.metrics.reads_per_s import read  # noqa: F401
