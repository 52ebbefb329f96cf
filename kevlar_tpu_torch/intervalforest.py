"""Labeled interval index (per-chromosome) with slop-extended queries.

Port of ``kevlar_tpu.intervalforest`` (a copy).  Replaces the
reference's `intervaltree` dependency (contract:
kevlar/intervalforest.py:14-68) with a build-once/query-many structure:
per label, intervals sorted by start with a running max-end array, so a
stabbing/overlap query is one bisect plus a bounded backward sweep.
Intervals are half-open; a point query returns the intervals containing
the point; a range query returns the intervals overlapping [start, end).
"""

from bisect import bisect_right
from collections import defaultdict


class Interval:
    __slots__ = ('begin', 'end', 'data')

    def __init__(self, begin, end, data=None):
        self.begin = begin
        self.end = end
        self.data = data

    def __eq__(self, other):
        return (self.begin, self.end, id(self.data)) == \
            (other.begin, other.end, id(other.data))

    def __hash__(self):
        return hash((self.begin, self.end, id(self.data)))

    def __repr__(self):
        return 'Interval({}, {}, {!r})'.format(self.begin, self.end,
                                               self.data)


class _SweepIndex:
    """Intervals under one label: sorted starts + running max of ends."""

    def __init__(self):
        self.intervals = []
        self._starts = None

    def add(self, interval):
        self.intervals.append(interval)
        self._starts = None

    def _build(self):
        self.intervals.sort(key=lambda iv: iv.begin)
        self._starts = [iv.begin for iv in self.intervals]
        self._reach = []
        furthest = float('-inf')
        for iv in self.intervals:
            furthest = max(furthest, iv.end)
            self._reach.append(furthest)

    def overlapping(self, start, end):
        """All intervals overlapping [start, end), end > start."""
        if self._starts is None:
            self._build()
        found = set()
        idx = bisect_right(self._starts, end - 1) - 1
        while idx >= 0 and self._reach[idx] > start:
            if self.intervals[idx].end > start:
                found.add(self.intervals[idx])
            idx -= 1
        return found

    def __len__(self):
        return len(self.intervals)

    def __iter__(self):
        return iter(self.intervals)


class IntervalForest:
    """Single point of access for a labeled set of interval indexes.

    >>> forest = IntervalForest()
    >>> forest.insert('chr17', 238026, 238046)
    >>> forest.insert('chr17', 1533596, 1533597, 'C->A')
    >>> sorted(iv.data for iv in forest.query('chr17', 1533500, 1533700))
    ['C->A']
    >>> forest.query('chr17', 238006)
    set()
    >>> sorted(iv.data for iv in forest.query('chr17', 238006, delta=30))
    ['chr17:238026-238046']
    >>> forest.query('chr4', 1533500, 1533700)
    set()
    """

    def __init__(self):
        self.trees = defaultdict(_SweepIndex)

    def __len__(self):
        return sum(len(index) for index in self.trees.values())

    def __iter__(self):
        for index in self.trees.values():
            for interval in index:
                yield interval.data

    def insert(self, label, start, end, data=None):
        assert label is not None
        payload = data
        if payload is None:
            payload = '{:s}:{:d}-{:d}'.format(label, start, end)
        self.trees[label].add(Interval(start, end, payload))

    def query(self, label, start, end=None, delta=0):
        if label not in self.trees:
            return set()
        lo, hi = start, end
        if delta > 0:
            hi = (hi + delta) if hi else (lo + delta)
            lo -= delta
        if hi is None:
            hi = lo + 1  # stab: intervals containing the point
        return self.trees[label].overlapping(lo, hi)
