"""``screen_rescreens``: batches a novel pass screens again, uncapped, for
holding more hits than the capacity (its ``rescreens`` counter), the mean
over the window's passes."""

from benchmark import program


def read(ctx):
    counts = program.screen_counts()
    if counts is None:
        return None
    return counts[0].get('rescreens', 0) / counts[1]
