"""``screen_syncs_per_batch``: the host's blocking waits on the device
a screened batch (the novel stage's ``syncs`` counter over its ``batches``,
over the window's passes)."""

from benchmark import program


def read(ctx):
    counts = program.screen_counts()
    if counts is None or not counts[0].get('batches'):
        return None
    return counts[0]['syncs'] / counts[0]['batches']
