"""``reads_per_s``: reads of the cell's samples carried through every stage
of a step (each sample's reads once, whatever number of stages read them),
times the steps, over the window's seconds to its last synchronise."""


def read(ctx):
    return ctx['steps'] * ctx['reads_per_step'] / ctx['window_s']
