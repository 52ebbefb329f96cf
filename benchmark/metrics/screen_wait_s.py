"""``screen_wait_s``: seconds a novel pass waits for its next batch (the
program's ``novel::wait`` spans, summed over a pass), the mean over the
window's passes."""

from benchmark import program


def read(ctx):
    return program.screen_seconds('wait')
