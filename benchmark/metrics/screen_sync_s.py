"""``screen_sync_s``: seconds a novel pass waits for its batches' hit
counts (``novel::sync``) and screens again the batches past the capacity
(``novel::rescreen``), the mean over the window's passes."""

from benchmark import program


def read(ctx):
    return program.screen_seconds('sync', 'rescreen')
