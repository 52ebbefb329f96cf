"""``screen_readback_s``: seconds a novel pass spends copying its hits
back (``novel::readback``), the mean over the window's passes."""

from benchmark import program


def read(ctx):
    return program.screen_seconds('readback')
