"""``screen_launch_s``: seconds a novel pass spends launching its screens
on the host (``novel::screen``), the mean over the window's passes."""

from benchmark import program


def read(ctx):
    return program.screen_seconds('screen')
