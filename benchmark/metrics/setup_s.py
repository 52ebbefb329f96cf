"""``setup_s``: seconds from the process's start to the window's, on the
host clock: imports, the kernels' build where it is not cached, the
inputs made on the card, set-up stages and one warm-up step."""


def read(ctx):
    return ctx['setup_s']
