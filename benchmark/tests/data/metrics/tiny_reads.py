"""A metric a test adds as a file of its own: the reads a step carries."""


def read(ctx):
    return ctx.get('reads_per_step')
