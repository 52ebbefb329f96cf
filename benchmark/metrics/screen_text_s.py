"""``screen_text_s``: seconds a novel pass spends writing its hits as
augmented-FASTQ text (``novel::text``), the mean over the window's
passes."""

from benchmark import program


def read(ctx):
    return program.screen_seconds('text')
