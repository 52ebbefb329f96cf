"""``screen_stage_s``: seconds a novel pass spends staging its batches
(``novel::stage``: the copy into the pinned ring, with the wait for a ring
slot's copy, the ship and the lengths' copy), the mean over the window's
passes."""

from benchmark import program


def read(ctx):
    return program.screen_seconds('stage')
