"""``count_s``: the mean host-clock seconds of one sample's count
(``Sketch.consume_batch_stack`` into a fresh sketch, ended by a
synchronise) over the window's counts."""


def read(ctx):
    spans = ctx['spans'].get('count')
    return sum(spans) / len(spans) if spans else None
