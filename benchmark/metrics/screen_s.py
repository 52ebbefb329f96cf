"""``screen_s``: the mean host-clock seconds of one drained screen pass
(``novel.novel`` over the case's reads) over the window's passes."""


def read(ctx):
    spans = ctx['spans'].get('screen')
    return sum(spans) / len(spans) if spans else None
