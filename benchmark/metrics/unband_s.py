"""``unband_s``: the mean host-clock seconds of one step's ``unband`` stage
(``bench::unband``: the case's band outputs parsed, merged by
``kevlar_tpu_torch.unband.unband`` and written) over the window's
steps."""


def read(ctx):
    spans = ctx['spans'].get('unband')
    return sum(spans) / len(spans) if spans else None
