"""``unband_spill_s``: seconds an unband pass spends writing records into
its gzip buckets and closing them (``unband::spill``, summed a pass), the
mean over the window's passes; the record stream's own time (the band
texts' parse) is not in it."""

from benchmark import unband_program


def read(ctx):
    return unband_program.seconds('spill')
