"""``count_pack_s``: device seconds of a count's open and close of its int32
accumulator (the program's ``count::open``, the tables unpacked and
widened; ``count::close``, saturated, cast and packed), the mean over the
window's counts."""

from benchmark import program


def read(ctx):
    return program.count_pack_seconds()
