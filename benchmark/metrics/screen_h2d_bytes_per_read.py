"""``screen_h2d_bytes_per_read``: bytes the novel stage ships to the device
a screened read (its ``h2d_bytes`` counter, codes and lengths with the
last batch's padding rows, over its ``reads``, over the window's
passes)."""

from benchmark import program


def read(ctx):
    counts = program.screen_counts()
    if counts is None or not counts[0].get('reads'):
        return None
    return counts[0]['h2d_bytes'] / counts[0]['reads']
