"""``screen_self_s``: seconds of a novel pass (``novel::pass``) that none of
its parts covers (``novel::wait`` and each batch's ``stage``, ``screen``,
``sync``, ``rescreen``, ``readback`` and ``text``): the caller's code
between the yields and the loop's own, between and around the parts, the
mean over the window's passes.  The parts and this add up to the pass."""

from benchmark import program


def read(ctx):
    passes = program.screen_passes()
    if not passes:
        return None
    return sum((rec.end_ns - rec.start_ns) / 1e9 - covered
               for rec, _, covered in passes) / len(passes)
