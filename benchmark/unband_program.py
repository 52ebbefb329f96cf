"""What the program's ``unband`` recorded inside itself during the window:
each ``unband::pass`` span (``kevlar_tpu_torch.unband``), the seconds of
the ``unband::spill`` and ``unband::merge`` spans under it, and the
counter differences it carries.  A program that records no such span
gives None, so each metric that reads it is left out of the line."""

from benchmark import program


def passes():
    """Each ``unband::pass`` of the window as ``(pass, seconds)``: the
    pass's span and the seconds of the spans under it, summed by name; None
    where the program recorded no pass."""
    records = program.spans()
    if not records:
        return None
    found = {rec.id: (rec, {}) for rec in records
             if rec.name == 'unband::pass'}
    for rec in records:
        if rec.parent in found:
            seconds = found[rec.parent][1]
            seconds[rec.name] = seconds.get(rec.name, 0.0) + \
                (rec.end_ns - rec.start_ns) / 1e9
    return list(found.values()) or None


def seconds(name):
    """Seconds of the spans ``unband::<name>`` in a pass, the mean over the
    window's passes."""
    found = passes()
    if not found:
        return None
    return sum(s.get('unband::' + name, 0.0) for _, s in found) / len(found)


def counts():
    """The counter differences of the window's passes, summed; None
    without a pass that carries them."""
    carried = [rec.counts for rec, _ in passes() or ()
               if rec.counts is not None]
    if not carried:
        return None
    total = {}
    for counts in carried:
        for name, value in counts.items():
            total[name] = total.get(name, 0) + value
    return total
