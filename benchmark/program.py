"""What the system under test recorded inside itself during the window:
the spans of ``kevlar_tpu_torch.support`` (recorded while a
``torch.profiler`` trace runs, so in a traced window alone, on the
profiler's clock) and the counter differences its novel passes carry,
reduced to what the per-layer metrics read.  A program that records no
spans (one without the recorder) gives None, so each metric that reads
them is left out of the line."""


def spans():
    """The program's recorded spans (``support.Span``), or None."""
    try:
        from kevlar_tpu_torch import support
    except ImportError:
        return None
    recorded = getattr(support, 'recorded', None)
    return (recorded() or None) if recorded is not None else None


def _covered(intervals):
    """Seconds of the union of ``(start_ns, end_ns)`` intervals."""
    total = 0
    cursor = None
    for start, end in sorted(intervals):
        if cursor is None or start > cursor:
            total += end - start
            cursor = end
        elif end > cursor:
            total += end - cursor
            cursor = end
    return total / 1e9


def screen_passes():
    """Each ``novel::pass`` of the window as ``(pass, seconds, covered)``:
    the pass's span, the seconds of its descendants summed by name, and
    the seconds of the pass that its parts cover (its descendants that hold
    no span: the waits and each batch's stage, screen, ...).  None where
    the program recorded no pass."""
    records = spans()
    if not records:
        return None
    by_id = {rec.id: rec for rec in records}
    parents = {rec.parent for rec in records}
    found = {rec.id: (rec, {}, []) for rec in records
             if rec.name == 'novel::pass'}
    for rec in records:
        up = rec.parent
        while up is not None and up not in found:
            up = by_id[up].parent if up in by_id else None
        if up is None:
            continue
        _, seconds, intervals = found[up]
        seconds[rec.name] = seconds.get(rec.name, 0.0) + \
            (rec.end_ns - rec.start_ns) / 1e9
        if rec.id not in parents:
            intervals.append((rec.start_ns, rec.end_ns))
    return [(rec, seconds, _covered(intervals))
            for rec, seconds, intervals in found.values()] or None


def screen_seconds(*names):
    """Seconds of the spans ``novel::<name>`` for ``names`` in a pass, the
    mean over the window's passes."""
    passes = screen_passes()
    if not passes:
        return None
    return sum(seconds.get('novel::' + name, 0.0) for _, seconds, _ in passes
               for name in names) / len(passes)


def screen_counts():
    """The novel stage's counter differences over the window's passes,
    summed, and the number of passes; None without a pass that carries
    them."""
    passes = [rec for rec, _, _ in screen_passes() or []
              if rec.counts is not None]
    if not passes:
        return None
    total = {}
    for rec in passes:
        for name, value in rec.counts.items():
            total[name] = total.get(name, 0) + value
    return total, len(passes)


def count_pack_seconds():
    """Device seconds of ``count::open`` and ``count::close`` (the int32
    accumulator's unpack; its saturation, cast and pack) a count, the mean
    over the window's counts."""
    records = spans()
    opened = [rec.device_s for rec in records or ()
              if rec.name == 'count::open']
    closed = [rec.device_s for rec in records or ()
              if rec.name == 'count::close']
    if not opened or None in opened + closed:
        return None
    return (sum(opened) + sum(closed)) / len(opened)
