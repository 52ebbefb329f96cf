"""Rooflines of the port's kernels, from the work their inputs need.

A kernel's share of its roofline is the least time the card could take
for the work of its launches, over the time the launches took on the
device: the larger of the bytes over the card's published memory rate and
the operations over its published operation rate.  The bytes and the
operations are worked out from the inputs, never from how a kernel goes
about them: each input byte is read once and each output byte written
once, and a random access counts the bytes it needs, never the 32-byte
sector the memory moves.  So the share stays below 100% for any kernel
that does the same work.

``KERNELS`` holds, for each kernel, the part of its name the device trace
shows, the stage whose launches it serves and the function that gives one
launch's ``(bytes, operations)`` from that stage's launch statistics (see
:func:`benchmark.harness.Cell.check`).  A kernel another file adds passes
its own entry to :func:`share`.
"""

# Published peaks, by the name the card gives (torch.cuda.get_device_name):
# NVIDIA's data sheet for the H100 SXM, at its 700 W power limit.  Integer
# operations are held to the float32 rate outside the tensor cores, which
# no integer instruction beats on this card, so the operation bound is
# never over-stated.
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bytes_per_s': 3.35e12, 'ops_per_s': 67e12,
                              'power_w': 700.0},
}


def consume_launch(launch):
    """``kt_consume`` counting one batch into its accumulator: the batch's
    base codes read once, and each accumulator bucket that the kept
    k-mers touch read and written once at 4 bytes (or the whole
    accumulator once, where that is less); the operations are a bucket
    index (multiply, add, reduce) and an increment for each kept k-mer in
    each table."""
    touched = min(launch['distinct'], launch['buckets'])
    nbytes = launch['codes_bytes'] + 8 * touched
    ops = 4 * launch['kept'] * launch['ntables']
    return nbytes, ops


def screen_launch(launch):
    """``kt_screen_reads`` screening one read batch: the batch's codes and
    lengths read once, each sample word the predicates need for these
    inputs read once at 4 bytes (one word where a table's case count
    already fails, every table's word otherwise), and the hits written
    once (a 4-byte index and a count a sample), with the hit count and a
    flag a read; the operations are the two hashes of each valid window,
    at 20 integer operations (three Murmur3 finalisers of six operations
    and the choice of strand)."""
    nbytes = (launch['codes_bytes'] + launch['lengths_bytes'] +
              4 * launch['words'] + launch['hits'] * (4 + launch['samples'])
              + 4 + launch['rows'])
    ops = 20 * launch['windows']
    return nbytes, ops


KERNELS = {
    'kt_consume': {'match': 'consume_kernel', 'stage': 'count',
                   'launch': consume_launch},
    'kt_screen_reads': {'match': 'screen_reads_kernel', 'stage': 'screen',
                        'launch': screen_launch},
}


def least_seconds(launches, launch_fn, peak):
    """The least time the card needs for these launches' work."""
    nbytes = ops = 0
    for launch in launches:
        b, o = launch_fn(launch)
        nbytes += b
        ops += o
    return max(nbytes / peak['bytes_per_s'], ops / peak['ops_per_s'])


def share(ctx, name, entry=None):
    """Percent of its roofline that kernel ``name`` reached in the traced
    window, or None where there is nothing to read: no trace, a card not
    in :data:`PEAKS`, no launch of the kernel, or launch statistics that
    do not cover the launches traced."""
    entry = entry or KERNELS[name]
    reduced, stats = ctx.get('trace'), ctx.get('launch_stats')
    peak = PEAKS.get(ctx.get('device_kind'))
    if not reduced or not stats or peak is None:
        return None
    per_step = stats.get(entry['stage'])
    launches = seconds = 0
    for op, (n, sec) in reduced['ops'].items():
        if entry['match'] in op:
            launches += n
            seconds += sec
    if not per_step or not launches or \
            launches != len(per_step) * ctx['steps']:
        return None
    least = least_seconds(per_step, entry['launch'], peak) * ctx['steps']
    return 100.0 * least / seconds
