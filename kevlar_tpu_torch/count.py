"""``count`` stage: stream reads into a Count-Min sketch on one device.

Port of ``kevlar_tpu.count`` (reference kevlar/count.py): per-sample k-mer
counting with an optional mask (skip masked k-mers, or count *only* masked
k-mers), optional hash-space banding, khmer-style memory->tablesize sizing,
the FPR bailout, and extension-typed sketch files.

A producer thread parses the input with the C++ reader, packs each batch
into the 2-bit wire format and copies it to the device, one batch ahead
of the consume, which runs on the calling thread: hash (K1), band and mask
predicates (mask counts by K2), per-table bucket indices, scatter-add into
the consume's int32 accumulator (K3).  The accumulator saturates and packs
into the sketch's tables once, when the call ends.
"""

import queue
import threading

import torch

import kevlar_tpu_torch
from kevlar_tpu_torch.batch import native_base_batches, pack_bases
from kevlar_tpu_torch.ops import sketch_ops
from kevlar_tpu_torch.sketch import (
    allocate_from_memory, estimate_fpr, get_extension, register_saved,
    KevlarUnsuitableFPRError,
)
from kevlar_tpu_torch.support import Timer

# Reads per consume launch: the 8 batches of 4,096 reads that kevlar_tpu
# stacks into one device dispatch.
COUNT_BATCH_READS = 32768


def consume_seqfile(sketch, seqfiles, mask=None, consume_masked=False,
                    maskmaxabund=0, numbands=None, band=None,
                    batch_size=COUNT_BATCH_READS):
    """Count all k-mers in the given FASTA/FASTQ files into ``sketch``, on
    the sketch's device; returns the number of reads (genome records count
    once per ``batch`` row they chunk into, as in ``kevlar_tpu``).

    ``mask`` is a sketch on the same device.  ``band`` is 0-based.  Records
    longer than 1,024 bases chunk into rows overlapping by k-1 bases, so no
    k-mer is lost or counted twice.
    """
    device = sketch.device
    if mask is not None and getattr(mask, 'backend', None) != 'device':
        raise ValueError('the mask must be a device sketch of this '
                         'package (khmer-format masks are not supported '
                         'by the port\'s count)')
    if mask is not None and mask.device != device:
        raise ValueError('mask is on {}, sketch on {}'.format(mask.device,
                                                              device))
    wing = sketch.ksize() - 1
    threshold = 1 if consume_masked else maskmaxabund
    maskspec = mask.table_spec() if mask is not None else None
    q = queue.Queue(maxsize=2)
    producer_error = []
    stop = threading.Event()

    def produce():
        try:
            for seqfile in seqfiles:
                for bases, lengths in native_base_batches(
                        seqfile, batch_size, overlap=wing):
                    if stop.is_set():
                        return
                    packed, badmask = pack_bases(bases)
                    q.put((torch.from_numpy(packed).to(device),
                           torch.from_numpy(badmask).to(device),
                           bases.shape[1], len(lengths)))
        except BaseException as exc:  # surfaced on the calling thread
            producer_error.append(exc)
        finally:
            q.put(None)

    acc = sketch_ops.Accumulator(sketch.tables, sketch.counter_bits,
                                 sketch.tablesize)
    thread = threading.Thread(target=produce, name='kevlar-count-producer',
                              daemon=True)
    thread.start()
    numreads = 0
    try:
        while True:
            item = q.get()
            if item is None:
                break
            packed, badmask, L, nreads = item
            sketch_ops.consume_packed(
                acc, packed, badmask, L, sketch.ksize(), numbands=numbands,
                band=band, mask=maskspec, mask_threshold=threshold,
                consume_masked=consume_masked)
            numreads += nreads
    finally:
        # on an error here, unblock the producer and let it end
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()
    if producer_error:
        raise producer_error[0]
    sketch.tables = acc.tables()
    sketch._invalidate()
    return numreads


def load_sample_seqfile(seqfiles, ksize, memory, maxfpr=0.2, count=True,
                        smallcount=False, mask=None, maskmaxabund=0,
                        consume_masked=False, numbands=None, band=None,
                        outfile=None, batch_size=COUNT_BATCH_READS,
                        device='cuda', save_async=False):
    """Compute k-mer abundances for one sample on ``device``; returns the
    sketch (saved to ``outfile`` when given).

    With ``save_async`` the save runs on a background thread, off the
    critical path (the tables are not written to again); callers join
    ``sketch._save_thread`` before relying on the file, and
    :func:`kevlar_tpu_torch.sketch.load` of that file joins it itself."""
    counter_bits = (4 if smallcount else 8) if count else 1
    sketch = allocate_from_memory(ksize, memory, num_tables=4,
                                  counter_bits=counter_bits, device=device)
    numreads = 0
    for seqfile in seqfiles:
        kevlar_tpu_torch.plog('[kevlar::count] - processing "{}"'.format(
            seqfile))
        numreads += consume_seqfile(
            sketch, [seqfile], mask=mask, consume_masked=consume_masked,
            maskmaxabund=maskmaxabund, numbands=numbands, band=band,
            batch_size=batch_size)

    message = 'Done loading k-mers'
    if numbands:
        message += ' (band {:d}/{:d})'.format(band + 1, numbands)
    fpr = estimate_fpr(sketch)
    message += ';\n    {:d} reads processed'.format(numreads)
    message += ', ~{:d} distinct k-mers stored'.format(
        sketch.n_unique_kmers())
    message += ';\n    estimated false positive rate is {:1.3f}'.format(fpr)
    if fpr > maxfpr:
        message += ' (FPR too high, bailing out!!!)'
        raise KevlarUnsuitableFPRError('[kevlar::count] ' + message)

    if outfile:
        extensions = get_extension(count=count, smallcount=smallcount)
        if not outfile.endswith(extensions):
            outfile += extensions[1]
        if save_async:
            import threading
            thread = threading.Thread(target=sketch.save, args=(outfile,),
                                      name='kevlar-save')
            thread.start()
            sketch._save_thread = thread
        else:
            sketch.save(outfile)
        register_saved(outfile, sketch)
        message += ';\n    saved to "{:s}"'.format(outfile)
    kevlar_tpu_torch.plog('[kevlar::count]', message)
    return sketch


def print_config(args):
    tabletypes = {1: 'node', 4: 'small count', 8: 'count'}
    maxcounts = {1: 1, 4: 15, 8: 255}
    message = 'Storing k-mers in a {} table'.format(
        tabletypes[args.counter_size])
    if args.counter_size == 1:
        message += ' (Bloom filter) for k-mer presence/absence queries'
    else:
        message += ', a CountMin sketch with a counter size of {} bits'.format(
            args.counter_size)
        message += ', for k-mer abundance queries (max abundance {})'.format(
            maxcounts[args.counter_size])
    kevlar_tpu_torch.plog('[kevlar::count]', message)


def main(args):
    if (args.num_bands is None) is not (args.band is None):
        raise ValueError('Must specify --num-bands and --band together')
    myband = args.band - 1 if args.band else None
    mask = None
    if args.mask:
        from kevlar_tpu_torch import sketch as sketch_mod
        mask = sketch_mod.load(args.mask, device=args.device)
    print_config(args)

    timer = Timer()
    timer.start()
    docount = args.counter_size > 1
    dosmallcount = args.counter_size == 4
    load_sample_seqfile(
        args.seqfile, args.ksize, args.memory, args.max_fpr, count=docount,
        smallcount=dosmallcount, mask=mask,
        consume_masked=args.count_masked, numbands=args.num_bands,
        band=myband, outfile=args.counttable, device=args.device)
    if torch.device(args.device).type == 'cuda':
        torch.cuda.synchronize(args.device)
    total = timer.stop()
    kevlar_tpu_torch.plog(
        '[kevlar::count] Total time: {:.2f} seconds'.format(total))
