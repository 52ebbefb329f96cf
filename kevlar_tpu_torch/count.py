"""``count`` stage: stream reads into a Count-Min sketch on one device.

Port of ``kevlar_tpu.count`` (reference kevlar/count.py): per-sample k-mer
counting with an optional mask (skip masked k-mers, or count *only* masked
k-mers), optional hash-space banding, khmer-style memory->tablesize sizing,
the FPR bailout, and extension-typed sketch files.

A producer thread parses the input with the C++ reader straight into
pinned host memory and copies each batch of base codes (one byte a base)
to the device without blocking, ahead of the consume, which runs on the
calling thread: hash (K1), band and mask
predicates (mask counts by K2), per-table bucket indices, scatter-add into
the consume's int32 accumulator (K3).  The accumulator saturates and packs
into the sketch's tables once, when the call ends.

With a mesh (``--shards``), the sketch is a
:class:`kevlar_tpu_torch.parallel.ShardedSketch`, hash-sharded across the
mesh's 'shard' axis, and each batch goes through its consume (the routed
one, or the replicate one when masked); banding is then unsupported, as
in ``kevlar_tpu``.
"""

import queue
import threading

import torch

import kevlar_tpu_torch
from kevlar_tpu_torch.batch import CodeStager, native_base_batches
from kevlar_tpu_torch.ops import sketch_ops
from kevlar_tpu_torch.parallel import ShardedSketch, make_mesh
from kevlar_tpu_torch.sketch import (
    BUCKETS_PER_BYTE, allocate_from_memory, estimate_fpr, get_extension,
    register_saved, KevlarUnsuitableFPRError,
)
from kevlar_tpu_torch.support import Timer, span

# Reads per consume launch: the 8 batches of 4,096 reads that kevlar_tpu
# stacks into one device dispatch.
COUNT_BATCH_READS = 32768


def consume_seqfile(sketch, seqfiles, mask=None, consume_masked=False,
                    maskmaxabund=0, numbands=None, band=None,
                    batch_size=COUNT_BATCH_READS):
    """Count all k-mers in the given FASTA/FASTQ files into ``sketch``, on
    the sketch's device; returns the number of reads (genome records count
    once per ``batch`` row they chunk into, as in ``kevlar_tpu``).

    ``mask`` is a sketch on the same device (a ShardedSketch on the same
    mesh for a sharded ``sketch``).  ``band`` is 0-based.  Records longer
    than 1,024 bases chunk into rows overlapping by k-1 bases, so no k-mer
    is lost or counted twice.

    Spans (:mod:`kevlar_tpu_torch.support`): ``count::read``, a batch's
    parse on the producer thread; ``count::consume``, the loop, which holds
    each ``count::wait`` on the producer.
    """
    device = sketch.device
    sharded = isinstance(sketch, ShardedSketch)
    if sharded:
        if mask is not None and not isinstance(mask, ShardedSketch):
            raise ValueError('the mask of a sharded count must be sharded '
                             'on its mesh (ShardedSketch.from_sketch)')
    elif mask is not None and getattr(mask, 'backend', None) != 'device':
        raise ValueError('the mask must be a device sketch of this '
                         'package (khmer-format masks are not supported '
                         'by the port\'s count)')
    elif mask is not None and mask.device != device:
        raise ValueError('mask is on {}, sketch on {}'.format(mask.device,
                                                              device))
    wing = sketch.ksize() - 1
    threshold = 1 if consume_masked else maskmaxabund
    maskspec = mask.table_spec() if mask is not None and not sharded \
        else None
    q = queue.Queue(maxsize=2)
    producer_error = []
    stop = threading.Event()

    def produce():
        try:
            stager = CodeStager(device)
            for seqfile in seqfiles:
                batches = native_base_batches(seqfile, batch_size,
                                              overlap=wing,
                                              alloc=stager.buffer)
                while True:
                    with span('count::read'):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    if stop.is_set():
                        return
                    q.put((stager.ship(), len(batch[1])))
        except BaseException as exc:  # surfaced on the calling thread
            producer_error.append(exc)
        finally:
            q.put(None)

    def consume(acc, codes):
        if sharded:
            sketch.consume_batch(codes, numbands=numbands, band=band,
                                 mask=mask, mask_threshold=threshold,
                                 consume_masked=consume_masked)
        else:
            sketch_ops.consume_codes(
                acc, codes, sketch.ksize(), numbands=numbands, band=band,
                mask=maskspec, mask_threshold=threshold,
                consume_masked=consume_masked)

    thread = threading.Thread(target=produce, name='kevlar-count-producer',
                              daemon=True)
    numreads = 0
    # the accumulator is saturated and packed into the tables when the
    # block ends, on an error too
    with sketch.consuming() as acc:
        thread.start()
        try:
            with span('count::consume', device=device):
                while True:
                    with span('count::wait'):
                        item = q.get()
                    if item is None:
                        break
                    codes, nreads = item
                    consume(acc, codes)
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
    return numreads


def load_sample_seqfile(seqfiles, ksize, memory, maxfpr=0.2, count=True,
                        smallcount=False, mask=None, maskmaxabund=0,
                        consume_masked=False, numbands=None, band=None,
                        outfile=None, batch_size=COUNT_BATCH_READS,
                        device='cuda', sketch_format='native',
                        save_async=False, mesh=None):
    """Compute k-mer abundances for one sample on ``device``; returns the
    sketch (saved to ``outfile`` when given).

    With ``mesh``, the sketch is hash-sharded across the mesh's 'shard'
    axis and reads are data-parallel across 'data' (``device`` is then the
    mesh's); banding is then unsupported, and the mask must be sharded on
    the same mesh.  The sharded table size is the unsharded one (odd), so
    abundances and the saved file equal the unsharded stage's.

    ``sketch_format='khmer'`` counts on the khmer-binary-compatible host
    engine instead (:mod:`kevlar_tpu_torch.oxli`): the saved file is
    byte-identical to what khmer itself produces for the same input (incl.
    hash-range banding).  A khmer-format mask lives in khmer's hash space,
    so a count with one joins it there.  The native format (device-backed,
    npz) is the default.

    With ``save_async`` the save runs on a background thread, off the
    critical path (the tables are not written to again); callers join
    ``sketch._save_thread`` before relying on the file, and
    :func:`kevlar_tpu_torch.sketch.load` of that file joins it itself."""
    counter_bits = (4 if smallcount else 8) if count else 1
    from kevlar_tpu_torch.oxli import OxliSketch
    if sketch_format != 'khmer' and isinstance(mask, OxliSketch) \
            and mesh is None:
        kevlar_tpu_torch.plog('[kevlar::count] mask is khmer-format; '
                              'counting on the khmer-compatible host engine')
        sketch_format = 'khmer'
    if sketch_format == 'khmer':
        if mesh is not None:
            raise ValueError('--shards and --sketch-format khmer are '
                             'mutually exclusive')
        return _load_sample_seqfile_khmer(
            seqfiles, ksize, memory, maxfpr, counter_bits, mask,
            consume_masked, maskmaxabund, numbands, band, outfile,
            count=count, smallcount=smallcount)
    if mesh is not None:
        tablesize = int(memory) // 4 * BUCKETS_PER_BYTE[counter_bits]
        if tablesize % 2 == 0:
            tablesize -= 1  # odd, matching allocate_from_memory (banding)
        # exact hash space: abundances (and the saved counttable) are
        # bit-identical to the unsharded stage at the same --memory
        sketch = ShardedSketch(mesh, ksize, max(tablesize, 1), 4,
                               counter_bits=counter_bits, exact=True)
    else:
        sketch = allocate_from_memory(ksize, memory, num_tables=4,
                                      counter_bits=counter_bits,
                                      device=device)
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


def _load_sample_seqfile_khmer(seqfiles, ksize, memory, maxfpr, counter_bits,
                               mask, consume_masked, maskmaxabund, numbands,
                               band, outfile, count=True, smallcount=False):
    """khmer-format counting path: byte-compatible tables + save files."""
    from kevlar_tpu_torch.oxli import OxliSketch
    from kevlar_tpu_torch.sketch import BUCKETS_PER_BYTE
    if mask is not None and not isinstance(mask, OxliSketch):
        raise ValueError(
            '--sketch-format khmer requires a khmer-format mask '
            '(.nt/.nodetable file); got a native-format sketch')
    tablesize = int(memory) // 4 * BUCKETS_PER_BYTE[counter_bits]
    sketch = OxliSketch(ksize, max(tablesize, 1), 4,
                        counter_bits=counter_bits)
    threshold = (maskmaxabund + 1) if (mask is not None and maskmaxabund)\
        else 1
    numreads = 0
    for seqfile in seqfiles:
        kevlar_tpu_torch.plog(
            '[kevlar::count] - processing "{}"'.format(seqfile))
        nr, _ = sketch.consume_seqfile(
            seqfile, mask=mask, threshold=threshold,
            consume_masked=consume_masked, numbands=numbands, band=band)
        numreads += nr

    message = 'Done loading k-mers'
    if numbands:
        message += ' (band {:d}/{:d})'.format(band + 1, numbands)
    fpr = estimate_fpr(sketch)
    message += ';\n    {:d} reads processed'.format(numreads)
    # exact (khmer-tracked) distinct-k-mer count, matching the reference's
    # "N distinct k-mers stored" log line
    message += ', {:d} distinct k-mers stored'.format(
        sketch.n_unique_kmers())
    message += ';\n    estimated false positive rate is {:1.3f}'.format(fpr)
    if fpr > maxfpr:
        message += ' (FPR too high, bailing out!!!)'
        raise KevlarUnsuitableFPRError('[kevlar::count] ' + message)
    if outfile:
        extensions = get_extension(count=count, smallcount=smallcount)
        if not outfile.endswith(extensions):
            outfile += extensions[1]
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
    mesh = None
    if getattr(args, 'shards', None):
        if args.num_bands:
            raise ValueError('banding and --shards are mutually exclusive: '
                             'hash-space sharding supersedes banding')
        mesh = make_mesh(n_shard=args.shards, device=args.device)
        kevlar_tpu_torch.plog('[kevlar::count] sharding the sketch over mesh',
                              dict(mesh.shape))
    mask = None
    if args.mask:
        from kevlar_tpu_torch import sketch as sketch_mod
        mask = sketch_mod.load(args.mask, device=args.device)
        if mesh is not None:
            mask = ShardedSketch.from_sketch(mesh, mask)
    print_config(args)

    timer = Timer()
    timer.start()
    docount = args.counter_size > 1
    dosmallcount = args.counter_size == 4
    load_sample_seqfile(
        args.seqfile, args.ksize, args.memory, args.max_fpr, count=docount,
        smallcount=dosmallcount, mask=mask,
        consume_masked=args.count_masked, numbands=args.num_bands,
        band=myband, outfile=args.counttable, device=args.device,
        sketch_format=args.sketch_format, mesh=mesh)
    if torch.device(args.device).type == 'cuda':
        torch.cuda.synchronize(args.device)
    total = timer.stop()
    kevlar_tpu_torch.plog(
        '[kevlar::count] Total time: {:.2f} seconds'.format(total))
