"""``novel`` stage: find reads containing novel (case-only) k-mers.

Port of ``kevlar_tpu.novel`` (reference kevlar/novel.py): a k-mer is
interesting iff its abundance is >= `casemin` in every case sample and
<= `ctrlmax` in every control sample; with `abundscreen`, reads whose first
failing case abundance is below it are discarded entirely; reads shorter
than k or containing non-ACGT bases are skipped; emitted records carry
(kmer, offset, abundance-tuple) annotations.

Each read batch's base codes go to the sample sketches' device as they are
(one byte a base, from pinned host memory) and are hashed there.  Each
sample's device tables are screened as ``kevlar_tpu``'s novel screens
them: their bytes read as 8-bit counters over the packed width, whatever
the counter width (for 4- and 1-bit sketches that is not the true count,
as in ``kevlar_tpu``).  Where there are 2 to
:data:`~kevlar_tpu_torch.ops.novel_ops.MAX_SCREEN_SAMPLES` samples whose
tables share one shape (JAX's ``_pack_or_none`` condition), the tables are
packed four samples to a word once a call and each batch goes through
:func:`kevlar_tpu_torch.ops.novel_ops.novel_screen_compact` (on a card
``kt_screen_reads``: the windows hashed, the words gathered and the
predicates tested in one launch, the hits stored in order to a fixed
capacity); a batch of more hits than the capacity is screened again,
uncapped, by :func:`~kevlar_tpu_torch.ops.novel_ops.novel_screen` over
the same words, as JAX falls back.  Any other sample set goes through
``novel_screen`` (K1, one K2 gather for all samples, torch predicates and
compaction).  Only the hits come back.  Banding: the user-facing
`--band` is 1-based; internally band b of N keeps k-mers with ``h1 &
(N-1) == b``, as in the count stage.  With ``--shards`` the sample sketches are hash-sharded over a mesh
(:mod:`kevlar_tpu_torch.parallel`) and each batch goes through
:func:`kevlar_tpu_torch.parallel.sharded_novel_screen`.
"""

import functools

import numpy as np
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch import batch as batch_mod
from kevlar_tpu_torch import native, sequence
from kevlar_tpu_torch.ops import novel_ops, sketch_ops
from kevlar_tpu_torch.parallel import (ShardedSketch, make_mesh,
                                       sharded_novel_screen)
from kevlar_tpu_torch.support import ProgressIndicator, Timer, span
from kevlar_tpu_torch import support

# Always-on counts of the screen's work, per batch, in host ints (read as
# differences): batches, reads, capacity re-screens, bytes shipped to the
# device (codes and lengths) and the host's blocking waits on it (the ring
# slot's event where it waits, the lengths' pageable copy, the hit count,
# the three copies back; no-ops on a CPU device, counted alike); and of the
# text: hit lines written, and those whose canonical k-mer the host made.
counters = {'batches': 0, 'reads': 0, 'rescreens': 0, 'h2d_bytes': 0,
            'syncs': 0, 'text_lines': 0, 'text_host_kmers': 0}


class KevlarCaseSampleMismatchError(ValueError):
    pass


class _LazyRecords:
    """Record accessor over a :class:`_NativeBatch`: Records are
    materialised only for reads that actually carry novel k-mers."""

    def __init__(self, batch):
        self._batch = batch
        self._cache = {}

    def __len__(self):
        return len(self._batch)

    def __getitem__(self, i):
        if i not in self._cache:
            from kevlar_tpu_torch import dna
            b = self._batch
            L = int(b.lengths[i])
            seq = dna.decode(b.bases[i, :L])
            qual = None
            if b.quals is not None:
                q = bytes(b.quals[i, :L]).decode('ascii', 'replace')
                qual = q if q.strip('\x00') else None
            self._cache[i] = sequence.Record(
                name=b.names[i], sequence=seq, quality=qual)
        return self._cache[i]


class _NativeBatch:
    """ReadBatch-compatible view over native-reader output: the base codes
    and lengths (padded to ``pad_rows`` rows), and the ``n`` reads' names
    and quality rows (None without qualities; all NUL for a FASTA read)."""

    __slots__ = ('bases', 'lengths', 'names', 'quals', 'records', 'n')

    def __init__(self, bases, lengths, names, quals, pad_rows):
        self.n = len(names)
        if bases.shape[0] < pad_rows:
            bases = np.concatenate([
                bases,
                np.full((pad_rows - bases.shape[0], bases.shape[1]), 4,
                        np.uint8)])
            lengths = np.concatenate([
                lengths, np.zeros(pad_rows - len(lengths), np.int32)])
        self.bases = bases
        self.lengths = lengths
        self.names = names
        self.quals = quals
        self.records = _LazyRecords(self)

    def __len__(self):
        return self.n

    def text_fields(self, rows):
        """The text writer's read fields for the batch rows ``rows``: the
        batch's own codes, lengths and raw quality rows, where they lie."""
        return dict(seq=self.bases, lengths=self.lengths, qual=self.quals,
                    names=[self.names[r] for r in rows.tolist()])

    def kmer(self, row, off, ksize):
        """The k-mer text at ``off`` of row ``row``, cut at its end."""
        from kevlar_tpu_torch import dna
        end = min(off + ksize, int(self.lengths[row]))
        return dna.decode(self.bases[row, off:end])


def _padded(texts):
    """Byte strings as the rows of a uint8 array, padded with NUL."""
    width = max(1, max(map(len, texts)))
    return np.frombuffer(b''.join(t.ljust(width, b'\0') for t in texts),
                         np.uint8).reshape(len(texts), width)


def _records_text_fields(rbatch, rows):
    """The text writer's read fields for the rows ``rows`` of a
    :class:`~kevlar_tpu_torch.batch.ReadBatch`: their sequences and
    qualities as the Records hold them."""
    records = [rbatch.records[r] for r in rows.tolist()]
    seqs = [rec.sequence.encode('ascii') for rec in records]
    quals = [getattr(rec, 'quality', None) for rec in records]
    fields = dict(seq=_padded(seqs), lengths=list(map(len, seqs)),
                  read_row=np.arange(len(records)),
                  names=[rec.name for rec in records], from_reader=False)
    if any(q is not None for q in quals):
        qenc = [b'' if q is None else q.encode('utf-8') for q in quals]
        fields.update(qual=_padded(qenc), qual_len=[
            -1 if q is None else len(e) for q, e in zip(quals, qenc)])
    return fields


def format_hits(rbatch, hits_np, hitab_np, discard, ksize, writer,
                unique_kmers):
    """One batch's hits as augmented-FASTX text, the whole block written by
    ``writer`` (a :class:`~kevlar_tpu_torch.native.AugTextWriter`) in C++:
    no per-line Python.  A :class:`_NativeBatch` gives its codes and raw
    quality rows, a ``ReadBatch`` its Records' text.  Hits on discarded
    and padding rows are dropped.  Each line's canonical k-mer goes into
    ``unique_kmers``: as the writer's 2-bit code, or, where it gives none
    (k > 32, or a k-mer that is not upper-case ACGT), as the string
    :func:`~kevlar_tpu_torch.dna.revcommin` gives.  Returns ``(text, reads,
    lines)``."""
    if not len(hits_np):
        return '', 0, 0
    windows = rbatch.bases.shape[1] - ksize + 1
    native_rows = isinstance(rbatch, _NativeBatch)
    fields = rbatch.text_fields if native_rows else \
        functools.partial(_records_text_fields, rbatch)
    text, canon, reads, host_hits = writer.write(
        ksize, windows, hits_np, hitab_np, len(rbatch), discard, fields)
    if len(host_hits):
        unique_kmers.update(c for c in canon if c != native.NO_CANON)
        for r, off in zip(*(x.tolist() for x in divmod(host_hits, windows))):
            kmer = rbatch.kmer(r, off, ksize) if native_rows else \
                rbatch.records[r].sequence[off:off + ksize]
            unique_kmers.add(kevlar_tpu_torch.revcommin(kmer))
    else:
        unique_kmers.update(canon)
    counters['text_lines'] += len(canon)
    counters['text_host_kmers'] += len(host_hits)
    return text, reads, len(canon)


def native_read_batches(files, batch_size, max_len=1024):
    """Stream _NativeBatch objects through the C++ reader (compiled at
    first use; a failed build raises).  Each batch's parse is a
    ``novel::read`` span."""
    for path in files:
        reader = iter(native.FastxBatchReader(
            path, max_reads=batch_size, max_len=max_len, want_quals=True))
        bucket = 0
        while True:
            with span('novel::read'):
                parsed = next(reader, None)
                if parsed is None:
                    break
                bases, lengths, names, quals = parsed
                maxlen = int(lengths.max()) if len(lengths) else 0
                bucket = max(bucket, batch_mod.bucket_length(maxlen))
                rbatch = _NativeBatch(
                    np.ascontiguousarray(bases[:, :bucket]), lengths, names,
                    quals[:, :bucket] if quals is not None else None,
                    batch_size)
            yield rbatch


def load_samples(counttables=None, filelists=None, ksize=31, memory=1e6,
                 maxfpr=0.2, numbands=None, band=None, outfilelist=None,
                 device='cuda', mesh=None):
    """Sample sketches on ``device``: loaded from ``counttables``, or
    counted from ``filelists`` (one list of files per sample); with
    ``mesh``, sharded over it."""
    from kevlar_tpu_torch import count as count_mod
    from kevlar_tpu_torch import sketch as sketch_mod
    if not (counttables or filelists):
        raise ValueError('give counttables or sequence files per sample')
    if counttables:
        message = 'counttables for {:d} sample(s) provided'.format(
            len(counttables))
        message += ', any corresponding FASTA/FASTQ input will be ignored'
        kevlar_tpu_torch.plog('[kevlar::novel]    INFO:', message)
        samples = sketch_mod.load_sketchfiles(counttables, maxfpr,
                                              device=device)
        if mesh is not None:
            samples = [ShardedSketch.from_sketch(mesh, s) for s in samples]
        return samples
    samples = []
    for filelist in filelists:
        sample = count_mod.load_sample_seqfile(
            filelist, ksize, memory, maxfpr=maxfpr, numbands=numbands,
            band=band, device=device, mesh=mesh)
        samples.append(sample)
    if outfilelist:
        save_counts(outfilelist, samples)
    return samples


def save_counts(filelist, tablelist):
    if len(filelist) != len(tablelist):
        msg = ('number of filenames provided ({:d}) does not match the number '
               'of samples provided ({:d}); stubbornly refusing to save '
               'k-mer counts'.format(len(filelist), len(tablelist)))
        kevlar_tpu_torch.plog('[kevlar::novel] WARNING:', msg)
        return
    for outfile, counttable in zip(filelist, tablelist):
        if not outfile.endswith(('.ct', '.counttable')):
            outfile += '.counttable'
        kevlar_tpu_torch.plog('    saved to "{}"'.format(outfile))
        counttable.save(outfile)


def novel(casestream, casecounts, controlcounts, ksize=31, abundscreen=None,
          casemin=5, ctrlmax=0, numbands=None, band=None, skipuntil=None,
          batch_size=batch_mod.DEFAULT_BATCH_SIZE, updateint=1e6,
          batchstream=None, emit='records'):
    """Generator yielding annotated (augmented) records with novel k-mers.

    The screen runs on the device of the sample sketches (all on one), or
    over the mesh of sharded ones.  ``emit='text'`` yields preformatted
    augmented-FASTX text blocks (one per screened batch) instead of
    Records: each batch's block written from the hit arrays in one call of
    the C++ text writer (:func:`format_hits`) — the write path of ``main``.

    While spans are recorded (:mod:`kevlar_tpu_torch.support`), a pass is
    ``novel::pass``, recorded when the stream ends with the differences of
    :data:`counters` over it; inside it each wait for the next batch is
    ``novel::wait`` and each batch ``novel::batch``, which holds its
    ``novel::stage``, ``screen``, ``sync`` (the hit count), ``rescreen``
    (a batch past the capacity), ``readback`` and, for text, ``text``.
    Every span of a batch ends before its output is yielded.
    """
    numbands_unset = not numbands
    band_unset = not band and band != 0
    if numbands_unset is not band_unset:
        raise ValueError('Must specify `numbands` and `band` together')
    if band is not None and band < 0:
        message = ('`band` must be a value between 0 and {:d} (`numbands` - '
                   '1), inclusive'.format(numbands - 1))
        raise ValueError(message)
    samples = tuple(casecounts) + tuple(controlcounts)
    sharded = isinstance(samples[0], ShardedSketch)
    if sharded and numbands:
        raise ValueError('banding is superseded by mesh sharding for '
                         'ShardedSketch')
    devices = {s.device for s in samples}
    if len(devices) != 1:
        raise ValueError('sample sketches on several devices: {}'.format(
            sorted(map(str, devices))))
    device = devices.pop()
    # each sample's device tables as JAX's novel hands them to its screen:
    # their bytes as 8-bit counters over the packed width, whatever the
    # counter width (kevlar_tpu/novel.py:177-178)
    specs = None if sharded else [
        (t, 8, t.shape[1]) for t, _, _ in (s.table_spec() for s in samples)]
    ncase = len(casecounts)
    words = None
    if not sharded and 1 < len(samples) <= novel_ops.MAX_SCREEN_SAMPLES \
            and len({tuple(t.shape) for t, _, _ in specs}) == 1:
        with span('novel::pack'):
            words = sketch_ops.pack_sample_tables([t for t, _, _ in specs])

    timer = Timer()
    timer.start()
    nkmers = 0
    nreads = 0
    unique_kmers = set()
    skipping = skipuntil is not None

    progress = ProgressIndicator(
        '[kevlar::novel]     processed {counter} reads', interval=updateint,
        breaks=[1e7, 1e8, 1e9], usetimer=True)

    if batchstream is None:
        batchstream = batch_mod.batches_from_records(casestream, batch_size)
    # parse and marshal a few batches ahead on a background thread, so the
    # device screen never waits on the reader (order is preserved)
    batchstream = batch_mod.prefetch_iter(batchstream, depth=6)

    stager = batch_mod.CodeStager(device)

    def screen(rbatch):
        """(hits, hit abundances, discard) of one batch, on the host."""
        waits = stager.waits
        with span('novel::stage'):
            np.copyto(stager.buffer(rbatch.bases.shape), rbatch.bases)
            codes = stager.ship()
            lengths = torch.from_numpy(
                np.asarray(rbatch.lengths, np.int32)).to(device)
        syncs = stager.waits - waits + 4     # lengths, three copies back
        if sharded:
            with span('novel::screen'):
                hits, hit_abunds, discard = sharded_novel_screen(
                    samples[0].mesh, casecounts, controlcounts, codes,
                    lengths, casemin=casemin, ctrlmax=ctrlmax,
                    screen=abundscreen)
        elif words is not None:
            with span('novel::screen'):
                hit_idx, hit_abunds, n_hits, discard, _ = \
                    novel_ops.novel_screen_compact(
                        words, len(samples), ncase, codes, lengths, ksize,
                        casemin, ctrlmax, screen=abundscreen,
                        numbands=numbands, band=band)
            with span('novel::sync'):
                n = int(n_hits)
            syncs += 1
            if n > hit_idx.shape[0]:
                # more hits than the capacity: the batch again, uncapped
                counters['rescreens'] += 1
                with span('novel::rescreen'):
                    hits, hit_abunds, discard = novel_ops.novel_screen(
                        specs, ncase, codes, lengths, ksize, casemin,
                        ctrlmax, screen=abundscreen, numbands=numbands,
                        band=band, words=words)
            else:
                hits, hit_abunds = hit_idx[:n], hit_abunds[:, :n]
        else:
            with span('novel::screen'):
                hits, hit_abunds, discard = novel_ops.novel_screen(
                    specs, ncase, codes, lengths, ksize, casemin, ctrlmax,
                    screen=abundscreen, numbands=numbands, band=band)
        with span('novel::readback'):
            out = (hits.cpu().numpy(), hit_abunds.cpu().numpy(),
                   discard.cpu().numpy())
        counters['batches'] += 1
        counters['reads'] += len(rbatch)
        counters['h2d_bytes'] += rbatch.bases.nbytes + 4 * len(lengths)
        counters['syncs'] += syncs
        return out

    def decode_hits(rbatch, hits_np, hitab_np, discard):
        """Turn compacted hit indices into annotated Records."""
        nonlocal nreads, nkmers
        P = rbatch.bases.shape[1] - ksize + 1
        irecord = None
        last_i = -1
        for h in range(len(hits_np)):
            i, p = divmod(int(hits_np[h]), P)
            if i >= len(rbatch.records) or discard[i]:
                continue
            if i != last_i:
                if irecord is not None and irecord.annotations:
                    nreads += 1
                    nkmers += len(irecord.annotations)
                    yield irecord
                irecord = sequence.copy_record(rbatch.records[i])
                last_i = i
            record = rbatch.records[i]
            kmer = record.sequence[p:p + ksize]
            irecord.annotate(kmer, p, tuple(int(a) for a in hitab_np[:, h]))
            unique_kmers.add(kevlar_tpu_torch.revcommin(kmer))
        if irecord is not None and irecord.annotations:
            nreads += 1
            nkmers += len(irecord.annotations)
            yield irecord

    emit_text = (emit == 'text')
    writer = native.AugTextWriter() if emit_text else None
    nskipped = 0
    # a pass's span cannot stay open across the yields: it is recorded
    # when the stream ends, each batch's spans name it their parent
    pass_ = support.mark('novel::pass')
    before = dict(counters)
    batchstream = iter(batchstream)
    while True:
        with span('novel::wait', parent=pass_):
            rbatch = next(batchstream, None)
        if rbatch is None:
            break
        if skipping:
            # restartability (reference novel.py:114-132): fast-forward to
            # a named read, host-side; the found read itself is also
            # skipped and the reported count includes it
            names = [r.name for r in rbatch.records]
            if skipuntil in names:
                idx = names.index(skipuntil)
                nskipped += idx + 1
                kevlar_tpu_torch.plog(
                    '[kevlar::novel] Found read {:s} (skipped {:d} '
                    'reads)'.format(skipuntil, nskipped))
                rbatch.records = rbatch.records[idx + 1:]
                rbatch = batch_mod.ReadBatch(rbatch.records) \
                    if rbatch.records else None
                skipping = False
                if rbatch is None:
                    continue
            else:
                nskipped += len(names)
                continue
        progress.update(len(rbatch))
        with span('novel::batch', parent=pass_):
            hits_np, hitab_np, discard = screen(rbatch)
            if emit_text:
                with span('novel::text'):
                    text, reads, lines = format_hits(
                        rbatch, hits_np, hitab_np, discard, ksize, writer,
                        unique_kmers)
                nreads += reads
                nkmers += lines
        if emit_text:
            yield text
        else:
            yield from decode_hits(rbatch, hits_np, hitab_np, discard)
    support.record(pass_, {k: counters[k] - before[k] for k in counters})

    elapsed = timer.stop()
    message = 'Found {:d} instances of {:d} unique novel kmers in {:d} reads'
    message += ' in {:.2f} seconds'
    kevlar_tpu_torch.plog('[kevlar::novel]', message.format(
        nkmers, len(unique_kmers), nreads, elapsed))


def main(args):
    timer = Timer()
    timer.start()
    if (not args.num_bands) is not (not args.band):
        raise ValueError('Must specify --num-bands and --band together')
    myband = args.band - 1 if args.band else None
    mesh = None
    if getattr(args, 'shards', None):
        if args.num_bands:
            raise ValueError('banding and --shards are mutually exclusive: '
                             'hash-space sharding supersedes banding')
        mesh = make_mesh(n_shard=args.shards, device=args.device)
        kevlar_tpu_torch.plog('[kevlar::novel] sharding sample sketches over '
                              'mesh', dict(mesh.shape))

    kevlar_tpu_torch.plog('[kevlar::novel] Loading control samples')
    controls = load_samples(
        args.control_counts, args.control, args.ksize, args.memory,
        args.max_fpr, args.num_bands, myband, args.save_ctrl_counts,
        device=args.device, mesh=mesh)
    kevlar_tpu_torch.plog('[kevlar::novel] Loading case samples')
    cases = load_samples(
        args.case_counts, args.case, args.ksize, args.memory,
        args.max_fpr, args.num_bands, myband, args.save_case_counts,
        device=args.device, mesh=mesh)

    infiles = [f for filelist in args.case for f in filelist]
    from kevlar_tpu_torch import seqio
    caserecords = None
    batchstream = None
    if args.skip_until is None:
        batchstream = native_read_batches(infiles,
                                          batch_mod.DEFAULT_BATCH_SIZE)
    else:
        caserecords = seqio.multi_file_iter(infiles)
    textstream = novel(
        caserecords, cases, controls, ksize=args.ksize,
        abundscreen=args.abund_screen, casemin=args.case_min,
        ctrlmax=args.ctrl_max, numbands=args.num_bands, band=myband,
        skipuntil=args.skip_until, batchstream=batchstream, emit='text')
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    try:
        for textblock in textstream:
            if textblock:
                outstream.write(textblock)
    finally:
        if args.out not in (None, '-'):
            outstream.close()

    total = timer.stop()
    kevlar_tpu_torch.plog(
        '[kevlar::novel] Total time: {:.2f} seconds'.format(total))
