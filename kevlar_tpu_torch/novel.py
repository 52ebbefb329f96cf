"""``novel`` stage: find reads containing novel (case-only) k-mers.

Port of ``kevlar_tpu.novel`` (reference kevlar/novel.py): a k-mer is
interesting iff its abundance is >= `casemin` in every case sample and
<= `ctrlmax` in every control sample; with `abundscreen`, reads whose first
failing case abundance is below it are discarded entirely; reads shorter
than k or containing non-ACGT bases are skipped; emitted records carry
(kmer, offset, abundance-tuple) annotations.

Each read batch's base codes go to the sample sketches' device as they are
(one byte a base, from pinned host memory) and are hashed there (K1).
Where there is more than one sample and every sample is an 8-bit device
sketch of one shape (JAX's ``_pack_or_none`` condition; at most
:data:`~kevlar_tpu_torch.ops.novel_ops.MAX_SCREEN_SAMPLES`), the tables are
packed four samples to a word once a call and each batch goes through
:func:`kevlar_tpu_torch.ops.novel_ops.novel_screen_compact` (on a card
``kt_screen_words`` and ``kt_compact_hits``: the predicates tested where
the words are gathered, the hits compacted in order to a fixed capacity);
a batch of more hits than the capacity is screened again, uncapped, by
:func:`~kevlar_tpu_torch.ops.novel_ops.novel_screen` over the same words,
as JAX falls back.  Any other sample set goes through ``novel_screen``
(one K2 gather for all samples, torch predicates and compaction).  Only
the hits come back.  Banding: the user-facing `--band` is 1-based;
internally band b of N keeps k-mers with ``h1 & (N-1) == b``, as in the
count stage.  With
``--shards`` the sample sketches are hash-sharded over a mesh
(:mod:`kevlar_tpu_torch.parallel`) and each batch goes through
:func:`kevlar_tpu_torch.parallel.sharded_novel_screen`.
"""

import numpy as np
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch import batch as batch_mod
from kevlar_tpu_torch import sequence
from kevlar_tpu_torch.ops import hashing, novel_ops, sketch_ops
from kevlar_tpu_torch.parallel import (ShardedSketch, make_mesh,
                                       sharded_novel_screen)
from kevlar_tpu_torch.support import ProgressIndicator, Timer


class KevlarCaseSampleMismatchError(ValueError):
    pass


class _LazyRecords:
    """Record accessor over native-reader arrays: Records are materialised
    only for reads that actually carry novel k-mers."""

    def __init__(self, bases, lengths, names, quals):
        self._bases = bases
        self._lengths = lengths
        self._names = names
        self._quals = quals
        self._cache = {}

    def __len__(self):
        return len(self._names)

    def __getitem__(self, i):
        if i not in self._cache:
            from kevlar_tpu_torch import dna
            L = int(self._lengths[i])
            seq = dna.decode(self._bases[i, :L])
            qual = None
            if self._quals is not None:
                q = bytes(self._quals[i, :L]).decode('ascii', 'replace')
                qual = q if q.strip('\x00') else None
            self._cache[i] = sequence.Record(
                name=self._names[i], sequence=seq, quality=qual)
        return self._cache[i]


class _NativeBatch:
    """ReadBatch-compatible view over native-reader output."""

    __slots__ = ('bases', 'lengths', 'records', 'n')

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
        self.records = _LazyRecords(bases, lengths, names, quals)

    def __len__(self):
        return self.n


def native_read_batches(files, batch_size, max_len=1024):
    """Stream _NativeBatch objects through the C++ reader (compiled at
    first use; a failed build raises)."""
    from kevlar_tpu_torch import native
    for path in files:
        reader = native.FastxBatchReader(path, max_reads=batch_size,
                                         max_len=max_len, want_quals=True)
        bucket = 0
        for bases, lengths, names, quals in reader:
            maxlen = int(lengths.max()) if len(lengths) else 0
            bucket = max(bucket, batch_mod.bucket_length(maxlen))
            yield _NativeBatch(np.ascontiguousarray(bases[:, :bucket]),
                               lengths, names,
                               quals[:, :bucket] if quals is not None
                               else None, batch_size)


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


_ASCII_BASES = np.frombuffer(b'ACGTN', dtype=np.uint8)


def novel(casestream, casecounts, controlcounts, ksize=31, abundscreen=None,
          casemin=5, ctrlmax=0, numbands=None, band=None, skipuntil=None,
          batch_size=batch_mod.DEFAULT_BATCH_SIZE, updateint=1e6,
          batchstream=None, emit='records'):
    """Generator yielding annotated (augmented) records with novel k-mers.

    The screen runs on the device of the sample sketches (all on one), or
    over the mesh of sharded ones.  ``emit='text'`` yields preformatted
    augmented-FASTX text blocks (one per screened batch) instead of
    Records: the hit arrays are serialised columnar-to-text without
    per-read Python objects — the write path of ``main``.
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
    specs = None if sharded else [s.table_spec() for s in samples]
    ncase = len(casecounts)
    words = None
    if not sharded and 1 < len(samples) <= novel_ops.MAX_SCREEN_SAMPLES \
            and all(bits == 8 for _, bits, _ in specs) \
            and len({tuple(t.shape) for t, _, _ in specs}) == 1:
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
        np.copyto(stager.buffer(rbatch.bases.shape), rbatch.bases)
        codes = stager.ship()
        lengths = torch.from_numpy(np.asarray(rbatch.lengths, np.int32)).to(
            device)
        if sharded:
            hits, hit_abunds, discard = sharded_novel_screen(
                samples[0].mesh, casecounts, controlcounts, codes, lengths,
                casemin=casemin, ctrlmax=ctrlmax, screen=abundscreen)
        elif words is not None:
            h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
            hit_idx, hit_abunds, n_hits, discard, _ = \
                novel_ops.novel_screen_compact(
                    words, len(samples), ncase, h1, h2, valid, codes,
                    lengths, ksize, casemin, ctrlmax, screen=abundscreen,
                    numbands=numbands, band=band)
            n = int(n_hits)
            if n > hit_idx.shape[0]:
                # more hits than the capacity: the batch again, uncapped
                hits, hit_abunds, discard = novel_ops.novel_screen(
                    specs, ncase, codes, lengths, ksize, casemin, ctrlmax,
                    screen=abundscreen, numbands=numbands, band=band,
                    words=words)
            else:
                hits, hit_abunds = hit_idx[:n], hit_abunds[:, :n]
        else:
            hits, hit_abunds, discard = novel_ops.novel_screen(
                specs, ncase, codes, lengths, ksize, casemin, ctrlmax,
                screen=abundscreen, numbands=numbands, band=band)
        return (hits.cpu().numpy(), hit_abunds.cpu().numpy(),
                discard.cpu().numpy())

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

    def row_fields(rbatch, r):
        """(name, sequence, quality) for one batch row without building a
        Record: native batches decode straight from the columnar arrays."""
        recs = rbatch.records
        if isinstance(recs, _LazyRecords):
            L = int(recs._lengths[r])
            seq = _ASCII_BASES[rbatch.bases[r, :L]].tobytes().decode('ascii')
            qual = None
            if recs._quals is not None:
                q = recs._quals[r, :L].tobytes().decode('ascii', 'replace')
                qual = q if q.strip('\x00') else None
            return recs._names[r], seq, qual
        rec = recs[r]
        return rec.name, rec.sequence, getattr(rec, 'quality', None)

    def format_hits(rbatch, hits_np, hitab_np, discard):
        """Serialise one batch's hits straight to augmented-FASTX text
        (columnar arrays to one text block, no Record objects)."""
        nonlocal nreads, nkmers
        if not len(hits_np):
            return ''
        P = rbatch.bases.shape[1] - ksize + 1
        i = hits_np // P
        p = hits_np - i * P
        n = len(rbatch.records)
        ok = (i < n) & ~discard[np.minimum(i, len(discard) - 1)]
        if not ok.all():
            i, p, hitab_np = i[ok], p[ok], hitab_np[:, ok]
        if not len(i):
            return ''
        # hits arrive in ascending flat order (ascending read, then offset)
        boundaries = np.flatnonzero(np.diff(i)) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [len(i)]))
        abstr = [' '.join(map(str, col)) for col in hitab_np.T.tolist()]
        parts = []
        for s, e in zip(starts.tolist(), ends.tolist()):
            r = int(i[s])
            name, seq, qual = row_fields(rbatch, r)
            if qual is not None:
                parts.append('@{}\n{}\n+\n{}\n'.format(name, seq, qual))
            else:
                parts.append('>{}\n{}\n'.format(name, seq))
            for j in range(s, e):
                off = int(p[j])
                kmer = seq[off:off + ksize]
                parts.append('{}{}          {}#\n'.format(
                    ' ' * off, kmer, abstr[j]))
                unique_kmers.add(kevlar_tpu_torch.revcommin(kmer))
            nreads += 1
            nkmers += e - s
        return ''.join(parts)

    emit_text = (emit == 'text')
    nskipped = 0
    for rbatch in batchstream:
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
        hits_np, hitab_np, discard = screen(rbatch)
        if emit_text:
            yield format_hits(rbatch, hits_np, hitab_np, discard)
        else:
            yield from decode_hits(rbatch, hits_np, hitab_np, discard)

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
