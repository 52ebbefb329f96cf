"""Reference genome handling: cutouts + exact seed matching (no BWA).

The reference pipeline shells out to ``bwa mem -k s -T s -a -c 5000`` for
exact seed matching (kevlar/localize.py:131-144 — with match score 1 and
threshold = seed length, only perfect full-length matches are reported).
Here the same contract is implemented natively: every seed-sized window of
the reference genome is packed into an exact canonical 256-bit code
(:func:`kevlar_tpu_torch.dna.seed_codes`), folded to a 64-bit key, sorted
once, and queried by binary search with exact sequence verification — a
vectorised numpy index with no subprocess (or, with the ``'device'``
backend, ``torch.searchsorted`` on the card).  The index persists next to the
FASTA as ``<refr>.kevseedidx<S>.npz``, in the same arrays as
``kevlar_tpu.reference``, so either package reads the other's index.
"""

import re

import numpy as np

import kevlar_tpu_torch
from kevlar_tpu_torch import dna, seqio


class KevlarRefrSeqNotFoundError(ValueError):
    """Raised if the reference sequence cannot be found."""
    pass


class KevlarInvalidCutoutDeflineError(ValueError):
    pass


class KevlarDeflineSequenceLengthMismatchError(RuntimeError):
    pass


# parity with bwa mem -c 5000: seeds with more matches are skipped
MAX_SEED_HITS = 5000

_FOLD = np.array([0x9e3779b97f4a7c15, 0xbf58476d1ce4e5b9,
                  0x94d049bb133111eb, 0x2545f4914f6cdd1d], dtype=np.uint64)


def _fold_codes(codes):
    """Fold [N, 4] uint64 canonical seed codes to a single uint64 key."""
    acc = np.zeros(codes.shape[:-1], dtype=np.uint64)
    for w in range(4):
        x = (codes[..., w] + _FOLD[w]) * _FOLD[3 - w]
        acc ^= x ^ (x >> np.uint64(29))
    return acc


# seed positions packed at a time when a sequence's index is built
_INDEX_CHUNK = 1 << 22


def _seed_keys(bases, seedsize):
    """The keys and positions of the valid seeds of one encoded sequence.

    The sequence is packed in chunks of :data:`_INDEX_CHUNK` seed
    positions on a thread each (numpy releases the GIL), which gives the
    keys of packing it whole: a seed's code depends on its own bases
    only."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    npos = len(bases) - seedsize + 1

    def chunk(lo):
        hi = min(lo + _INDEX_CHUNK, npos)
        codes, valid = dna.seed_codes(bases[lo:hi + seedsize - 1], seedsize)
        pos = np.nonzero(valid)[0]
        return _fold_codes(codes[pos]), pos + lo

    starts = range(0, npos, _INDEX_CHUNK)
    if len(starts) == 1:
        return chunk(0)
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        parts = list(pool.map(chunk, starts))
    return (np.concatenate([keys for keys, _ in parts]),
            np.concatenate([pos for _, pos in parts]))


def _stable_order(keys):
    """``np.argsort(keys, kind='stable')``, sorted by the keys' top three
    bits first and then within each of those eight parts on a thread of
    its own, by the faster unstable sort: only the runs of equal keys are
    put back into index order."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    top = (keys >> np.uint64(61)).astype(np.uint8)
    first = np.argsort(top, kind='stable')
    edges = np.searchsorted(top[first], np.arange(9))

    def part(i):
        at = first[edges[i]:edges[i + 1]]
        sub = keys[at]
        order = np.argsort(sub)
        same = sub[order[1:]] == sub[order[:-1]]
        if same.any():
            tied = np.zeros(len(sub), dtype=bool)
            tied[1:] = same
            tied[:-1] |= same
            where = np.nonzero(tied)[0]
            run = np.cumsum(~np.concatenate(([False], same)))[where]
            order[where] = order[where][np.lexsort((order[where], run))]
        return at[order]

    if len(keys) < _INDEX_CHUNK:
        return np.concatenate([part(i) for i in range(8)])
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return np.concatenate(list(pool.map(part, range(8))))


_NPY_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}


def _load_npz_mmap(filename):
    """Zero-copy load of an uncompressed npz: map each array member
    directly from the zip (copy-on-write, so callers may mutate without
    touching the file).  ``np.load`` copies npz members through ~1 MB
    zipfile chunks; here pages fault in on first touch, and a lookup
    touches only the keys it reads.  Returns None when any member is
    compressed or otherwise unmappable (caller falls back to np.load)."""
    import zipfile
    try:
        zf = zipfile.ZipFile(filename)
    except (OSError, zipfile.BadZipFile):
        return None
    out = {}
    with zf, open(filename, 'rb') as fh:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            # the central directory's extra field can differ from the
            # local header's: read the local header for the true offset
            fh.seek(info.header_offset)
            hdr = fh.read(30)
            if len(hdr) < 30 or hdr[:4] != b'PK\x03\x04':
                return None
            nlen = int.from_bytes(hdr[26:28], 'little')
            elen = int.from_bytes(hdr[28:30], 'little')
            data_off = info.header_offset + 30 + nlen + elen
            fh.seek(data_off)
            try:
                version = np.lib.format.read_magic(fh)
                read_header = _NPY_HEADER_READERS.get(version)
                if read_header is None:
                    return None
                shape, fortran, dtype = read_header(fh)
            except (ValueError, OSError):
                return None
            if dtype.hasobject:
                return None
            name = info.filename
            name = name[:-4] if name.endswith('.npy') else name
            if not shape:
                # 0-d scalars: tiny, read directly
                out[name] = np.fromfile(fh, dtype=dtype, count=1)[0]
            else:
                out[name] = np.memmap(filename, dtype=dtype, mode='c',
                                      offset=fh.tell(), shape=shape,
                                      order='F' if fortran else 'C')
    return out


def _seed_backend(backend):
    """``backend``, else ``KEVLAR_SEED_BACKEND``, else ``'host'``."""
    import os
    backend = backend or os.environ.get('KEVLAR_SEED_BACKEND', 'host')
    if backend not in ('host', 'device', 'sharded'):
        raise ValueError('unknown seed backend {!r}; expected host, device, '
                         'or sharded'.format(backend))
    return backend


class SeedIndex:
    """Sorted-key index of every canonical seed in a reference genome.

    ``backend`` selects where the binary search runs:

    - ``'host'`` (default): numpy ``searchsorted`` over the sorted keys.
    - ``'device'``: the keys live on ``device`` as order-preserving int64
      (:func:`kevlar_tpu_torch.ops.seed_ops.ordered_int64`), copied there
      at the first lookup, and the whole seed batch is one pair of
      ``torch.searchsorted`` calls
      (:func:`kevlar_tpu_torch.ops.seed_ops.seed_ranges`).
    - ``'sharded'``: the keys are cut into one run per shard of
      ``make_mesh(device=device)`` (every card, all shard; the CPU: one
      shard; after ``init_distributed``, every rank's) and every shard
      searches its run on the rank that owns it
      (:func:`kevlar_tpu_torch.ops.seed_ops.seed_ranges_sharded`).

    The env var ``KEVLAR_SEED_BACKEND`` overrides the default.  Exact
    sequence verification always runs on the host, so every backend
    returns identical matches.
    """

    def __init__(self, refrseqs, seedsize, backend=None, device='cuda'):
        self.seedsize = seedsize
        self.refrseqs = refrseqs
        self.backend = _seed_backend(backend)
        self.device = device
        self._device_index = None
        self._sharded = None
        self._seqids = sorted(refrseqs)
        keys_all, seqidx_all, pos_all = [], [], []
        for si, seqid in enumerate(self._seqids):
            seq = refrseqs[seqid]
            if len(seq) < seedsize:
                continue
            keys, pos = _seed_keys(dna.encode(seq), seedsize)
            keys_all.append(keys)
            seqidx_all.append(np.full(pos.shape, si, dtype=np.int32))
            pos_all.append(pos.astype(np.int64))
        if keys_all:
            keys = np.concatenate(keys_all)
            order = _stable_order(keys)
            self._keys = keys[order]
            self._seqidx = np.concatenate(seqidx_all)[order]
            self._pos = np.concatenate(pos_all)[order]
        else:
            self._keys = np.zeros(0, dtype=np.uint64)
            self._seqidx = np.zeros(0, dtype=np.int32)
            self._pos = np.zeros(0, dtype=np.int64)

    def save(self, path):
        """Persist the sorted key/position arrays (uncompressed npz —
        load latency matters more than disk).  Written to a temp file in
        the same directory and atomically renamed so a concurrent reader
        (autoindex in another process) never observes a partial file."""
        import os
        import tempfile
        if not path.endswith('.npz'):
            path += '.npz'  # np.savez would append it silently
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or '.',
                                   suffix='.npz.tmp')
        try:
            with os.fdopen(fd, 'wb') as fh:
                np.savez(fh, keys=self._keys, seqidx=self._seqidx,
                         pos=self._pos, seqids=np.array(self._seqids),
                         seedsize=self.seedsize)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def from_file(cls, path, refrseqs, backend=None, device='cuda'):
        """Load a persisted index; ``refrseqs`` still backs the exact
        sequence verification in :meth:`lookup`.  Arrays are memory-mapped
        (copy-on-write) when the npz is uncompressed: lookups only touch
        O(log n) key pages, so neither load latency nor resident memory
        scales with the genome."""
        data = _load_npz_mmap(path)
        if data is None:
            data = np.load(path, allow_pickle=False)
        obj = cls.__new__(cls)
        obj.seedsize = int(data['seedsize'])
        obj.refrseqs = refrseqs
        obj.backend = _seed_backend(backend)
        obj.device = device
        obj._device_index = None
        obj._sharded = None
        obj._seqids = [str(s) for s in data['seqids']]
        obj._keys = data['keys']
        obj._seqidx = data['seqidx']
        obj._pos = data['pos']
        return obj

    def device_keys(self):
        """The sorted keys on ``device`` as order-preserving int64, copied
        there once per index."""
        if self._device_index is None:
            import torch
            from kevlar_tpu_torch.ops import seed_ops
            # the flip makes a fresh array: a memory-mapped file's keys are
            # never handed to torch.from_numpy
            self._device_index = torch.from_numpy(
                seed_ops.ordered_int64(self._keys)).to(self.device)
        return self._device_index

    def sharded_keys(self):
        """``(mesh, shards, n_valid, base)`` of the ``'sharded'`` search:
        the keys cut over the mesh's shards, each run on its device of data
        row 0 (None where another rank owns it), made once per index."""
        if self._sharded is None:
            import torch
            from kevlar_tpu_torch.ops import seed_ops
            from kevlar_tpu_torch.parallel import make_mesh
            mesh = make_mesh(device=self.device)
            runs, n_valid, base = seed_ops.shard_keys(self._keys,
                                                      mesh.shape['shard'])
            shards = [torch.from_numpy(runs[s]).to(mesh.devices[0][s])
                      if mesh.is_local(0, s) else None
                      for s in range(mesh.shape['shard'])]
            self._sharded = (mesh, shards, n_valid, base)
        return self._sharded

    def _search_device(self, qkeys):
        """(lo, hi) numpy index ranges per query key via the device search
        (or the sharded one)."""
        import torch
        from kevlar_tpu_torch.ops import seed_ops
        queries = torch.from_numpy(seed_ops.ordered_int64(qkeys))
        if self.backend == 'sharded':
            mesh, shards, n_valid, base = self.sharded_keys()
            start, count = seed_ops.seed_ranges_sharded(
                mesh, shards, queries, n_valid, base)
            return start, start + count
        start, count = seed_ops.seed_ranges(self.device_keys(),
                                            queries.to(self.device))
        start = start.cpu().numpy()
        return start, start + count.cpu().numpy()

    def lookup(self, seeds):
        """Match canonical seed strings; returns {seed: set((seqid, pos))}.

        Only perfect full-length matches are returned; seeds with more than
        MAX_SEED_HITS matches yield none (bwa -c parity).
        """
        result = {}
        seedlist = sorted(seeds)
        if not seedlist or len(self._keys) == 0:
            return result
        qbases, _ = dna.encode_batch(seedlist)
        qcodes, qvalid = dna.seed_codes(qbases, self.seedsize)
        qkeys = _fold_codes(qcodes[:, 0, :])
        if self.backend in ('device', 'sharded'):
            lo, hi = self._search_device(qkeys)
        else:
            lo = np.searchsorted(self._keys, qkeys, side='left')
            hi = np.searchsorted(self._keys, qkeys, side='right')
        for i, seed in enumerate(seedlist):
            if not qvalid[i, 0]:
                continue
            n = int(hi[i] - lo[i])
            if n == 0 or n > MAX_SEED_HITS:
                continue
            matches = set()
            for idx in range(int(lo[i]), int(hi[i])):
                seqid = self._seqids[self._seqidx[idx]]
                pos = int(self._pos[idx])
                # exact verification (guards against 64-bit fold collisions)
                window = self.refrseqs[seqid][pos:pos + self.seedsize]
                if dna.revcommin(window.upper()) == seed:
                    matches.add((seqid, pos))
            if matches:
                result[seed] = matches
        return result


_index_cache = {}


def index_path(refrfile, seedsize):
    """On-disk seed-index file for a reference FASTA (the `bwa index`
    analog — the reference's quick start builds its BWA index before the
    timed workflow, docs/quick-start.rst)."""
    return '{}.kevseedidx{}.npz'.format(refrfile, seedsize)


def autoindex(refrfile, seedsize=51, refrseqs=None, device='cuda'):
    """Build (or load) the seed index for a reference FASTA file.

    Mirrors the reference's ``autoindex`` (reference.py:35-51: run
    ``bwa index`` iff the index files are missing): the sorted key/pos
    arrays persist next to the FASTA and later runs load them instead of
    re-extracting and re-sorting every genome seed.  A stale index (older
    than the FASTA) is rebuilt.  The search backend comes from
    ``KEVLAR_SEED_BACKEND`` (``'host'`` by default); ``device`` is where
    the ``'device'`` backend keeps the keys.  The in-process cache holds
    one index per file, seed size, backend and device.
    """
    import os
    if not os.path.isfile(refrfile):
        raise KevlarRefrSeqNotFoundError(
            'reference file {:s} does not exist'.format(refrfile))
    backend = _seed_backend(None)
    key = (os.path.abspath(refrfile), seedsize, backend, str(device))
    if key in _index_cache:
        return _index_cache[key]
    if refrseqs is None:
        refrseqs = seqio.parse_seq_dict(kevlar_tpu_torch.open(refrfile, 'r'))
    idxfile = index_path(refrfile, seedsize)
    index = None
    if os.path.isfile(idxfile) and \
            os.path.getmtime(idxfile) >= os.path.getmtime(refrfile):
        try:
            index = SeedIndex.from_file(idxfile, refrseqs, backend=backend,
                                        device=device)
            kevlar_tpu_torch.plog('[kevlar::reference] loaded seed index '
                                  '"{}"'.format(idxfile))
        except Exception as exc:
            kevlar_tpu_torch.plog('[kevlar::reference] discarding '
                                  'unreadable seed index {}: {}'.format(
                                      idxfile, exc))
            index = None
    if index is None:
        kevlar_tpu_torch.plog('[kevlar::reference] building seed index for '
                              '"{}" (seedsize {})'.format(refrfile, seedsize))
        index = SeedIndex(refrseqs, seedsize, backend=backend, device=device)
        try:
            index.save(idxfile)
        except OSError as exc:  # read-only genome dir: stay in-memory
            kevlar_tpu_torch.plog('[kevlar::reference] could not persist '
                                  'seed index: {}'.format(exc))
    _index_cache.clear()  # keep at most one genome index in memory
    _index_cache[key] = index
    return index


class ReferenceCutout:
    """An interval of the reference genome matched by a variant contig.

    Deflines use the ``seqid_start-end`` convention of the reference
    implementation (kevlar/reference.py:117-130).
    """

    def __init__(self, defline=None, sequence=None):
        self.defline = defline
        self.sequence = sequence
        self._seqid = None
        self._startpos = None
        self._endpos = None
        if defline:
            self.parse_defline(defline)

    def __len__(self):
        return self._endpos - self._startpos

    def parse_defline(self, defline):
        match = re.search(r'(\S+)_(\d+)-(\d+)', defline)
        if not match:
            raise KevlarInvalidCutoutDeflineError(defline)
        self._seqid = match.group(1)
        self._startpos = int(match.group(2))
        self._endpos = int(match.group(3))
        if not self.sequence:
            return
        if len(self) != len(self.sequence):
            raise KevlarDeflineSequenceLengthMismatchError(
                'defline length: {:d}, sequence length: {:d}'.format(
                    len(self), len(self.sequence)))

    @property
    def interval(self):
        return self._seqid, self._startpos, self._endpos

    def local_to_global(self, coordinate):
        return self._startpos + coordinate


def load_refr_cutouts(instream):
    for defline, sequence in seqio.parse_fasta(instream):
        yield ReferenceCutout(defline[1:], sequence)
