"""Hash-range-sharded Count-Min sketch over a ('data', 'shard') mesh.

Counterpart of ``kevlar_tpu/parallel/sharded.py``, on the mesh of
:mod:`kevlar_tpu_torch.parallel.mesh` and the collectives of
:mod:`kevlar_tpu_torch.parallel.collectives`.  On a mesh over several ranks
every rank holds the same input, hashes, holds and adds only its own
cells, and takes every branch that precedes a collective on a value every
rank has (a reduction's result, the batch's shape), never on its own.

Layout
------
- shard ``s`` of every table holds the buckets ``[s * shard_size, (s + 1)
  * shard_size)`` of the hash space, packed as the single-device sketch
  packs a row (``ops/sketch_ops.py``; ``shard_size`` is a multiple of 8, so
  a shard packs to whole bytes); ``tables[d][s]`` is shard ``s``'s uint8
  ``[ntables, shard_width]`` on device ``(d, s)``, the same counters in
  every data row;
- read batches are cut over 'data' (each data row takes a contiguous run
  of rows), or over both axes for the routed consume.

Consume
-------
Counts go into an int32 accumulator per device, ``[ntables, shard_size]``,
open over a :meth:`ShardedSketch.consuming` block (a batch outside one is a
block of its own).  When the block ends the accumulators are summed over
'data', saturated at the counter width's maximum and packed: the adds are
monotone, so saturating once gives the counts of saturating every batch, as
``Sketch.consuming()`` does on one device.

- routed (default when unmasked): each device hashes its own slice of the
  batch once (K1); ``kt_route`` bins every table's bucket by owner shard
  into a ``[T, S, C]`` send buffer, each bin's slots in k-mer order and
  filled only up to its population; if the largest bin population (a
  ``pmax`` over the mesh) fits the capacity ``C``, one ``all_to_all`` over
  'shard' hands each owner its ``S`` received bins and their populations
  as parts (views of the senders' buffers where they share a device: no
  stacked copy) and the owner adds each bin's filled prefix with
  ``kt_scatter_add`` (no slot past a population is read, or written);
  otherwise the batch goes down the replicate path, as in
  ``kevlar_tpu`` (whose routed program adds first and throws the batch away;
  here the test comes before any add);
- replicate (``route='replicate'``, and every masked consume): each data
  row's reads go to every shard; each shard hashes them all and adds only
  the buckets it owns (``kt_consume`` with a bucket range).  A mask's count
  is a range-aware K2 gather on each shard (a bucket it does not own reads
  255) and a ``pmin`` over 'shard'.

Queries and the novel screen gather on each shard with a range (255 where
the shard does not own the bucket) and take a ``pmin`` over 'shard'.
"""

import contextlib

import numpy as np
import torch

from kevlar_tpu_torch import dna
from kevlar_tpu_torch.ops import hashing, novel_ops, sketch_ops
from kevlar_tpu_torch.parallel import collectives
from kevlar_tpu_torch.sketch import MAXCOUNT, write_npz


def _grid(mesh, fn):
    """``[[fn(d, s) for s] for d]`` over this rank's cells of the mesh,
    None at the others'."""
    return [[fn(d, s) if mesh.is_local(d, s) else None
             for s in range(mesh.shape['shard'])]
            for d in range(mesh.shape['data'])]


def _pad_rows(codes, n, lengths=None):
    """``codes`` [B, L] with rows of 4 (not a base) appended up to a
    multiple of ``n``, and ``lengths`` with zeros."""
    pad = (-codes.shape[0]) % n
    if pad:
        codes = torch.cat([codes, torch.full(
            (pad, codes.shape[1]), 4, dtype=torch.uint8,
            device=codes.device)])
        if lengths is not None:
            lengths = torch.cat([lengths, torch.zeros(
                pad, dtype=lengths.dtype, device=lengths.device)])
    return codes if lengths is None else (codes, lengths)


def _hash_rows(mesh, codes, ksize, both_axes=False):
    """K1 on each device's run of rows: ``hashed[d][s] = (h1, h2, valid)``
    flat, of the rows of data row ``d`` (or of cell ``(d, s)`` with
    ``both_axes``); ``codes`` is padded to a multiple of the runs."""
    n_data, n_shard = mesh.shape['data'], mesh.shape['shard']
    runs = n_data * n_shard if both_axes else n_data
    r = codes.shape[0] // runs

    def hashed(d, s):
        i = d * n_shard + s if both_axes else d
        part = codes[i * r:(i + 1) * r].to(mesh.devices[d][s],
                                           non_blocking=True)
        return tuple(x.reshape(-1) for x in
                     hashing.kmer_hashes_codes(part, ksize))
    return _grid(mesh, hashed)


def routing_capacity(n_data, n_shard, ksize, bases_shape):
    """Per-(table, destination) routing capacity of a ``[B, L]`` batch on an
    ``(n_data, n_shard)`` mesh: 1.25x the expected bin population under
    uniform hashing (measured max/expected is ~1.02 on read data — a good
    hash concentrates tightly; the overflow->replicate path covers
    pathological inputs), 128 floor, multiple of 8."""
    n_dev = n_data * n_shard
    B = -(-bases_shape[0] // n_dev) * n_dev
    windows = max(bases_shape[1] - ksize + 1, 1)
    per_dev = (B // n_dev) * windows
    exp_bin = -(-per_dev // n_shard)
    cap = max(128, exp_bin + exp_bin // 4)
    return -(-cap // 8) * 8


class _MeshAccumulator:
    """The int32 accumulators of a sharded consume, ``acc[d][s]``
    ``[ntables, shard_size]`` on device ``(d, s)``: data row 0 starts from
    the shards' counters, the other rows from 0; :meth:`tables` sums them
    over 'data', saturates and packs.  Like ``sketch_ops.Accumulator`` it
    saturates early if the windows added since could wrap a sum."""

    def __init__(self, sketch):
        self.sketch = sketch
        mesh = sketch.mesh
        self._headroom = sketch_ops._I32_HEADROOM - 255 * mesh.shape['data']
        self._since_saturation = 0

        def start(d, s):
            if d == 0:
                return sketch_ops.unpack_rows(
                    sketch.tables[0][s], sketch.counter_bits,
                    sketch.shard_size).to(torch.int32)
            return torch.zeros((sketch.ntables, sketch.shard_size),
                               dtype=torch.int32, device=mesh.devices[d][s])
        self.acc = _grid(mesh, start)

    def make_room(self, n):
        """Saturate first if ``n`` more windows could wrap a sum."""
        if self._since_saturation + n > self._headroom:
            for d, s in self.sketch.mesh.local_cells():
                self.acc[d][s].clamp_(max=self.sketch.maxcount)
            self._since_saturation = 0
        self._since_saturation += n

    def tables(self):
        sk = self.sketch
        total = collectives.psum(sk.mesh, self.acc, 'data')
        packed = {}

        def pack(d, s):
            key = id(total[d][s])
            if key not in packed:
                packed[key] = sketch_ops.pack_rows(
                    total[d][s].clamp(max=sk.maxcount).to(torch.uint8),
                    sk.counter_bits)
            return packed[key]
        return _grid(sk.mesh, pack)


class ShardedSketch:
    """Count-Min sketch hash-sharded across the 'shard' axis of a mesh."""

    def __init__(self, mesh, ksize, total_tablesize, ntables=4,
                 counter_bits=8, exact=False):
        self.mesh = mesh
        self._ksize = int(ksize)
        self.ntables = int(ntables)
        self.counter_bits = int(counter_bits)
        self.maxcount = MAXCOUNT[self.counter_bits]
        n_shard = mesh.shape['shard']
        total = int(total_tablesize)
        self.shard_size = -(-total // n_shard)  # ceil
        # shards must pack to whole bytes (sub-byte counters store 8 or 2
        # buckets per byte, matching the single-device Sketch layout)
        self.shard_size += (-self.shard_size) % 8
        # with ``exact`` the hash space is exactly the requested tablesize
        # (the tail shard's padding buckets are never addressed), so counts
        # are bit-identical to a single-device Sketch of the same size and
        # the sketch round-trips through save/load unchanged; the default
        # uses the padded size as the hash space (slightly lower FPR)
        self.tablesize = total if exact else self.shard_size * n_shard
        self.shard_width = sketch_ops.packed_width(self.shard_size,
                                                   self.counter_bits)
        self.device = mesh.home
        self.tables = _grid(mesh, lambda d, s: torch.zeros(
            (self.ntables, self.shard_width), dtype=torch.uint8,
            device=mesh.devices[d][s]))
        # batches down each consume path (an overflowed batch also counts
        # as replicated)
        self.batches = {'routed': 0, 'replicated': 0, 'overflowed': 0}
        self._acc = None
        self._host_tables = None

    @classmethod
    def from_sketch(cls, mesh, sketch):
        """Re-shard a single-device Sketch (e.g. a loaded counttable)
        across the mesh, preserving its exact hash space so abundances are
        bit-identical."""
        out = cls(mesh, sketch.ksize(), sketch.tablesize,
                  ntables=sketch.ntables, counter_bits=sketch.counter_bits,
                  exact=True)
        if getattr(sketch, 'backend', None) == 'device':
            values = sketch_ops.unpack_rows(sketch.table_spec()[0],
                                            sketch.counter_bits,
                                            sketch.tablesize)
        else:
            values = torch.from_numpy(np.ascontiguousarray(sketch._host()))
        ss = out.shard_size
        for s in {s for _, s in mesh.local_cells()}:
            lo = s * ss
            part = torch.zeros((out.ntables, ss), dtype=torch.uint8,
                               device=values.device)
            held = max(0, min(ss, out.tablesize - lo))
            part[:, :held] = values[:, lo:lo + held]
            packed = sketch_ops.pack_rows(part, out.counter_bits)
            for d in range(mesh.shape['data']):
                if mesh.is_local(d, s):
                    out.tables[d][s] = packed.to(mesh.devices[d][s])
        return out

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return [self.tablesize] * self.ntables

    def _spec(self, d, s):
        """K2's sample for shard ``s`` on data row ``d``: its rows and
        their bucket range."""
        return (self.tables[d][s], self.counter_bits, self.tablesize,
                s * self.shard_size, self.shard_size)

    def _check_open(self):
        if self._acc is not None:
            raise ValueError('the sketch is inside a consuming() block: its '
                             'tables are packed when the block ends')

    def _check_held(self):
        """Raise unless this rank holds every cell, as ``np.asarray`` of a
        JAX array that spans other processes' devices raises."""
        elsewhere = self.mesh.elsewhere()
        if elsewhere:
            raise ValueError(
                'the sketch spans cells rank {} does not hold ({}): gather '
                'its counts with query_batch'.format(self.mesh.rank, '; '.join(
                    'rank {}: {}'.format(r, ', '.join(map(str, cells)))
                    for r, cells in sorted(elsewhere.items()))))

    # -- Sketch-interface parity (host-side queries over gathered mirror) --
    def _host(self):
        """Unpacked counters, numpy [ntables, tablesize]."""
        if self._host_tables is None:
            self._check_open()
            self._check_held()
            rows = [sketch_ops.unpack_rows(self.tables[0][s],
                                           self.counter_bits,
                                           self.shard_size).cpu()
                    for s in range(self.mesh.shape['shard'])]
            self._host_tables = torch.cat(rows, dim=1)[
                :, :self.tablesize].numpy()
        return self._host_tables

    def _invalidate(self):
        self._host_tables = None

    def n_occupied(self):
        """Occupied buckets of table 0, each shard counting the buckets of
        the hash space it holds (on the owner of its cell in data row 0,
        summed over the ranks)."""
        self._check_open()
        mesh = self.mesh
        occupied = []
        for s in range(mesh.shape['shard']):
            held = min(self.shard_size, self.tablesize - s * self.shard_size)
            occupied.append(None if not mesh.is_local(0, s) else
                            torch.tensor([sketch_ops.occupancy(
                                self.tables[0][s], self.counter_bits, held)
                                if held > 0 else 0]))
        return sum(int(n) for n in collectives.share(
            mesh, occupied, mesh.ranks[0], device=torch.device('cpu')))

    def n_unique_kmers(self):
        occ = self.n_occupied()
        if occ >= self.tablesize:
            return self.tablesize
        return int(round(-self.tablesize * np.log1p(-occ / self.tablesize)))

    def _host_counts(self, h1, h2, valid=None):
        tables = self._host()
        counts = None
        for t in range(self.ntables):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(self.tablesize)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        if valid is not None:
            counts = np.where(valid, counts, 0)
        return counts

    def get(self, kmer):
        encoded = dna.encode(kmer)
        if len(kmer) == self._ksize and not (encoded >= 4).any():
            counts, _ = self._query_padded(encoded)
            return int(counts[0])
        h1, h2 = dna.hash_kmer(kmer)
        return int(self._host_counts(np.uint32([h1]), np.uint32([h2]))[0])

    def get_kmer_counts(self, seq):
        counts, valid = self._query_padded(dna.encode(seq))
        n = len(seq) - self._ksize + 1
        return [int(c) for c in np.where(valid[:n], counts[:n], 0)]

    def _query_padded(self, encoded):
        """Point query without gathering the sketch to the host: the
        sequence rides one row of a device query batch (at least a k-mer,
        padded to a multiple of 64 bases); every shard reads only its own
        table range and a ``pmin`` selects the owners' counts."""
        n = max(int(encoded.shape[0]), self._ksize)
        row = np.full((1, max(64, -(-n // 64) * 64)), 4, np.uint8)
        row[0, :encoded.shape[0]] = encoded
        counts, valid = self.query_batch(row)
        return counts[0].cpu().numpy(), valid[0].cpu().numpy()

    def save(self, filename):
        """Write the standard npz file (loadable as a single-device
        Sketch), one table row at a time."""
        self._check_open()
        self._check_held()

        def rows():
            for t in range(self.ntables):
                row = torch.cat([sketch_ops.unpack_rows(
                    self.tables[0][s][t:t + 1], self.counter_bits,
                    self.shard_size).cpu()
                    for s in range(self.mesh.shape['shard'])], dim=1)
                yield row[:, :self.tablesize].numpy()
        write_npz(filename, dict(ksize=self._ksize, tablesize=self.tablesize,
                                 ntables=self.ntables,
                                 counter_bits=self.counter_bits,
                                 n_occupied=self.n_occupied()),
                  (self.ntables, self.tablesize), rows())

    # -- consume ----------------------------------------------------------
    @contextlib.contextmanager
    def consuming(self):
        """Hold the mesh's int32 accumulators open over a loop of batch
        consumes, as ``Sketch.consuming()`` holds one: entry unpacks the
        shards, exit sums over 'data', saturates and packs; inside,
        ``tables`` is None.  Blocks nest: the outermost closes."""
        if self._acc is not None:
            yield self._acc
            return
        self._acc = _MeshAccumulator(self)
        self.tables = None
        self._invalidate()
        try:
            yield self._acc
        finally:
            self.tables, self._acc = self._acc.tables(), None

    def _codes(self, bases):
        """``bases`` (numpy or tensor, uint8 base codes) as a contiguous
        tensor: a tensor stays where it is, numpy goes to the mesh's first
        device."""
        if not torch.is_tensor(bases):
            bases = torch.from_numpy(np.ascontiguousarray(bases, np.uint8))
            bases = bases.to(self.device)
        return bases.contiguous()

    def consume_batch(self, bases, numbands=None, band=None, mask=None,
                      mask_threshold=0, consume_masked=False, route=None,
                      a2a_capacity=None):
        """Count a [B, L] base batch.

        ``route`` picks the consume collective: ``'alltoall'`` (default
        when unmasked) hashes each k-mer once and routes its bucket
        indices to the owner shard; ``'replicate'`` replicates the reads
        across 'shard' and drops out-of-range indices (and is the only
        masked mode — the mask screen needs every shard to see every k-mer
        for the ``pmin`` count select).  If a routed batch overflows its
        per-destination capacity (pathologically repetitive input), the
        batch runs down the replicate path instead — counts are identical
        either way.

        Banding is intentionally unsupported: hash-space sharding over the
        mesh supersedes it.  A mask must be a ShardedSketch on the same
        mesh (see :meth:`from_sketch`).
        """
        if numbands:
            raise ValueError(
                'banding is superseded by mesh sharding for ShardedSketch')
        if route not in (None, 'alltoall', 'replicate'):
            raise ValueError('route must be "alltoall" or "replicate"')
        if mask is not None and not (
                isinstance(mask, ShardedSketch) and mask.mesh == self.mesh):
            raise ValueError('sharded consume requires a sharded mask on the '
                             'same mesh (ShardedSketch.from_sketch)')
        codes = self._codes(bases)
        if codes.shape[0] == 0:
            return
        with self.consuming():
            if mask is None and route != 'replicate':
                cap = int(a2a_capacity or routing_capacity(
                    self.mesh.shape['data'], self.mesh.shape['shard'],
                    self._ksize, codes.shape))
                if self._consume_routed(codes, cap):
                    self.batches['routed'] += 1
                    return
                self.batches['overflowed'] += 1
            self._consume_replicate(codes, mask, int(mask_threshold),
                                    consume_masked)
            self.batches['replicated'] += 1

    def _windows(self, codes):
        return codes.shape[0] * max(codes.shape[1] - self._ksize + 1, 0)

    def _consume_routed(self, codes, cap):
        """The routed consume of one batch; False, with nothing added, when
        a bin overflows ``cap``."""
        mesh = self.mesh
        n_shard = mesh.shape['shard']
        codes = _pad_rows(codes, mesh.shape['data'] * n_shard)
        hashed = _hash_rows(mesh, codes, self._ksize, both_axes=True)
        routed = _grid(mesh, lambda d, s: sketch_ops.route(
            *hashed[d][s], self.ntables, n_shard, self.shard_size,
            self.tablesize, cap))
        top = collectives.pmax(mesh, _grid(
            mesh, lambda d, s: routed[d][s][1].max().reshape(1)), 'shard')
        top = collectives.pmax(mesh, top, 'data')
        d, s = mesh.local_cells()[0]
        # the mesh's largest bin, the same on every rank: all take one path
        if int(top[d][s]) > cap:
            return False
        parts, pops = collectives.all_to_all_parts(
            mesh, _grid(mesh, lambda d, s: routed[d][s][0]),
            _grid(mesh, lambda d, s: routed[d][s][1]))
        self._acc.make_room(self._windows(codes))
        for d, s in mesh.local_cells():
            sketch_ops.scatter_add_parts(self._acc.acc[d][s], parts[d][s],
                                         pops[d][s])
        return True

    def _consume_replicate(self, codes, mask, threshold, consume_masked):
        mesh = self.mesh
        codes = _pad_rows(codes, mesh.shape['data'])
        hashed = _hash_rows(mesh, codes, self._ksize)
        mcnt = None
        if mask is not None:
            local = _grid(mesh, lambda d, s: sketch_ops.gather_counts_multi(
                [mask._spec(d, s)], *hashed[d][s][:2])[0])
            mcnt = collectives.pmin(mesh, local, 'shard')
        self._acc.make_room(self._windows(codes))
        for d, s in mesh.local_cells():
            sketch_ops.consume_hashes(
                self._acc.acc[d][s], *hashed[d][s],
                mcnt=None if mcnt is None else mcnt[d][s],
                mask_threshold=threshold, consume_masked=consume_masked,
                total=self.tablesize, lo=s * self.shard_size)

    def _gather(self, codes, sketches, bits=None):
        """Counts of every window of ``codes`` (padded to a multiple of the
        data rows) in ``sketches`` (sharded alike, this one among them): per
        data row ``d``, on device ``(d, 0)``, uint8 [len(sketches), N_d] and
        the windows' validity (None where another rank owns ``(d, 0)``).
        With ``bits``, every sketch's rows are read at that counter width,
        no wider than their own: a wider sketch's first bytes as counters
        of ``bits``."""
        mesh = self.mesh
        hashed = _hash_rows(mesh, codes, self._ksize)

        def spec(sk, d, s):
            out = sk._spec(d, s)
            if bits is None or bits == out[1]:
                return out
            width = sketch_ops.packed_width(out[4], bits)
            return (out[0][:, :width].contiguous(), bits) + out[2:]

        local = _grid(mesh, lambda d, s: sketch_ops.gather_counts_multi(
            [spec(sk, d, s) for sk in sketches], *hashed[d][s][:2]))
        counts = collectives.pmin(mesh, local, 'shard')
        return [(counts[d][0], hashed[d][0][2]) if mesh.is_local(d, 0)
                else None for d in range(mesh.shape['data'])]

    def query_batch(self, bases):
        """Counts for every window of a [B, L] batch: uint8 ``[B, P]`` (0
        at invalid windows) and uint8 validity, on every rank, on its
        first device of the mesh."""
        self._check_open()
        mesh = self.mesh
        codes = self._codes(bases)
        B, L = codes.shape
        P = L - self._ksize + 1
        rows = self._gather(_pad_rows(codes, mesh.shape['data']), [self])
        rows = collectives.share(
            mesh, [r and torch.stack([r[0][0], r[1]]).reshape(2, -1, P)
                   for r in rows],
            [mesh.ranks[d][0] for d in range(mesh.shape['data'])])
        counts, valid = torch.cat([r.to(self.device) for r in rows],
                                  dim=1)[:, :B]
        return counts * valid, valid


def sharded_novel_screen(mesh, case_sketches, ctrl_sketches, bases, lengths,
                         casemin, ctrlmax, screen=None):
    """The full novel screen over sharded sketches.

    All sketches must share mesh, tablesize and ksize.  Every sketch is
    read at the first one's counter width, as ``kevlar_tpu`` reads them
    (``_screen_step``); a sketch narrower than the first raises (there it
    fails, or reads past that sketch's rows).  One range-aware K2
    launch per shard gathers every sample's counts, a ``pmin`` over
    'shard' picks the owners', and each data row applies the single-device
    screen's predicates and compacts its hits on its device
    (:func:`kevlar_tpu_torch.ops.novel_ops.screen_predicates`,
    :func:`~kevlar_tpu_torch.ops.novel_ops.compact_hits`).  Returns
    ``(hits, hit_abunds, discard)`` on every rank, on its first device of
    the mesh, as
    :func:`kevlar_tpu_torch.ops.novel_ops.novel_screen` does: ``hits`` are
    the nonzero flat indices of ``kevlar_tpu``'s interesting ``[B, P]``
    array, ``hit_abunds`` its abundances there.
    """
    samples = list(case_sketches) + list(ctrl_sketches)
    s0 = samples[0]
    for sk in samples:
        if (sk.mesh != mesh or sk.tablesize != s0.tablesize
                or sk.ksize() != s0.ksize()):
            raise ValueError('the screen\'s sketches differ in mesh, '
                             'tablesize or ksize')
        sk._check_open()
    bits = s0.counter_bits
    if any(sk.counter_bits < bits for sk in samples):
        raise ValueError('a sketch narrower than the first: kevlar_tpu reads '
                         'every sketch at the first one\'s counter width, '
                         'past the narrower one\'s rows')
    ksize = s0.ksize()
    codes = s0._codes(bases)
    lengths = torch.as_tensor(np.asarray(lengths, dtype=np.int32)) \
        if not torch.is_tensor(lengths) else lengths
    B, L = codes.shape
    P = L - ksize + 1
    n_data = mesh.shape['data']
    codes, lengths = _pad_rows(codes, n_data, lengths.to(codes.device))
    r = codes.shape[0] // n_data
    hits, hit_abunds, discard = [], [], []
    for d, row in enumerate(s0._gather(codes, samples, bits)):
        if row is None:
            for out in (hits, hit_abunds, discard):
                out.append(None)
            continue
        counts, valid = row
        dev = counts.device
        counts = counts.reshape(len(samples), r, P)
        interesting, row_discard, _ = novel_ops.screen_predicates(
            counts, len(case_sketches), valid.reshape(r, P) != 0,
            codes[d * r:(d + 1) * r].to(dev),
            lengths[d * r:(d + 1) * r].to(dev), ksize, casemin, ctrlmax,
            screen)
        # the padding rows have length 0: skipped, so never a hit
        row_hits, row_abunds = novel_ops.compact_hits(counts, interesting)
        hits.append(row_hits + d * r * P)
        hit_abunds.append(row_abunds)
        discard.append(row_discard)
    owners = [mesh.ranks[d][0] for d in range(n_data)]
    hits, hit_abunds, discard = (
        [x.to(s0.device) for x in collectives.share(mesh, out, owners)]
        for out in (hits, hit_abunds, discard))
    return (torch.cat(hits), torch.cat(hit_abunds, dim=1),
            torch.cat(discard)[:B])
