"""One cell of the benchmark: set-up, the measured window, the check
against the plain reference and the metrics, all found by name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``: the trio's sizes and the
sketches' settings.  Its traffic mix is ``workloads/<cell>.json``: the
stages of one step, run back to back in a closed loop, and the stages run
once in set-up.  A stage is ``count`` (one sample's reads counted into a
fresh sketch by ``Sketch.consume_batch_stack``, masked where the
configuration has a mask), ``screen`` (``novel.novel`` over case and
control sketches, the case's reads in host batches as the reader leaves
them) or ``unband``.  Each metric is read by ``metrics/<name>.py``'s
``read(ctx)``.

A configuration with ``bands`` (N, a power of two, kevlar's
``--num-bands``) runs in hash bands, as ``kevlar count`` and ``kevlar
novel`` run with ``--num-bands N --band b+1``: its ``sketch.memory`` is
one band's sketch, and a step runs the traffic's count and screen stages
once for each band b = 0 .. N-1 in order, dropping band b's sketches
before band b+1's first count, so one band's trio lives on the card at a
time.  Its ``unband`` stages (``{"stage": "unband", "case": <sample>,
"batches": <n>}``, ``kevlar unband -n``) then merge the case's N screen
outputs of the step, once, after the last band.
"""

import gc
import importlib.util
import io
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import judge
from benchmark import trace as trace_mod
from benchmark.reference import countmin
from benchmark.traffic import reads as reads_mod
from benchmark.traffic.trio import Trio

HERE = os.path.dirname(os.path.abspath(__file__))
# batches of each stage's reads that set-up runs to warm the window's path
WARM_BATCHES = 4


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def cell_files(name, bench, here=HERE):
    """``(entry, config, traffic)`` of cell ``name`` of ``bench`` (the
    parsed ``BENCHMARK.json``), from the files named after it."""
    entries = [w for w in bench['workloads'] if w['name'] == name]
    if len(entries) != 1:
        raise KeyError('no cell {!r} in BENCHMARK.json'.format(name))
    entry = entries[0]
    config = load_json(os.path.join(here, 'configs', entry['config'] +
                                    '.json'))
    traffic = load_json(os.path.join(here, 'workloads', name + '.json'))
    if traffic.get('traffic') != entry['traffic']:
        raise ValueError('workloads/{}.json is traffic {!r}, the cell names '
                         '{!r}'.format(name, traffic.get('traffic'),
                                       entry['traffic']))
    return entry, config, traffic


def cell_metrics(name, bench, kind):
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``name``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if name in m.get('workloads', [name])]


def reader(metric, here=HERE):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(here, 'metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark.metrics.' + metric.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Cell:
    """The system under test driven through one cell's traffic.

    ``counter_bits`` replaces the configuration's counter width of the
    sample sketches, at the same number of buckets: the control's lower
    precision (the harness's own runs never set it)."""

    def __init__(self, config, traffic, seed, device, counter_bits=None):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.ksize = int(config['ksize'])
        self.counter_bits = counter_bits
        self.bands = _bands(config, traffic)
        self.band = None
        # the cases whose band outputs an unband stage merges
        self.unbands = [s['case'] for s in traffic['step']
                        if s['stage'] == 'unband']
        # sketches and digests by (sample, band), band None where unbanded;
        # outputs as [(case, band or 'unband'), times, text blocks]
        self.sketches = {}
        self.digests = {}
        self.host_spans = []
        self.outputs = []
        self.band_texts = {}
        self.steps = 0
        self.mask = None
        self.host_codes = {}

    # -- set-up -----------------------------------------------------------
    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _stages(self):
        return list(self.traffic.get('setup', [])) + \
            list(self.traffic['step'])

    def setup(self):
        """Build the kernels, make the inputs from the seed, run the set-up
        stages, and warm every shape the window uses (each stage of a step
        over its first batches).  The seconds of each part go to
        ``setup_parts``."""
        from kevlar_tpu_torch import novel, sketch
        parts = self.setup_parts = {}
        clock = time.perf_counter()

        def done(part):
            nonlocal clock
            self._sync()
            now = time.perf_counter()
            parts[part] = now - clock
            clock = now

        if self.device.type == 'cuda':
            from kevlar_tpu_torch.ops import kmer_cuda
            kmer_cuda.build()
            torch.zeros(1, device=self.device)
        done('build')
        rows = {s['rows'] for s in self._stages() if s['stage'] == 'count'}
        if len(rows) > 1:
            raise ValueError('count stages of one cell share their rows')
        self.count_rows = rows.pop() if rows else 1
        self.trio = Trio(self.config, self.seed, self.device,
                         self.count_rows)
        self.tablesize = _tablesize(self.config['sketch'])
        done('inputs')
        mask = self.config.get('mask')
        if mask:
            self.mask = sketch.allocate_from_memory(
                self.ksize, int(mask['memory']), int(mask['ntables']),
                counter_bits=int(mask['counter_bits']), device=self.device)
            self.mask_rows = self.trio.genome_rows(
                self.ksize, int(mask['row_width']), int(mask['batch_rows']))
            self.mask.consume_batch_stack(self.mask_rows)
        done('mask')
        self.batches = {}
        for stage in self._stages():
            if stage['stage'] == 'screen':
                for name in stage['case']:
                    self.batches[name] = self._host_batches(
                        novel, name, int(stage['rows']))
        done('host_batches')
        for stage in self.traffic.get('setup', []):
            self._run(stage)
        # every stage of a step (of one band) on the first batches of its
        # reads: the launches, shapes and allocations of a whole step, in a
        # fraction of its time
        self._pass([0] if self.bands else [None], warm=WARM_BATCHES)
        done('warm_up')
        self.digests = {}
        self.host_spans = []
        self.outputs = []
        # the inputs and host batches live to the end: keep the collector
        # from walking them again and again inside the window
        gc.collect()
        gc.freeze()

    def _host_batches(self, novel, name, rows):
        """A sample's reads as the reader's batches of ``rows`` reads: base
        codes, lengths, names and qualities in host memory."""
        n = self.trio.nreads[name]
        codes = self.trio.reads[name][:n].cpu().numpy()
        readlen, width = self.trio.readlen, self.trio.width
        lengths = np.full(rows, readlen, dtype=np.int32)
        quals = reads_mod.qualities(readlen, width)
        out = []
        for first in range(0, n, rows):
            m = min(rows, n - first)
            out.append(novel._NativeBatch(
                codes[first:first + m], lengths[:m],
                reads_mod.ReadNames(first, m),
                np.broadcast_to(quals, (m, width)), rows))
        self.host_codes[name] = codes
        return out

    # -- the stages ---------------------------------------------------------
    def _new_sketch(self):
        from kevlar_tpu_torch import sketch
        spec = self.config['sketch']
        if self.counter_bits is None:
            return sketch.allocate_from_memory(
                self.ksize, int(spec['memory']), int(spec['ntables']),
                counter_bits=int(spec['counter_bits']), device=self.device)
        return sketch.Sketch(self.ksize, self.tablesize,
                             int(spec['ntables']),
                             counter_bits=self.counter_bits,
                             device=self.device)

    def _run(self, stage, warm=None):
        """Run one stage; ``warm``, where given, runs it on the first
        ``warm`` batches of its reads alone."""
        if stage['stage'] == 'count':
            self._count(stage['sample'], int(stage['rows']), warm)
        elif stage['stage'] == 'screen':
            self._screen(stage['case'], stage['controls'], warm)
        elif stage['stage'] == 'unband':
            self._unband(stage['case'], int(stage['batches']))
        else:
            raise ValueError('no stage {!r}'.format(stage['stage']))

    @property
    def spans(self):
        """Seconds of each layer's calls, ``{'count': [...], 'screen':
        [...], 'unband': [...]}``, from the host spans."""
        out = {'count': [], 'screen': [], 'unband': []}
        for start, end, name in self.host_spans:
            out[name.split('::')[1].split('.')[0]].append((end - start) / 1e9)
        return out

    def _band_args(self):
        """The band's arguments of a count or a screen: none unbanded."""
        if self.band is None:
            return {}
        return {'numbands': self.bands, 'band': self.band}

    def _count(self, name, rows, warm=None):
        key = (name, self.band)
        self.sketches.pop(key, None)
        stack = self.trio.stack(name, rows)[:warm]
        start = time.time_ns()
        sk = self._new_sketch()
        sk.consume_batch_stack(stack, mask=self.mask, **self._band_args())
        self._sync()
        self.host_spans.append((start, time.time_ns(), 'bench::count.' +
                                name))
        self.sketches[key] = sk
        if warm is None:
            # outside the span: ``count_s`` times the system alone
            self.digests.setdefault(key, []).append(digest(sk.tables))
            self._sync()

    def _screen(self, case, controls, warm=None):
        from kevlar_tpu_torch import novel
        spec = self.config['novel']
        batches = self.batches[case[0]]
        if warm:
            # and the last batch: the only one with padding rows
            batches = batches[:warm] + batches[-1:]
        start = time.time_ns()
        blocks = list(novel.novel(
            None, [self.sketches[n, self.band] for n in case],
            [self.sketches[n, self.band] for n in controls],
            ksize=self.ksize, casemin=int(spec['case_min']),
            ctrlmax=int(spec['ctrl_max']), batchstream=batches,
            emit='text', **self._band_args()))
        self._sync()
        self.host_spans.append((start, time.time_ns(), 'bench::screen'))
        self._keep((case[0], self.band), blocks)
        if case[0] in self.unbands:
            self.band_texts.setdefault(case[0], []).append(blocks)

    def _unband(self, case, nbatches):
        """``kevlar unband`` over the case's band outputs of this step, as
        ``unband.main`` runs it: each output's augmented text parsed, the
        records merged through ``nbatches`` spilled buckets, and written."""
        import kevlar_tpu_torch
        from kevlar_tpu_torch import unband
        texts = self.band_texts.pop(case, [])
        start = time.time_ns()
        records = (record for blocks in texts
                   for record in kevlar_tpu_torch.parse_augmented_fastx(
                       io.StringIO(''.join(blocks))))
        out = io.StringIO()
        for record in unband.unband(records, nbatches):
            kevlar_tpu_torch.print_augmented_fastx(record, out)
        self.host_spans.append((start, time.time_ns(), 'bench::unband'))
        self._keep((case, 'unband'), [out.getvalue()])

    def _keep(self, key, blocks):
        """Count an output's text blocks in, keeping each distinct output
        of a key (a case and its band, or its merge) once: a sound run
        holds one, whatever its number of steps."""
        for output in self.outputs:
            if output[0] == key and output[2] == blocks:
                output[1] += 1
                return
        self.outputs.append([key, 1, blocks])

    def _pass(self, bands, warm=None):
        """The step's count and screen stages once for each of ``bands``
        (``[None]`` unbanded), a band's trio dropped as the next band
        starts, then its unband stages."""
        for band in bands:
            if band is not None:
                self.sketches.clear()
            self.band = band
            for stage in self.traffic['step']:
                if stage['stage'] != 'unband':
                    self._run(stage, warm)
        for stage in self.traffic['step']:
            if stage['stage'] == 'unband':
                self._run(stage, warm)

    def step(self):
        """One trio through the traffic's stages, band by band where the
        configuration has bands."""
        self._pass(range(self.bands) if self.bands else [None])

    def reads_per_step(self):
        """Reads the step's stages carry: each sample's once, however many
        bands read it."""
        names = set()
        for stage in self.traffic['step']:
            if stage['stage'] == 'count':
                names.add(stage['sample'])
            elif stage['stage'] == 'screen':
                names.update(stage['case'])
        return sum(self.trio.nreads[n] for n in names)

    # -- the window ---------------------------------------------------------
    def window(self, seconds, trace=False):
        """Steps back to back until the first step boundary past
        ``seconds``; with ``trace``, under the profiler, recording the
        card's activity."""
        from kevlar_tpu_torch.ops import kmer_cuda
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)
        before = dict(kmer_cuda.launches)
        self.host_spans = []
        prof = None
        if trace and self.device.type == 'cuda':
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        try:
            start, t0 = time.time_ns(), time.perf_counter()
            while True:
                self.step()
                self.steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            self._sync()
            end, self.window_s = time.time_ns(), time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        self.peak_window = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == 'cuda' else None
        self.launches = {k: v - before.get(k, 0)
                         for k, v in kmer_cuda.launches.items()}
        self.trace = None
        if prof is not None:
            cuda = torch.autograd.DeviceType.CUDA
            self.trace = trace_mod.reduce(
                prof.profiler.kineto_results.events(),
                lambda e: e.device_type() == cuda, (start, end),
                self.host_spans)

    # -- the check ------------------------------------------------------------
    def check(self, launch_stats=False):
        """Hold what the window produced against the plain reference.

        Compared, band by band (one band's reference tables at a time):
        the mask the set-up made, every step's sample sketches by their
        digest against the reference's and the sketches the window left
        (the last band's) bucket by bucket, every step's screen output,
        and every step's merge of the bands' outputs.  Returns ``(checks,
        failed)``: each number compared with its limit, and the steps whose
        output was wrong.  With ``launch_stats``, also gathers the
        statistics of each launch of a step that the rooflines read."""
        gc.unfreeze()
        ref_mask = None
        checks = {}
        cfg_mask = self.config.get('mask')
        self.batches = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        if cfg_mask:
            ref_mask = countmin.count(
                list(self.mask_rows), self.ksize, int(cfg_mask['ntables']),
                _tablesize(cfg_mask), 1)
            got = countmin.unpack(self.mask.tables, self.mask.counter_bits,
                                  self.mask.tablesize)
            checks['mask_buckets_off'] = _buckets_off(got, ref_mask)
        outputs = [(key, times, ''.join(blocks))
                   for key, times, blocks in self.outputs]
        self.outputs = None
        stats = {'count': [], 'screen': []} if launch_stats else None
        screens = sum(s['stage'] == 'screen' for s in self.traffic['step'])
        # the last band first: its check frees the sketches the window left
        # before the other bands' reference tables are made
        bands = [self.bands - 1] + list(range(self.bands - 1)) \
            if self.bands else [None]
        tally = _Tally(self.unbands)
        for band in bands:
            self._check_band(band, ref_mask, outputs, stats, tally)
        checks['table_buckets_off'] = tally.buckets_off
        checks['table_digests_off'] = len(tally.unlike)
        checks['hits_missing'] = tally.missing
        checks['hits_extra'] = tally.extra
        checks['hits_wrong'] = tally.wrong_hits
        wrong = tally.wrong
        if self.unbands:
            merged_off = 0
            for case, hits in tally.band_hits.items():
                expected = countmin.unband(hits)
                for key, times, text in outputs:
                    if key != (case, 'unband'):
                        continue
                    n = judge.compare_merged(text, expected,
                                             self._sequence_of(case),
                                             reads_mod.index_of, self.ksize)
                    merged_off += times * n
                    if n:
                        wrong[key] = wrong.get(key, 0) + times
            checks['merged_off'] = merged_off
        # each output key is made once a step: its wrong outputs' times are
        # the steps it was wrong in
        failed = max(wrong.values(), default=0)
        if checks['table_buckets_off'] or checks.get('mask_buckets_off'):
            failed = max(failed, 1)
        failed = max(failed, len(tally.unlike))
        seen = sum(times for _, times, _ in outputs)
        checks['screens_unseen'] = self.steps * (
            screens * len(bands) + len(self.unbands)) - seen
        self.launch_stats = stats
        return checks, failed

    def _check_band(self, band, ref_mask, outputs, stats, tally):
        """One band's part of :meth:`check` (``band`` None unbanded): its
        reference tables, made here and dropped on return, against the
        step's digests, the sketches the window left and the screens'
        outputs, counted into ``tally``."""
        where = None if band is None else (band, self.bands)
        spec = self.config['sketch']
        ref_tables = {}
        for stage in self._stages():
            if stage['stage'] != 'count':
                continue
            name = stage['sample']
            touched = [] if stats is not None else None
            ref = countmin.count(
                list(self.trio.stack(name, int(stage['rows']))), self.ksize,
                int(spec['ntables']), self.tablesize,
                (1 << int(spec['counter_bits'])) - 1, mask=ref_mask,
                touched=touched, band=where)
            # a step whose sketch differs from the reference's is wrong,
            # whatever its screen found
            want = digest(countmin.pack(ref, int(spec['counter_bits']))).cpu()
            for step, d in enumerate(self.digests.get((name, band), [])):
                if not torch.equal(d.cpu(), want):
                    tally.unlike.add(step)
            sk = self.sketches.pop((name, band), None)
            if sk is not None:
                got = countmin.unpack(sk.tables, sk.counter_bits,
                                      sk.tablesize)
                tally.buckets_off += _buckets_off(got, ref)
                del got, sk
            ref_tables[name] = ref
            if stats is not None and stage in self.traffic['step']:
                for codes, (kept, distinct) in zip(
                        self.trio.stack(name, int(stage['rows'])), touched):
                    stats['count'].append({
                        'codes_bytes': codes.numel(), 'kept': kept,
                        'distinct': distinct, 'ntables': ref.shape[0],
                        'buckets': ref.numel()})
        for stage in self.traffic['step']:
            if stage['stage'] != 'screen':
                continue
            case = stage['case'][0]
            rows = int(stage['rows'])
            samples = [ref_tables[n] for n in stage['case'] +
                       stage['controls']]
            n = self.trio.nreads[case]
            words = [] if stats is not None else None
            read, offset, counts = countmin.screen(
                self.trio.reads[case][:n], samples, len(stage['case']),
                self.ksize, int(self.config['novel']['case_min']),
                int(self.config['novel']['ctrl_max']),
                rows, words=words, band=where)
            expected = dict(zip(zip(read.tolist(), offset.tolist()),
                                map(tuple, counts.t().tolist())))
            for key, times, text in outputs:
                if key != (case, band):
                    continue
                m, e, w = judge.compare(text, expected,
                                        self._sequence_of(case),
                                        reads_mod.index_of, self.ksize)
                tally.missing += times * m
                tally.extra += times * e
                tally.wrong_hits += times * w
                if m or e or w:
                    tally.wrong[key] = tally.wrong.get(key, 0) + times
            if case in tally.band_hits:
                tally.band_hits[case].append((read, offset, counts))
            if stats is not None:
                windows = self.trio.readlen - self.ksize + 1
                per_batch = np.bincount(read.cpu().numpy() // rows,
                                        minlength=len(words))
                for b, nwords in enumerate(words):
                    nrows = min(rows, n - b * rows)
                    stats['screen'].append({
                        'codes_bytes': rows * self.trio.width,
                        'lengths_bytes': 4 * rows, 'words': nwords,
                        'hits': int(per_batch[b]), 'rows': rows,
                        'samples': len(samples),
                        'windows': nrows * windows})

    def _sequence_of(self, case):
        """``sequence_of(i)``: read ``i`` of ``case`` as base letters."""
        codes, n = self.host_codes[case], self.trio.nreads[case]
        letters = np.frombuffer(b'ACGTN', dtype=np.uint8)

        def sequence_of(i):
            if not 0 <= i < n:
                raise IndexError(i)
            row = codes[i, :self.trio.readlen]
            return letters[np.minimum(row, 4)].tobytes().decode()
        return sequence_of


class _Tally:
    """What :meth:`Cell.check` counts over the bands: buckets and hits off,
    the steps whose digests differ, the steps each output key was wrong in,
    and each band's reference hits of a case that a merge reads."""

    def __init__(self, unbands):
        self.buckets_off = self.missing = self.extra = self.wrong_hits = 0
        self.unlike = set()
        self.wrong = {}
        self.band_hits = {case: [] for case in unbands}


def verdict(checks, limits, steps):
    """``(correct, compared)``: each number compared beside its limit, and
    whether the window ran a step and every number is within its limit."""
    compared = {name: {'value': value, 'limit': limits[name]}
                for name, value in checks.items()}
    correct = steps > 0 and all(c['value'] <= c['limit']
                                for c in compared.values())
    return correct, compared


def _bands(config, traffic):
    """The configuration's number of hash bands, None where it has none;
    raises where the bands or the traffic's stages cannot run."""
    stages = list(traffic.get('setup', [])) + list(traffic['step'])
    unband = any(s['stage'] == 'unband' for s in stages)
    if 'bands' not in config:
        if unband:
            raise ValueError('an unband stage needs a configuration with '
                             'bands')
        return None
    n = int(config['bands'])
    if n < 2 or n & (n - 1):
        raise ValueError('bands is a power of two of 2 or more, not '
                         '{}'.format(n))
    if traffic.get('setup'):
        raise ValueError('a banded cell counts and screens in its step: '
                         'set-up stages would leave one band\'s sketches')
    return n


def _buckets_off(got, ref):
    """Buckets of counter values ``got`` that differ from ``ref``'s (all of
    them where the shapes differ), a slice at a time: the comparison of a
    whole table, summed, would make a temporary of 8 bytes a bucket."""
    if got.shape != ref.shape:
        return int(ref.numel())
    return sum(int((a != b).sum()) for a, b in zip(
        got.reshape(-1).split(1 << 27), ref.reshape(-1).split(1 << 27)))


def digest(tables):
    """A sketch's packed tables summed on their device as 32-bit words, all
    of them and every other one: an increment lost or added changes the
    first sum, a count moved to another bucket one of the two, unless it
    moved by a multiple of 8 bytes.  Reads the tables twice, about half
    a millisecond a helium sketch on the card."""
    flat = tables.reshape(-1)
    if flat.numel() % 4 == 0:
        flat = flat.view(torch.int32)
    return torch.stack([flat.sum(dtype=torch.int64),
                        flat[::2].sum(dtype=torch.int64)])


def _tablesize(spec):
    """Buckets a table of a sample sketch: khmer's sizing, as
    ``kevlar_tpu_torch.sketch.allocate_from_memory`` sizes it (the
    configuration's memory over the tables, times the buckets a byte holds
    at its counter width, made odd)."""
    per_byte = 8 // int(spec['counter_bits'])
    size = int(spec['memory']) // int(spec['ntables']) * per_byte
    return size - 1 if size % 2 == 0 else size
