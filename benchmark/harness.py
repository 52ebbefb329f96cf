"""One cell of the benchmark: set-up, the measured window, the check
against the plain reference and the metrics, all found by name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``: the trio's sizes and the
sketches' settings.  Its traffic mix is ``workloads/<cell>.json``: the
stages of one step, run back to back in a closed loop, and the stages run
once in set-up.  A stage is ``count`` (one sample's reads counted into a
fresh sketch by ``Sketch.consume_batch_stack``, masked where the
configuration has a mask) or ``screen`` (``novel.novel`` over case and
control sketches, the case's reads in host batches as the reader leaves
them).  Each metric is read by ``metrics/<name>.py``'s ``read(ctx)``.
"""

import gc
import importlib.util
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
        self.sketches = {}
        self.digests = {}
        self.host_spans = []
        self.outputs = []
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
        # every stage of a step on the first batches of its reads: the
        # launches, shapes and allocations of a whole step, in a fraction
        # of its time
        for stage in self.traffic['step']:
            self._run(stage, warm=WARM_BATCHES)
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
        else:
            raise ValueError('no stage {!r}'.format(stage['stage']))

    @property
    def spans(self):
        """Seconds of each layer's calls, ``{'count': [...], 'screen':
        [...]}``, from the host spans."""
        out = {'count': [], 'screen': []}
        for start, end, name in self.host_spans:
            out[name.split('::')[1].split('.')[0]].append((end - start) / 1e9)
        return out

    def _count(self, name, rows, warm=None):
        self.sketches.pop(name, None)
        stack = self.trio.stack(name, rows)[:warm]
        start = time.time_ns()
        sk = self._new_sketch()
        sk.consume_batch_stack(stack, mask=self.mask)
        self._sync()
        self.host_spans.append((start, time.time_ns(), 'bench::count.' +
                                name))
        self.sketches[name] = sk
        if warm is None:
            # outside the span: ``count_s`` times the system alone
            self.digests.setdefault(name, []).append(digest(sk.tables))
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
            None, [self.sketches[n] for n in case],
            [self.sketches[n] for n in controls], ksize=self.ksize,
            casemin=int(spec['case_min']), ctrlmax=int(spec['ctrl_max']),
            batchstream=batches, emit='text'))
        self._sync()
        self.host_spans.append((start, time.time_ns(), 'bench::screen'))
        self._keep(case[0], blocks)

    def _keep(self, case, blocks):
        """Count a screen's text blocks in, keeping each distinct output of
        a case once: a sound run holds one, whatever its number of steps."""
        for output in self.outputs:
            if output[0] == case and output[2] == blocks:
                output[1] += 1
                return
        self.outputs.append([case, 1, blocks])

    def step(self):
        """One trio through the traffic's stages."""
        for stage in self.traffic['step']:
            self._run(stage)

    def reads_per_step(self):
        """Reads the step's stages carry: each sample's once."""
        names = set()
        for stage in self.traffic['step']:
            if stage['stage'] == 'count':
                names.add(stage['sample'])
            else:
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

        Compared: the mask the set-up made, every sample sketch of the last
        step bucket by bucket and each earlier step's by its digest against
        the last's, and the screen's output of every step.  Returns ``(checks,
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
            checks['mask_buckets_off'] = int((got != ref_mask).sum()) \
                if got.shape == ref_mask.shape else int(ref_mask.numel())
        outputs = [(case, times, ''.join(blocks))
                   for case, times, blocks in self.outputs]
        self.outputs = None
        stats = {'count': [], 'screen': []} if launch_stats else None
        spec = self.config['sketch']
        maxcount = (1 << int(spec['counter_bits'])) - 1
        ref_tables = {}
        off = 0
        count_stages = [s for s in self._stages() if s['stage'] == 'count']
        for stage in count_stages:
            name = stage['sample']
            touched = [] if stats is not None else None
            ref = countmin.count(
                list(self.trio.stack(name, int(stage['rows']))), self.ksize,
                int(spec['ntables']), self.tablesize, maxcount,
                mask=ref_mask, touched=touched)
            sk = self.sketches[name]
            got = countmin.unpack(sk.tables, sk.counter_bits, sk.tablesize)
            off += int((got != ref).sum()) if got.shape == ref.shape \
                else int(ref.numel())
            ref_tables[name] = ref
            if stats is not None and stage in self.traffic['step']:
                for codes, (kept, distinct) in zip(
                        self.trio.stack(name, int(stage['rows'])), touched):
                    stats['count'].append({
                        'codes_bytes': codes.numel(), 'kept': kept,
                        'distinct': distinct, 'ntables': ref.shape[0],
                        'buckets': ref.numel()})
        checks['table_buckets_off'] = off
        # a step whose sketch differs from the last step's (which was
        # compared in full) is wrong, whatever its screen found
        unlike = set()
        for name, digests in self.digests.items():
            last = digests[-1].cpu()
            for step, d in enumerate(digests):
                if not torch.equal(d.cpu(), last):
                    unlike.add(step)
        checks['table_digests_off'] = len(unlike)
        missing = extra = wrong = 0
        failed = 0
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
                rows if stats is not None else 16 * rows, words=words)
            expected = dict(zip(zip(read.tolist(), offset.tolist()),
                                map(tuple, counts.t().tolist())))
            codes = self.host_codes[case]
            letters = np.frombuffer(b'ACGTN', dtype=np.uint8)

            def sequence_of(i, codes=codes, n=n):
                if not 0 <= i < n:
                    raise IndexError(i)
                row = codes[i, :self.trio.readlen]
                return letters[np.minimum(row, 4)].tobytes().decode()

            for who, times, text in outputs:
                if who != case:
                    continue
                m, e, w = judge.compare(text, expected, sequence_of,
                                        reads_mod.index_of, self.ksize)
                missing += times * m
                extra += times * e
                wrong += times * w
                if m or e or w:
                    failed += times
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
        checks['hits_missing'] = missing
        checks['hits_extra'] = extra
        checks['hits_wrong'] = wrong
        if checks['table_buckets_off'] or checks.get('mask_buckets_off'):
            failed = max(failed, 1)
        failed = max(failed, len(unlike))
        seen = sum(times for _, times, _ in outputs)
        screens = sum(s['stage'] == 'screen' for s in self.traffic['step'])
        checks['screens_unseen'] = self.steps * screens - seen
        self.launch_stats = stats
        return checks, failed


def verdict(checks, limits, steps):
    """``(correct, compared)``: each number compared beside its limit, and
    whether the window ran a step and every number is within its limit."""
    compared = {name: {'value': value, 'limit': limits[name]}
                for name, value in checks.items()}
    correct = steps > 0 and all(c['value'] <= c['limit']
                                for c in compared.values())
    return correct, compared


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
