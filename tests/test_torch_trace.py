"""The span recorder of ``kevlar_tpu_torch.support`` inside the novel stage
and the count: off, it records nothing and reads no clock; on, a novel pass
records each batch's spans in order under one ``novel::pass``, none open
across a yield, with the counters' differences; producer threads record
spans of their own; ``--profile`` bridges the spans into its chrome trace;
``unband`` records its spill and one merge a bucket under one
``unband::pass``.  All on the CPU, at a few hundred reads."""

import functools
import io
import json
import os
import random
import threading
import time
import types

import numpy as np
import pytest

import kevlar_tpu_torch
from kevlar_tpu_torch import cli, count, novel, sketch, support, unband
from kevlar_tpu_torch.ops import novel_ops
from kevlar_tpu_torch.sequence import Record

KSIZE = 21
TABLESIZE = 1009
BATCH = 8
PARTS = ['novel::stage', 'novel::screen', 'novel::sync', 'novel::readback',
         'novel::text']


@pytest.fixture(autouse=True)
def _quiet():
    kevlar_tpu_torch.logstream = None
    yield
    kevlar_tpu_torch.logstream = None


def _reads(seed, nreads=24, readlen=100):
    rng = random.Random(seed)
    genome = ''.join(rng.choice('ACGT') for _ in range(600))
    out = []
    for i in range(nreads):
        start = rng.randrange(len(genome) - readlen)
        out.append(Record(name='r{}'.format(i),
                          sequence=genome[start:start + readlen],
                          quality='I' * readlen))
    return out


@pytest.fixture(scope='module')
def trio():
    """Case and control sketches on the CPU whose tables make about one
    window in two of random reads novel (case counts random, a tenth of
    the control buckets full), and 24 reads: three batches of 8."""
    rng = np.random.default_rng(8)
    case = rng.integers(0, 256, (4, TABLESIZE), dtype=np.uint8)
    ctrl = np.zeros((4, TABLESIZE), np.uint8)
    ctrl[rng.random((4, TABLESIZE)) < 0.1] = 255
    samples = [sketch.Sketch(KSIZE, TABLESIZE, 4, counter_bits=8, tables=t,
                             device='cpu') for t in (case, ctrl, ctrl)]
    return samples, _reads(8)


def _screen(trio, batch_size=BATCH, **kw):
    samples, reads = trio
    return ''.join(novel.novel(iter(reads), samples[:1], samples[1:],
                               ksize=KSIZE, casemin=6, ctrlmax=0,
                               emit='text', batch_size=batch_size, **kw))


def _stack(n=3, rows=16):
    rng = np.random.default_rng(n)
    return rng.integers(0, 4, (n, rows, 100), dtype=np.uint8)


def test_off_records_nothing_and_reads_no_clock(trio, tmp_path, monkeypatch):
    def no_clock():
        raise AssertionError('a span read the clock while recording is off')
    monkeypatch.setattr(support, 'time', types.SimpleNamespace(
        time_ns=no_clock, perf_counter=time.perf_counter))
    before = support.recorded()
    assert support.span('novel::batch') is support.span('count::close')
    assert support.mark('novel::pass') is None
    assert _screen(trio).count('#\n') > 0
    sk = sketch.Sketch(KSIZE, TABLESIZE, 4, device='cpu')
    sk.consume_batch_stack(_stack())
    fastq = tmp_path / 'reads.fq'
    fastq.write_text(''.join('@{}\n{}\n+\n{}\n'.format(
        r.name, r.sequence, r.quality) for r in trio[1]))
    assert count.consume_seqfile(sk, [str(fastq)]) == len(trio[1])
    assert _unband_text().count('#\n') > 0
    assert support.recorded() == before


def test_a_pass_records_each_batch_in_order(trio):
    before = dict(novel.counters)
    with support.recording() as spans:
        text = _screen(trio)
    names = [s.name for s in spans]
    assert names == ['novel::pack', 'novel::pass'] + \
        (['novel::wait', 'novel::batch'] + PARTS) * 3 + ['novel::wait']
    pass_ = spans[1]
    byid = {s.id: s for s in spans}
    for s in spans[2:]:
        if s.name in ('novel::wait', 'novel::batch'):
            assert s.parent == pass_.id
        else:
            assert byid[s.parent].name == 'novel::batch'
            assert byid[s.parent].start_ns <= s.start_ns <= s.end_ns <= \
                byid[s.parent].end_ns
        assert pass_.start_ns <= s.start_ns <= s.end_ns <= pass_.end_ns
    # one after another, in order
    for a, b in zip(spans[2:], spans[3:]):
        if b.parent == a.parent:
            assert a.end_ns <= b.start_ns
    assert pass_.counts == {k: novel.counters[k] - before[k]
                            for k in novel.counters}
    assert pass_.counts['batches'] == 3 and pass_.counts['reads'] == 24
    # on the CPU the ring never waits: the lengths, the hit count and the
    # three copies back
    assert pass_.counts['syncs'] == 5 * 3
    assert pass_.counts['h2d_bytes'] == 3 * BATCH * (128 + 4)
    assert text.count('#\n') > 0


def test_text_is_the_same_with_recording_on_and_off(trio):
    off = _screen(trio)
    with support.recording():
        on = _screen(trio)
    assert on == off and off.count('#\n') > 100


def test_text_counters_of_a_native_pass(trio, tmp_path):
    """A pass over the reader's batches at k 31: ``text_lines`` counts its
    ``#\\n`` lines, no canonical k-mer is left to the host, and the text is
    the same with recording on and off."""
    _, reads = trio
    rng = np.random.default_rng(31)
    case = rng.integers(0, 256, (4, TABLESIZE), dtype=np.uint8)
    ctrl = np.zeros((4, TABLESIZE), np.uint8)
    ctrl[rng.random((4, TABLESIZE)) < 0.1] = 255
    samples = [sketch.Sketch(31, TABLESIZE, 4, counter_bits=8, tables=t,
                             device='cpu') for t in (case, ctrl, ctrl)]
    fastq = tmp_path / 'reads.fq'
    fastq.write_text(''.join('@{}\n{}\n+\n{}\n'.format(
        r.name, r.sequence, r.quality) for r in reads))

    def screen():
        return ''.join(novel.novel(
            None, samples[:1], samples[1:], ksize=31, casemin=6, ctrlmax=0,
            emit='text',
            batchstream=novel.native_read_batches([str(fastq)], BATCH)))

    off = screen()
    with support.recording() as spans:
        on = screen()
    assert on == off and off.count('#\n') > 100
    counts = [s for s in spans if s.name == 'novel::pass'][0].counts
    assert counts['text_lines'] == off.count('#\n')
    assert counts['text_host_kmers'] == 0


def test_records_mode_spans_end_before_its_records(trio):
    samples, reads = trio
    yielded = []
    with support.recording() as spans:
        for _ in novel.novel(iter(reads), samples[:1], samples[1:],
                             ksize=KSIZE, casemin=6, ctrlmax=0,
                             batch_size=BATCH):
            yielded.append(time.time_ns())
    assert yielded
    names = [s.name for s in spans]
    # records stream as they decode, outside the batch: no text span
    assert names.count('novel::batch') == 3 and 'novel::text' not in names
    batches = [s for s in spans if s.name == 'novel::batch']
    for s in spans:
        if s.name != 'novel::pass':
            assert not any(s.start_ns < t < s.end_ns for t in yielded), s
    # the first batch's records come before the second batch is screened
    assert batches[0].end_ns < yielded[0] < batches[1].start_ns


def test_no_span_outlives_a_yield(trio):
    samples, reads = trio
    yielded = []
    with support.recording() as spans:
        for _ in novel.novel(iter(reads), samples[:1], samples[1:],
                             ksize=KSIZE, casemin=6, ctrlmax=0,
                             emit='text', batch_size=BATCH):
            yielded.append(time.time_ns())
    assert len(yielded) == 3
    for s in spans:
        if s.name != 'novel::pass':
            assert not any(s.start_ns < t < s.end_ns for t in yielded), s


def test_pass_counts_are_what_the_metrics_read(trio):
    """The per-pass differences behind ``screen_syncs_per_batch``,
    ``screen_h2d_bytes_per_read`` and ``screen_rescreens``, and the text's
    own two counters."""
    with support.recording() as spans:
        text = _screen(trio, batch_size=12)
    counts = spans[1].counts
    assert spans[1].name == 'novel::pass'
    assert counts == {'batches': 2, 'reads': 24, 'rescreens': 0,
                      'h2d_bytes': 2 * 12 * (128 + 4), 'syncs': 2 * 5,
                      'text_lines': text.count('#\n'), 'text_host_kmers': 0}
    assert counts['batches'] == [s.name for s in spans].count('novel::batch')


def test_capacity_overflow_counts_one_rescreen(trio, monkeypatch):
    want = _screen(trio, batch_size=64)
    monkeypatch.setattr(novel_ops, 'novel_screen_compact', functools.partial(
        novel_ops.novel_screen_compact, max_hits=1))
    before = novel.counters['rescreens']
    with support.recording() as spans:
        got = _screen(trio, batch_size=64)
    assert got == want
    assert novel.counters['rescreens'] - before == 1
    assert [s.name for s in spans].count('novel::rescreen') == 1
    assert spans[1].counts['rescreens'] == 1


def test_producer_threads_record_their_own_spans(trio, tmp_path):
    samples, reads = trio
    fastq = tmp_path / 'reads.fq'
    fastq.write_text(''.join('@{}\n{}\n+\n{}\n'.format(
        r.name, r.sequence, r.quality) for r in reads))
    me = threading.get_ident()
    with support.recording() as spans:
        text = ''.join(novel.novel(
            None, samples[:1], samples[1:], ksize=KSIZE, casemin=6,
            ctrlmax=0, emit='text',
            batchstream=novel.native_read_batches([str(fastq)], BATCH)))
        sk = sketch.Sketch(KSIZE, TABLESIZE, 4, device='cpu')
        count.consume_seqfile(sk, [str(fastq)], batch_size=BATCH)
    assert text == _screen(trio)
    byid = {s.id: s for s in spans}
    for name in ('novel::read', 'count::read'):
        found = [s for s in spans if s.name == name]
        assert len(found) == 4      # three batches, then the end
        assert all(s.thread != me and s.parent is None for s in found)
    for s in spans:
        if s.name not in ('novel::read', 'count::read'):
            assert s.thread == me
    waits = [s for s in spans if s.name == 'count::wait']
    assert len(waits) == 4
    assert {byid[s.parent].name for s in waits} == {'count::consume'}
    # the CPU is the device: its seconds are the host's
    for name in ('count::open', 'count::consume', 'count::close'):
        found = [s for s in spans if s.name == name]
        assert len(found) == 1
        assert found[0].device_s == (found[0].end_ns -
                                     found[0].start_ns) / 1e9


def test_count_records_open_consume_close(monkeypatch):
    sk = sketch.Sketch(KSIZE, TABLESIZE, 4, device='cpu')
    with support.recording() as spans:
        sk.consume_batch_stack(_stack())
    assert [s.name for s in spans] == ['count::open', 'count::consume',
                                       'count::close']
    assert all(s.device_s is not None and s.parent is None for s in spans)


def test_a_profiler_turns_recording_on_without_the_bridge(trio):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _screen(trio)
    names = [s.name for s in support.recorded()]
    assert names.count('novel::sync') == 3
    assert 'novel::sync' not in {e.name for e in prof.events()}


def test_each_profiler_trace_drops_the_last_ones_spans(trio):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            _screen(trio)
        names = [s.name for s in support.recorded()]
        assert names.count('novel::pass') == 1
        assert names.count('novel::sync') == 3
    # two more, with an untraced pass and no reading in between
    with profile(activities=[ProfilerActivity.CPU]):
        _screen(trio)
    _screen(trio)
    with profile(activities=[ProfilerActivity.CPU]):
        _screen(trio)
    assert [s.name for s in support.recorded()].count('novel::pass') == 1


def test_profile_flag_writes_the_novel_spans(trio, tmp_path):
    samples, reads = trio
    paths = []
    for i, sample in enumerate(samples):
        paths.append(str(tmp_path / 's{}.ct'.format(i)))
        sample.save(paths[-1])
    fastq = tmp_path / 'reads.fq'
    fastq.write_text(''.join('@{}\n{}\n+\n{}\n'.format(
        r.name, r.sequence, r.quality) for r in reads))
    tracedir = str(tmp_path / 'trace')
    cli.main(['--profile', tracedir, 'novel', '--device', 'cpu', '-k',
              str(KSIZE), '--case', str(fastq), '--case-counts', paths[0],
              '--control-counts', paths[1], paths[2], '--case-min', '6',
              '--ctrl-max', '0', '--max-fpr', '1.0', '-o', str(tmp_path / 'novel.augfastq')])
    with open(os.path.join(tracedir, 'novel.trace.json')) as fh:
        events = json.load(fh)['traceEvents']
    names = {e.get('name') for e in events}
    assert {'novel::sync', 'novel::text', 'novel::read'} <= names


def _band_records(nreads=40, nbands=3):
    """Each read's hits split over up to ``nbands`` band outputs, as the
    screens of a banded run leave them: one record a read and band."""
    rng = random.Random(12)
    out = []
    for band in range(nbands):
        for i, read in enumerate(_reads(12, nreads)):
            if (i + band) % 3 == 2:
                continue
            record = Record(name=read.name, sequence=read.sequence,
                            quality=read.quality)
            for offset in sorted(rng.sample(range(70), 2)):
                record.annotate(read.sequence[offset:offset + KSIZE], offset,
                                (rng.randint(5, 40), 0, 1))
            out.append(record)
    return out


def _unband_text(nbuckets=4):
    out = io.StringIO()
    for record in unband.unband(iter(_band_records()), nbuckets):
        kevlar_tpu_torch.print_augmented_fastx(record, out)
    return out.getvalue()


def test_unband_records_its_pass_spill_and_merges(monkeypatch):
    monkeypatch.setattr(unband, 'SPILL_CHUNK', 16)
    before = dict(unband.counters)
    with support.recording() as spans:
        _unband_text(nbuckets=4)
    names = [s.name for s in spans]
    nin = len(_band_records())
    # one spill a chunk of 16 records and one for the buckets' close, then
    # one merge a bucket
    assert names == ['unband::pass'] + \
        ['unband::spill'] * (-(-nin // 16) + 1) + ['unband::merge'] * 4
    pass_ = spans[0]
    for s in spans[1:]:
        assert s.parent == pass_.id
        assert pass_.start_ns <= s.start_ns <= s.end_ns <= pass_.end_ns
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
    counts = pass_.counts
    assert counts == {k: unband.counters[k] - before[k]
                      for k in unband.counters}
    assert counts['records_in'] == nin
    assert counts['records_out'] == 40 <= counts['records_in']
    assert counts['spilled_bytes'] > 0


def test_unband_output_is_the_same_with_recording_on_and_off():
    off = _unband_text()
    with support.recording():
        on = _unband_text()
    assert on == off and off.count('#\n') > 100
