"""A run with the timed path broken underneath comes out not correct, and
so does the control: the sample sketches at the next lower counter width
(4 bits for the configuration's 8).  The harness's look for a card is
skipped: these drive the rest of a run on the tiny configuration, on the
CPU here and on the card where there is one (the ``cuda`` tests).  A fault
of the exchange between cards has no place here: every cell runs on one
card."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, 'data')
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark import harness  # noqa: E402
from kevlar_tpu_torch import sketch  # noqa: E402
from kevlar_tpu_torch.ops import novel_ops, sketch_ops  # noqa: E402

TINY = {'workloads': [{'name': 'tiny.trio-count-screen', 'config': 'tiny',
                       'traffic': 'trio-count-screen', 'chips': 1}]}
SEED = 2 ** 31 + 11


def run(device='cpu', counter_bits=None, fault=None):
    """(correct, checks, failed) of a one-step run; ``fault()`` breaks the
    timed path once set-up is done."""
    _, config, traffic = harness.cell_files('tiny.trio-count-screen', TINY,
                                            here=DATA)
    cell = harness.Cell(config, traffic, SEED, device, counter_bits)
    cell.setup()
    if fault:
        fault()
    cell.window(0.0)
    checks, failed = cell.check()
    correct, _ = harness.verdict(checks, config['limits'], cell.steps)
    return correct, checks, failed


def test_sound_run_is_correct():
    correct, checks, failed = run()
    assert correct and failed == 0, checks


def test_control_fails():
    correct, checks, failed = run(counter_bits=4)
    assert not correct and checks['table_buckets_off'] > 0
    assert failed == 1


def test_count_leaving_state_unchanged_fails(monkeypatch):
    def fault():
        monkeypatch.setattr(sketch.Sketch, 'consume_batch_stack',
                            lambda self, *a, **k: None)
    correct, checks, _ = run(fault=fault)
    assert not correct and checks['table_buckets_off'] > 0
    assert checks['hits_missing'] > 0


def test_half_of_each_batch_left_out_fails(monkeypatch):
    whole = sketch_ops.consume_codes

    def half(acc, codes, ksize, **kw):
        return whole(acc, codes[:codes.shape[0] // 2], ksize, **kw)

    def fault():
        monkeypatch.setattr(sketch_ops, 'consume_codes', half)
    correct, checks, _ = run(fault=fault)
    assert not correct and checks['table_buckets_off'] > 0


def test_count_wrong_in_an_earlier_step_fails(monkeypatch):
    """A count that goes wrong in one step and not in the last, as a race
    might: the last step's sketches match the reference, the first step's
    digests do not match them."""
    _, config, traffic = harness.cell_files('tiny.trio-count-screen', TINY,
                                            here=DATA)
    cell = harness.Cell(config, traffic, SEED, 'cpu')
    cell.setup()
    whole = sketch_ops.consume_codes

    def half(acc, codes, ksize, **kw):
        return whole(acc, codes[:codes.shape[0] // 2], ksize, **kw)
    monkeypatch.setattr(sketch_ops, 'consume_codes', half)
    cell.window(0.0)
    monkeypatch.setattr(sketch_ops, 'consume_codes', whole)
    cell.window(0.0)
    checks, failed = cell.check()
    correct, _ = harness.verdict(checks, config['limits'], cell.steps)
    assert cell.steps == 2 and checks['table_buckets_off'] == 0
    assert not correct and checks['table_digests_off'] == 1
    assert failed >= 1


def test_altered_count_in_the_screen_fails(monkeypatch):
    screen = novel_ops.novel_screen_compact

    def altered(*a, **k):
        hit_idx, hit_abunds, n_hits, discard, skip = screen(*a, **k)
        hit_abunds = hit_abunds.clone()
        hit_abunds[0, 0] += 1
        return hit_idx, hit_abunds, n_hits, discard, skip

    def fault():
        monkeypatch.setattr(novel_ops, 'novel_screen_compact', altered)
    correct, checks, _ = run(fault=fault)
    assert not correct and checks['hits_wrong'] > 0


def test_dropped_hit_fails(monkeypatch):
    screen = novel_ops.novel_screen_compact

    def dropped(*a, **k):
        hit_idx, hit_abunds, n_hits, discard, skip = screen(*a, **k)
        return hit_idx, hit_abunds, (n_hits - 1).clamp(min=0), discard, skip

    def fault():
        monkeypatch.setattr(novel_ops, 'novel_screen_compact', dropped)
    correct, checks, _ = run(fault=fault)
    assert not correct and checks['hits_missing'] > 0


def test_empty_mask_fails(monkeypatch):
    """The mask is made in set-up: its count is left out there, the
    samples' counts run as they should."""
    _, config, traffic = harness.cell_files('tiny.trio-count-screen', TINY,
                                            here=DATA)
    cell = harness.Cell(config, traffic, SEED, 'cpu')
    whole = sketch.Sketch.consume_batch_stack
    calls = []

    def skip_first(self, *a, **k):
        calls.append(1)
        if len(calls) > 1:
            return whole(self, *a, **k)
    monkeypatch.setattr(sketch.Sketch, 'consume_batch_stack', skip_first)
    cell.setup()
    cell.window(0.0)
    checks, _ = cell.check()
    assert checks['mask_buckets_off'] > 0


@pytest.mark.cuda
def test_card_sound_and_control():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    correct, checks, _ = run(device='cuda')
    assert correct, checks
    correct, checks, _ = run(device='cuda', counter_bits=4)
    assert not correct and checks['table_buckets_off'] > 0
