"""The check that decides ``correct``, shown to fail: a run of a tiny
cell on the CPU (the harness's look for a chip skipped) with the timed
path broken underneath, and the control, each held to the limits of the
committed cell the tiny one shrinks.  The readings at the cells' own
sizes, on the card, are in ``PERF.md``; ``calibrate.py`` makes them."""
import contextlib
import time

import pytest
import torch

from portbench import calibrate, harness

TRAIN = ["glm.train", "qwen.train"]


def run(root, workload, seed=21):
    cell = harness.load_cell(root, workload)
    return harness.run(cell, seed=seed, seconds=0.2, trace=False,
                       device="cpu", t0=time.perf_counter())


@contextlib.contextmanager
def patched_step(factory):
    """``steps.make_train_step`` replaced by ``factory(real)``."""
    from repro_torch.train import steps
    real = steps.make_train_step
    steps.make_train_step = factory(real)
    try:
        yield
    finally:
        steps.make_train_step = real


def unchanged(real):
    """A step that computes as the real one and returns the state it was
    given, unchanged."""
    def make(cfg, model, opt=None, lr=3e-4):
        inner = real(cfg, model, opt, lr)

        def step(params, opt_state, batch):
            copy = lambda t: {k: copy(v) for k, v in t.items()} \
                if isinstance(t, dict) else t.clone()  # noqa: E731
            _, _, met = inner(copy(params), copy(opt_state), batch)
            return params, opt_state, met
        return step
    return make


@pytest.mark.parametrize("workload", TRAIN + ["qwen.prefill"])
def test_sound_runs_are_correct(tiny_root, workload):
    for seed in (21, 2 ** 31 + 3):
        out = run(tiny_root, workload, seed)
        assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_an_unchanged_state_is_not_correct(tiny_root, workload):
    with patched_step(unchanged):
        out = run(tiny_root, workload)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_a_batch_is_not_correct(tiny_root, workload):
    """Half of each batch left out, the mean taken over the rest (the
    fault ``calibrate.py`` reads on the card)."""
    with calibrate.half_batch():
        out = run(tiny_root, workload)
    assert out["correct"] is False, out["checks"]


def test_an_altered_answer_is_not_correct(tiny_root):
    """The served token altered where it is produced: the prefill's
    logits rolled by one over the vocabulary."""
    from repro_torch.train import steps
    real = steps.make_prefill_step

    def make(cfg, model):
        inner = real(cfg, model)
        return lambda params, batch: torch.roll(inner(params, batch), 1, -1)

    steps.make_prefill_step = make
    try:
        out = run(tiny_root, "qwen.prefill")
    finally:
        steps.make_prefill_step = real
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", TRAIN + ["qwen.prefill"])
def test_the_control_is_not_correct(tiny_root, workload):
    """The reference in float8, put in the program's place."""
    cell = harness.load_cell(tiny_root, workload)
    kind = cell.code("kinds", cell.traffic["kind"]).Kind(cell, 21, "cpu")
    kind.setup()
    kind.unit()
    kind.release()
    numbers = kind.numbers(kind.reference(fp8=True), kind.reference())
    assert not harness.judge(numbers, cell.limits), numbers
