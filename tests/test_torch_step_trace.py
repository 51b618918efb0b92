"""The port's step tracer (``obs/trace.py``) on the CPU, on reduced models:
the spans a train step, a prompt and a batch record while
``torch.profiler`` records (one root a step with its microbatches, the
f32 sum and AdamW as children, remat's recomputes, the unembedding), that
nothing is recorded and no tracer made with the profiler off, that
tracing changes no bit of the step, and that a span's wall stamps lie on
the profiler's clock."""
import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs.registry import reduced_config
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.data.pipeline import BrickDataPipeline, TokenBrickStore
from repro_torch.models import model_zoo
from repro_torch.models.params import _flatten
from repro_torch.obs import trace
from repro_torch.optim import adamw
from repro_torch.train import steps

SEQ = 16


@pytest.fixture(autouse=True)
def _fresh_tracer(monkeypatch):
    """Each test starts with no step tracer, on one intra-op thread."""
    monkeypatch.setattr(trace, "_STEP", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(arch="qwen3-14b", m=2, **overrides):
    cfg = reduced_config(arch, microbatches=m, **overrides)
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    opt = adamw.AdamW()
    state = adamw.init_opt_state(params, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2 * m, SEQ),
                           generator=torch.Generator().manual_seed(1))
    return (cfg, model, params, state,
            steps.make_train_step(cfg, model, opt),
            {"tokens": tokens, "labels": tokens})


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args)
    return out, trace.drain_steps()


def _children(recs, parent):
    return [r for r in recs if r["parent_id"] == parent["span_id"]]


@pytest.mark.parametrize("m", [1, 2])
def test_a_traced_train_step_is_one_root_over_its_microbatches(m):
    _, _, params, state, step, batch = _train(m=m)
    _, recs = _profiled(step, params, state, batch)
    roots = [r for r in recs if r["parent_id"] is None]
    assert [r["name"] for r in roots] == ["train.step"]
    assert roots[0]["attrs"]["tokens"] == 2 * m * SEQ
    kids = [(r["name"], r["attrs"].get("i"), r["attrs"].get("phase"))
            for r in _children(recs, roots[0])]
    want = [("train.grad_sum", None, "fill")]
    for i in range(m):
        want += [("train.microbatch", i, None), ("train.grad_sum", i, "add")]
    want += [("train.grad_sum", None, "divide")] * (m > 1)
    assert kids == want + [("train.optimizer", None, None)]
    assert {r["ticket"] for r in recs} == {0}
    assert trace.validate_records(recs) == []
    assert {r["name"] for r in recs} <= set(trace.SPAN_NAMES)


@pytest.mark.parametrize("arch,overrides,per_microbatch", [
    ("qwen3-14b", dict(remat_policy="none"), 0),
    ("qwen3-14b", dict(remat_policy="full"), 4),
    ("qwen3-14b", dict(remat_policy="dots"), 4),
    ("qwen3-14b", dict(remat_policy="full", remat_segments=2), 4 + 2),
    ("xlstm-350m", dict(remat_policy="full"), 2),
])
def test_each_recompute_is_a_span_of_its_microbatch(arch, overrides,
                                                    per_microbatch):
    """L x M recomputes under "full" and "dots" (a segment's recompute
    and its layers' each count), none under "none"; xlstm-350m's reduced
    model has 2 super-blocks."""
    cfg, _, params, state, step, batch = _train(arch, **overrides)
    _, recs = _profiled(step, params, state, batch)
    by_id = {r["span_id"]: r for r in recs}
    again = [r for r in recs if r["name"] == "train.recompute"]
    assert len(again) == per_microbatch * cfg.microbatches
    assert all(by_id[r["parent_id"]]["name"] == "train.microbatch"
               for r in again)
    layers = collections.Counter(r["attrs"].get("layer") for r in again
                                 if "layer" in r["attrs"])
    if cfg.family == "dense" and per_microbatch:
        assert layers == {i: cfg.microbatches
                          for i in range(cfg.num_layers)}


def test_the_optimizer_span_holds_the_norm_and_the_update(monkeypatch):
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 1000)
    _, _, params, state, step, batch = _train(m=1)
    _, recs = _profiled(step, params, state, batch)
    (opt,) = [r for r in recs if r["name"] == "train.optimizer"]
    assert [r["name"] for r in _children(recs, opt)] == ["optim.norm",
                                                         "optim.update"]
    sizes = [t.numel() for t in _flatten(params).values()]
    assert opt["attrs"]["elements"] == sum(sizes)
    assert opt["attrs"]["slices"] == sum(-(-n // 1000) for n in sizes) > \
        len(sizes)


def test_the_optimizer_span_counts_no_kernel_launch_on_the_cpu():
    """``kernel_launches``, the fused AdamW passes a step launched, is 0
    where the plain version runs."""
    _, _, params, state, step, batch = _train(m=1)
    _, recs = _profiled(step, params, state, batch)
    (opt,) = [r for r in recs if r["name"] == "train.optimizer"]
    assert opt["attrs"]["kernel_launches"] == 0
    assert opt["attrs"]["slices"] == len(_flatten(params))


def test_one_unembedding_a_forward_with_the_positions_it_serves():
    cfg, model, params, state, step, batch = _train(m=2)
    _, recs = _profiled(step, params, state, batch)
    unembeds = [r for r in recs if r["name"] == "model.unembed"]
    assert [(r["attrs"]["positions"], r["attrs"]["served"])
            for r in unembeds] == [(2 * SEQ, 2 * (SEQ - 1))] * 2
    prefill = steps.make_prefill_step(cfg, model)
    with torch.inference_mode():
        _, recs = _profiled(prefill, params, {"tokens": batch["tokens"]})
    assert [(r["name"], r["attrs"].get("positions"), r["attrs"].get(
        "served")) for r in recs] == [("prefill.step", None, None),
                                      ("model.unembed", 4 * SEQ, 4)]
    assert recs[0]["attrs"]["tokens"] == 4 * SEQ
    assert recs[1]["parent_id"] == recs[0]["span_id"]


def test_a_fetch_is_a_root_over_the_read_and_the_copy():
    store = TokenBrickStore(vocab_size=64, seq_len=SEQ, n_bricks=4,
                            seqs_per_brick=4, n_nodes=2, seed=3)
    pipe = BrickDataPipeline(store, MetadataCatalog(2), global_batch=4,
                             device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.next_device_batch()
        pipe.next_device_batch()
    recs = trace.drain_steps()
    assert [(r["name"], r["ticket"]) for r in recs] == [
        ("data.fetch", 0), ("data.read", 0), ("data.copy", 0),
        ("data.fetch", 1), ("data.read", 1), ("data.copy", 1)]
    assert recs[0]["attrs"]["rows"] == 4
    assert recs[0]["attrs"]["bytes"] == 4 * SEQ * 4
    assert trace.validate_records(recs) == []


def test_with_no_profiler_no_tracer_is_made_and_nothing_recorded():
    cfg, model, params, state, step, batch = _train(m=2)
    step(params, state, batch)
    with torch.inference_mode():
        steps.make_prefill_step(cfg, model)(params,
                                            {"tokens": batch["tokens"]})
    assert trace._STEP is None and trace.step_tracer() is None
    assert trace.drain_steps() == []


def test_tracing_changes_no_bit_of_a_train_step():
    runs = []
    for traced in (False, True):
        _, _, params, state, step, batch = _train(m=2)
        for _ in range(2):
            if traced:
                (params, state, met), _ = _profiled(step, params, state,
                                                    batch)
            else:
                params, state, met = step(params, state, batch)
        runs.append(_flatten({"p": params, "m": state["m"],
                              "v": state["v"], "loss": met["loss"]}))
    assert runs[0].keys() == runs[1].keys()
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


def test_tracing_changes_no_bit_of_a_prefill():
    cfg, model, params, _, _, batch = _train(m=1)
    prefill = steps.make_prefill_step(cfg, model)
    with torch.inference_mode():
        plain = prefill(params, {"tokens": batch["tokens"]})
        traced, recs = _profiled(prefill, params,
                                 {"tokens": batch["tokens"]})
    assert recs and torch.equal(plain, traced)


def test_a_span_encloses_what_the_profiler_recorded_inside_it():
    """Wall stamps on the profiler's clock: a ``record_function`` range
    inside a root span lies within the span's stamps."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.step_root("train.step", "cpu"):
            with record_function("inside"):
                torch.ones(64).sum()
    (rec,) = trace.drain_steps()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inside"]
    assert rec["t0_wall"] <= ev.start_ns() * 1e-9 <= ev.end_ns() * 1e-9 \
        <= rec["t1_wall"]


def test_a_drain_hands_over_once_and_device_ms_is_host_time_on_the_cpu():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.step_root("prefill.step", "cpu"):
            with trace.step_span("model.unembed"):
                with pytest.raises(RuntimeError, match="open"):
                    trace.drain_steps()
    recs = trace.drain_steps()
    assert [r["name"] for r in recs] == ["prefill.step", "model.unembed"]
    for r in recs:
        assert r["attrs"]["device_ms"] == pytest.approx(
            (r["t1_wall"] - r["t0_wall"]) * 1e3)
    assert trace.drain_steps() == []


def test_a_span_whose_body_raises_closes_in_error():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.step_root("train.step", "cpu"):
                with trace.step_span("train.optimizer"):
                    raise ValueError("boom")
        assert trace.step_tracer() is None
    recs = trace.drain_steps()
    assert [r["status"] for r in recs] == [trace.STATUS_ERROR] * 2
    assert trace.validate_records(recs) == []


class FakeEvent:
    """A CUDA timing event on the host's clock, +1000 ms so that its
    readings tell apart; ``passed`` says whether the device has passed
    it."""
    made = 0
    passed = True

    def __init__(self, enable_timing):
        assert enable_timing
        FakeEvent.made += 1

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return FakeEvent.passed

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3 + 1000.0


@pytest.mark.parametrize("passed,made", [(True, 4), (False, 12)])
def test_cuda_spans_read_their_events_lazily_and_pool_them(monkeypatch,
                                                          passed, made):
    """On a CUDA device each span takes two events; the next root reads
    and pools those the device has passed (all four of the first root's
    serve the next two roots), and the drain the rest."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(FakeEvent, "passed", passed)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.step_root("train.step", "cuda"):
                with trace.step_span("train.optimizer"):
                    pass
    recs = trace.drain_steps()
    assert FakeEvent.made == made
    assert [r["ticket"] for r in recs] == [0, 0, 1, 1, 2, 2]
    assert all(r["attrs"]["device_ms"] >= 1000 for r in recs)


def test_the_span_names_are_the_emitted_ones():
    assert "admit" not in trace.SPAN_NAMES
    assert "cache_probe" not in trace.SPAN_NAMES
    assert len(set(trace.SPAN_NAMES)) == len(trace.SPAN_NAMES)
