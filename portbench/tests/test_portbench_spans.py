"""The readers of the program's step spans (``portbench/spans.py`` and the
metrics that read it): a traced tiny cell on the CPU reports them in the
cells they list, each reads what a hand-made window of spans and device
trace says, a metric whose span is absent (or a program with no step
tracer) reads None, and, on the card, a span and the runtime call it
encloses lie on one clock.  Run from the root of the repository:
``PYTHONPATH=src python -m pytest -q portbench/tests`` (on the card
``-m cuda``)."""
import importlib.util
import json
import math
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.trace import Trace

REPO = Path(__file__).resolve().parents[2]
NEW = ("optimizer_ms.train", "optimizer_launches.train", "grad_sum_ms.train",
       "recompute_ms.train", "step_idle_ms.train", "fetch_ms.train",
       "unembed_ms.prefill")
#: the new metrics that read the device trace alone, which a CPU run has
#: not: the runtime's launch calls and the device's idle gaps
DEVICE_ONLY = {"optimizer_launches.train", "step_idle_ms.train"}


def reader(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rec(span_id, name, t0, t1, parent=None, device_ms=None, **attrs):
    attrs["device_ms"] = (t1 - t0) * 1e3 if device_ms is None else device_ms
    return {"span_id": span_id, "parent_id": parent, "name": name,
            "t0_wall": t0, "t1_wall": t1, "attrs": attrs}


#: one fetch, one train step and one prompt, in seconds on the trace's
#: clock, with device ms unlike their host durations
RECORDS = [
    rec(0, "data.fetch", 9.90, 10.00, rows=4, bytes=64),
    rec(1, "data.read", 9.90, 9.97, parent=0),
    rec(2, "data.copy", 9.97, 10.00, parent=0),
    rec(3, "train.step", 10.00, 12.00, device_ms=2000.0),
    rec(4, "train.grad_sum", 10.00, 10.05, parent=3, device_ms=15.0,
        phase="fill"),
    rec(5, "train.microbatch", 10.05, 11.00, parent=3, device_ms=900.0),
    rec(6, "model.unembed", 10.10, 10.20, parent=5, device_ms=99.0,
        positions=8, served=6),
    rec(7, "train.recompute", 10.50, 10.60, parent=5, device_ms=50.0,
        layer=0),
    rec(8, "train.recompute", 10.52, 10.55, parent=7, device_ms=20.0,
        layer=0),
    rec(9, "train.grad_sum", 11.00, 11.10, parent=3, device_ms=25.0,
        phase="add"),
    rec(10, "train.optimizer", 11.50, 11.90, parent=3, device_ms=300.0),
    rec(11, "optim.norm", 11.50, 11.60, parent=10, device_ms=30.0),
    rec(12, "optim.update", 11.60, 11.90, parent=10, device_ms=270.0),
    rec(13, "prefill.step", 13.00, 14.00, device_ms=950.0, tokens=8),
    rec(14, "model.unembed", 13.80, 13.90, parent=13, device_ms=7.0,
        positions=8, served=1),
]
#: device intervals leave gaps at 9.90-10.00 (in the fetch), 10.40-10.60
#: (in a recompute), 11.60-11.70 (in the optimizer), 11.90-12.00 (in the
#: step alone) and 12.20-13.05 (outside any step)
TRACE = Trace(9.90, 14.00,
              device=[(10.00, 10.40, "k"), (10.60, 11.60, "k"),
                      (11.70, 11.90, "opt"), (12.00, 12.20, "opt"),
                      (13.05, 14.00, "k")],
              runtime=[(11.55, 11.551, "cudaLaunchKernel"),
                       (11.80, 11.801, "cuLaunchKernelEx"),
                       (11.95, 11.951, "cudaLaunchKernel"),
                       (12.25, 12.30, "cudaStreamSynchronize")],
              units=1)
WANT = {"optimizer_ms.train": 300.0, "optimizer_launches.train": 2.0,
        "grad_sum_ms.train": 40.0, "recompute_ms.train": 50.0,
        "step_idle_ms.train": 1e3 * (0.2 + 0.1 + 0.1),
        "fetch_ms.train": 100.0, "unembed_ms.prefill": 7.0}


def window(records, trace=TRACE):
    run = harness.Run(cell=None, kind=None, units=1, window_s=1.0,
                      trace=trace)
    run._step_spans = records
    return run


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_a_hand_made_window(name, capsys):
    assert reader(name)(window(RECORDS)) == pytest.approx(WANT[name])
    if name == "optimizer_launches.train":
        assert "2 launches, 1 device kernels" in capsys.readouterr().err
    if name == "step_idle_ms.train":
        err = capsys.readouterr().err
        assert "train.recompute 200.000" in err
        assert "(outside train.step) 950.000" in err


@pytest.mark.parametrize("name", NEW)
def test_a_reader_whose_spans_are_absent_reads_none(name, monkeypatch):
    assert reader(name)(window([RECORDS[13]])) is None
    from repro_torch.obs import trace
    monkeypatch.delattr(trace, "drain_steps")
    assert reader(name)(harness.Run(None, None, 1, 1.0, TRACE)) is None


def test_a_traced_tiny_cell_reports_the_span_metrics(tiny_root):
    listed = {}
    for workload in ("glm.train", "qwen.train", "qwen.prefill"):
        cell = harness.load_cell(tiny_root, workload)
        listed[workload] = {m["name"] for m in cell.per_layer} & set(NEW)
        out = harness.run(cell, seed=2 ** 31 + 11, seconds=0.3, trace=True,
                          device="cpu", t0=time.perf_counter())
        assert out["correct"] is True
        read = {k for k in out["metrics"] if k in NEW}
        assert read == listed[workload] - DEVICE_ONLY
        assert all(math.isfinite(out["metrics"][k]["value"]) and
                   out["metrics"][k]["value"] > 0 for k in read)
        json.dumps(out)
    assert listed["glm.train"] == listed["qwen.train"] == {
        n for n in NEW if n.endswith(".train")}
    assert listed["qwen.prefill"] == {"unembed_ms.prefill"}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_span_encloses_its_launch_on_the_profilers_clock(card):
    """A root span around one kernel launch, under the benchmark's
    CUDA-only profiler: the launch's runtime call lies inside the span's
    wall stamps, and its kernel starts on the device after the span
    began."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    x = torch.ones(1 << 22, device="cuda")
    torch.cuda.synchronize()
    trace.drain_steps()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.step_root("train.step", "cuda"):
            x.mul_(2.0)
        torch.cuda.synchronize()
    found = Trace.of(prof)
    (span,) = trace.drain_steps()
    t0, t1 = span["t0_wall"], span["t1_wall"]
    launches = [(s, t) for s, t, name in found.runtime
                if "LaunchKernel" in name]
    inside = [(s, t) for s, t in launches if t0 <= s <= t1]
    assert len(inside) == 1 and inside[0][1] <= t1, (t0, t1, launches)
    kernels = [s for s, _, name in found.device
               if not name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) == 1 and kernels[0] >= t0, (t0, kernels)
    assert 0 < span["attrs"]["device_ms"] < 1e3 * (found.hi - t0)
