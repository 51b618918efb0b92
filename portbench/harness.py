"""One run of one cell: find its pieces by name, set up, measure the
window, read the per-layer metrics, check against the reference, and
build the result line.

Everything that belongs to one configuration, traffic mix, kind of
traffic or per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``:

- ``configs/<config>.json`` (the ``file`` of the configuration entry):
  the port's registry arch id and the model's numbers as run;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``kind`` names
- ``kinds/<kind>.py``: the class ``Kind`` that sets the program up,
  drives one unit of work a call in the window, and checks it;
- ``limits/<workload>.json``: the limit of each number the check
  compares;
- ``metrics/<metric>.py``: ``read(run)``, the reader of one per-layer
  metric, which returns None where it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

#: the folder of the harness's files, inside the root of a checkout
BENCH = Path(__file__).resolve().parent.name
#: top-level modules that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds at the end of a traced run's window that the profiler records
TRACE_S = 10.0


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def model(self) -> dict:
        """The configuration's numbers as run."""
        return self.config["model"]

    def code(self, folder: str, name: str):
        """The module ``<root>/<BENCH>/<folder>/<name>.py``."""
        path = self.root / BENCH / folder / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"{path} not found")
        mod_name = f"_{BENCH}_{folder}_" + "".join(
            ch if ch.isalnum() else "_" for ch in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` in ``<root>/BENCHMARK.json``, with its
    configuration, traffic and limits read from their files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    spec = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[spec["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / BENCH / "traffic" / f"{spec['traffic']}.json").read_text())
    limits = json.loads(
        (root / BENCH / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(workload, root, spec["chips"], spec["config"], config,
                spec["traffic"], traffic, e2e, layer, limits)


def cache_env(root: Path) -> None:
    """Point the build and kernel caches PyTorch may write, and Python's
    bytecode cache, at fixed directories inside the checkout (before
    torch is imported), so that only a cell's first run in a checkout
    builds and compiles.  Bytecode is written there even where the
    environment turns it off (``PYTHONDONTWRITEBYTECODE``): with none
    installed, every run would compile torch's modules from source, ~2,000
    on import and ~800 more (``torch._dynamo``, sympy) in the first train
    step, 15-20 s of a run's set-up on an H100's host, swinging with the
    host's load."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "torchinductor")):
        os.environ[var] = str(Path(root) / "build" / sub)
    sys.pycache_prefix = str(Path(root) / "build" / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader may read: the cell, the kind's
    own records (``kind``), the units and host seconds of the window's
    untraced part, and its traced part's device trace (``trace``, a
    ``trace.Trace``, whose ``units`` it ran)."""
    cell: Cell
    kind: object
    units: int
    window_s: float
    trace: Optional[object] = None


def measure(kind, seconds: float, trace: bool, device, log=sys.stderr):
    """Units of ``kind`` one after another until ``seconds`` have passed:
    (units, seconds, trace or None).  Each unit ends with its result on
    the host, so the window runs from the first unit's start to the last
    one's synchronize.  A traced run profiles the last TRACE_S seconds
    (at most half) of its window, on the card its CUDA activity alone
    (``trace.py``), and returns the units and seconds of the untraced
    part before them, which the host-clock readings take."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    synchronize(device)
    start = time.perf_counter()
    units = 0
    traced_s = min(TRACE_S, seconds / 2) if trace else 0.0
    until = seconds - traced_s
    while units == 0 or time.perf_counter() - start < until:
        kind.unit()
        units += 1
    window_s = time.perf_counter() - start
    if not trace:
        return units, window_s, None
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    traced = 0
    with profile(activities=activities) as prof:
        begin = time.perf_counter()
        while traced == 0 or time.perf_counter() - begin < traced_s:
            kind.unit()
            traced += 1
        traced_wall = time.perf_counter() - begin
    print(f"untraced {window_s / units:.4f} s a unit ({units}), traced "
          f"{traced_wall / traced:.4f} s a unit ({traced})", file=log,
          flush=True)
    from portbench import trace as trace_lib
    found = trace_lib.Trace.of(prof)
    found.units = traced
    return units, window_s, found


def judge(numbers: dict, limits: dict) -> bool:
    """Every number compared is there, finite and within its limit."""
    return all(math.isfinite(numbers.get(k, math.inf))
               and numbers[k] <= limits[k] for k in limits)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t0: float, log=sys.stderr) -> Optional[dict]:
    """One run of ``cell``: the result line as a dict, or None when a
    forbidden module was loaded (named on ``log``)."""
    import torch
    Kind = cell.code("kinds", cell.traffic["kind"]).Kind
    phases = [("start, imports", time.perf_counter())]

    def mark(phase: str) -> None:
        synchronize(device)
        phases.append((phase, time.perf_counter()))

    kind = Kind(cell, seed, device)
    mark("device ready")
    kind.setup(mark)
    mark("rest")
    setup_s = time.perf_counter() - t0
    at = [t0] + [t for _, t in phases]
    print(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {t - t_prev:.3f}" for (name, t), t_prev
        in zip(phases, at)), file=log, flush=True)

    cuda = torch.device(device).type == "cuda"
    units, window_s, found = measure(kind, seconds, trace, device, log)
    # the peak of set-up and window, read before the reference runs
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=log)
        return None

    values = kind.e2e(units, window_s)
    values.update(setup_s=setup_s, peak_gb=peak / 1e9)
    if trace:
        ctx = Run(cell, kind, units, window_s, found)
        metrics = {}
        for spec in cell.per_layer:
            value = cell.code("metrics", spec["name"]).read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        metrics = {spec["name"]: {"value": values[spec["name"]],
                                  "unit": spec["unit"]}
                   for spec in cell.end_to_end}
    print(f"window {window_s:.3f} s, {units} units; checking", file=log,
          flush=True)

    kind.release()
    numbers = kind.check()
    correct = kind.failed == 0 and judge(numbers, cell.limits)
    device_info = {"platform": "gpu" if cuda else torch.device(device).type,
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": kind.attempted,
           "failed": kind.failed, "metrics": metrics, "device": device_info}
    if found is not None:
        device_info.update(busy_s=found.busy_s, window_s=found.window_s)
        out["breakdown"] = found.breakdown()
    out["checks"] = {k: {"value": numbers.get(k), "limit": cell.limits[k]}
                     for k in cell.limits}
    for k, v in out["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=log)
    return out
