"""Dry run of one (arch x shape x mesh) cell (port of ``launch/dryrun.py``).

The reference lowers and compiles a step with XLA on 512 fake CPU devices
and reads the compiled module's cost and memory.  The port runs eagerly,
so its dry run *runs* the step once on the ``meta`` device: parameters,
optimizer state, batch and decode cache are ``meta`` tensors
(``ParamTable.abstract_sharded``, ``abstract_opt_state``,
``model_zoo.input_specs``, ``Model.init_cache_abstract``), every ATen op
computes shapes and dtypes only, and the LM kernels' wrappers validate and
plan each call as on an H100 and launch nothing.  :class:`OpTrace` (a
``TorchDispatchMode``) records the run:

- every op outside the kernel wrappers: its name, the shapes and dtypes
  of its tensor inputs and outputs, its flops (matmuls and convolutions,
  by ``torch.utils.flop_counter``'s formulas) and the bytes it moves
  (operands and outputs; views and aliases move none).  Ops that turn a
  Python number into a 0-dim tensor are left out: the card lifts a host
  scalar where ``meta`` makes one in place;
- every kernel call as one entry (kernel, the variant its plan picked, its
  shape arguments), with the work ``analysis/roofline.py`` counts for it;
- AdamW's passes (``kernels/adamw``), which ``meta`` runs as their plain
  version (``optim/adamw.py``): those ops stay in the list, their bytes
  and temporaries the dry run's, marked as the stand-in for the kernel
  calls the card makes there (:meth:`OpTrace.fused`);
- memory: the step's argument, output and alias bytes, which are exact,
  and its temp bytes, the peak of the live storages the step allocates
  beyond its arguments, each storage counted once across its views and
  kept live while any reference holds it (autograd's saved tensors
  included: ``StorageWeakRef``).

The same recorder traces a step on CUDA tensors (``chip_smoke.py``'s
``dryrun`` phase): outside the kernel wrappers and the stand-ins the two
op lists must be equal, and so must the kernel entries and the stand-ins'
calls (:func:`trace_mismatch`).

The record keeps the reference's keys where they mean something here:
``arch``, ``shape``, ``mesh``, ``num_params``, ``lower_s`` (the traced
run's seconds), ``flops`` and ``bytes_accessed`` (the trace's totals,
``hlo_parse.analyze_trace``) and ``memory`` (``argument_size_in_bytes``,
``output_size_in_bytes``, ``alias_size_in_bytes``,
``temp_size_in_bytes``), plus ``chips`` and ``kernel_launches`` by
variant.  ``generated_code_size_in_bytes``, ``compile_s`` and
``cost_analysis`` have no counterpart: nothing is compiled.

The port drives one card: its mesh is the (1, 1) mesh of
``launch/mesh.py`` (``"1x1"``, ``chips`` 1).  ``--multi-pod`` and
``--both-meshes`` raise ``make_production_mesh``'s device-count error
before any tracing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape decode_32k

writes ``{arch}__{shape}__1x1.json`` and its op trace ``.trace.json``
under ``experiments/dryrun_torch/``.  A cell outside ``SHAPES``, at a cut
depth, prints its predicted peak memory (arguments and temps) as one JSON
line and writes nothing:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b \
        --layers 4 --kind prefill --seq-len 2048 --batch 1

xlstm's sLSTM is a Python loop over time, so its cells trace S steps per
sLSTM layer (``train_4k``: 4,096; ``prefill_32k``: 32,768) and take
minutes.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels as kernel_pkg
from repro_torch.analysis import hlo_parse
from repro_torch.analysis.roofline import kernel_work
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.kernels import dtype_name
from repro_torch.launch.mesh import make_mesh_of, make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.models.params import AbstractParam
from repro_torch.optim.adamw import AdamW, abstract_opt_state
from repro_torch.parallel.sharding import Sharder
from repro_torch.train import steps as steps_lib

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

#: ops that make a 0-dim tensor of a Python number: how depends on the
#: device (the card lifts a host scalar, meta makes one where it is
#: needed), and they move nothing worth a count, so no trace holds them
_CONSTANT_OPS = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default",
                 "aten.scalar_tensor.default"}
#: ops that move no data although their outputs are not views: factories
#: of uninitialised storage, and metadata-only reshapes
_FREE_OPS = {"aten.empty.memory_format", "aten.empty_strided.default",
             "aten.empty_like.default", "aten.new_empty.default",
             "aten.new_empty_strided.default", "aten._unsafe_view.default"}
#: ops whose ``meta`` function gives an output the card's kernel does not
#: make, and what the card makes instead: ``log_sigmoid_forward``'s
#: buffer, which only the CPU kernel fills (the card's is empty, and the
#: backward takes it as it is).  The dry run runs the step as on the card
_ON_CARD = {torch.ops.aten.log_sigmoid_forward.default:
            lambda out: (out[0], out[1].new_empty((0,)))}

_DTYPE_NAMES = {}


def _meta(x):
    """[shape, dtype] of a tensor, as the trace stores it."""
    name = _DTYPE_NAMES.get(x.dtype)
    if name is None:
        name = _DTYPE_NAMES[x.dtype] = dtype_name(x.dtype)
    return [list(x.shape), name]


def _tensors(tree, out=None) -> list:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


_OPS = {}


def _op_info(func):
    """(name, moves data, is a view, flop formula or None) of an ATen
    overload: a view's outputs all alias an input without writing it;
    views and ``_FREE_OPS`` move no data; the name is None for
    ``_CONSTANT_OPS``, which the trace leaves out."""
    info = _OPS.get(func)
    if info is None:
        name = str(func)
        rets = func._schema.returns
        view = bool(rets) and all(r.alias_info is not None and
                                  not r.alias_info.is_write for r in rets)
        info = _OPS[func] = (None if name in _CONSTANT_OPS else name,
                             not view and name not in _FREE_OPS, view,
                             flop_registry.get(func._overloadpacket))
    return info


class OpTrace(TorchDispatchMode):
    """The ops and kernel calls of one step, and its memory.  Use
    :meth:`recording` around the step, after :meth:`arguments`."""

    def __init__(self):
        super().__init__()
        self.ops = []                # [name, ins, outs, flops, bytes]
        self.kernels = {}            # (kernel, variant, shape) -> entry
        self._depth = 0              # > 0 inside a kernel wrapper
        self._args = {}              # storage key -> weak ref
        self._arg_bytes = 0
        self._live = {}              # storage key -> (weak ref, bytes)
        self._live_bytes = 0
        self._peak = 0
        self._since_sweep = 0
        self._outputs = {}
        self.fused_ops = []          # [first, end) of each stand-in's ops
        self.fused_calls = {}        # json [kernel, variant, shape] -> calls

    # ---------------------------------------------------------------- #
    def arguments(self, tree) -> None:
        """Register the step's inputs: their storages are the arguments,
        never temps."""
        for x in _tensors(tree):
            st = x.untyped_storage()
            if st._cdata not in self._args:
                self._args[st._cdata] = StorageWeakRef(st)
                self._arg_bytes += st.nbytes()

    def set_outputs(self, tree) -> None:
        """Register the step's outputs: output bytes, and the part of
        them that aliases an argument (a step that updates in place)."""
        out = alias = 0
        seen = set()
        for x in _tensors(tree):
            st = x.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            out += st.nbytes()
            if st._cdata in self._args:
                alias += st.nbytes()
        self._outputs = {"output_size_in_bytes": out,
                         "alias_size_in_bytes": alias}

    @contextlib.contextmanager
    def recording(self):
        """Record the ops run inside, and hand the kernel wrappers this
        trace (``repro_torch.kernels.TRACE``)."""
        if kernel_pkg.TRACE is not None:
            raise RuntimeError("an op trace is already recording")
        kernel_pkg.TRACE = self
        try:
            with self:
                yield self
        finally:
            kernel_pkg.TRACE = None
        self._sweep()

    @contextlib.contextmanager
    def fused(self, calls):
        """The ops run inside stand in for the kernel calls ``calls``
        ((kernel, variant, shape) each): on ``meta`` the plain version
        that the card replaces with those launches (AdamW's passes), on
        the card the wrapper's own ops around them.  The ops stay in the
        op list; :func:`trace_mismatch` leaves them out and compares the
        calls instead."""
        first = len(self.ops)
        yield
        self.fused_ops.append([first, len(self.ops)])
        for call in calls:
            key = json.dumps(call, sort_keys=True)
            self.fused_calls[key] = self.fused_calls.get(key, 0) + 1

    # the kernel wrappers' hook ---------------------------------------- #
    def begin(self) -> None:
        self._depth += 1

    def end(self, kernel: str, variant: str, shape: dict) -> None:
        self._depth -= 1
        if self._depth:
            return
        key = (kernel, variant, tuple(sorted(shape.items())))
        entry = self.kernels.get(key)
        if entry is None:
            work = kernel_work(kernel, shape)
            entry = self.kernels[key] = {
                "kernel": kernel, "variant": variant, "shape": shape,
                "count": 0, "flops": work.flops, "bytes": work.bytes,
                "dtype": work.dtype}
        entry["count"] += 1

    # ---------------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fix = _ON_CARD.get(func)
        if fix is not None and out[0].device.type == "meta":
            out = fix(out)
        outs = _tensors(out)
        name, moves, view, count = _op_info(func)
        if not view:
            for x in outs:
                self._track(x)
        if self._depth == 0 and name is not None:
            ins = _tensors(args)
            if kwargs:
                _tensors(kwargs, ins)
            flops = count(*args, **kwargs, out_val=out) if count else 0
            moved = 0
            if moves:
                moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.ops.append([name, [_meta(x) for x in ins],
                             [_meta(x) for x in outs], flops, moved])
        return out

    def _track(self, x: torch.Tensor) -> None:
        """Count ``x``'s storage live if it is new.  The live total only
        overstates (freed storages leave at a sweep), so it is swept when
        it passes the peak, at most once a quarter of the live count's
        allocations."""
        st = x.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        old = self._live.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self._live_bytes -= old[1]      # its address was reused
        n = st.nbytes()
        self._live[key] = (StorageWeakRef(st), n)
        self._live_bytes += n
        self._since_sweep += 1
        if self._live_bytes > self._peak and \
                4 * self._since_sweep >= len(self._live):
            self._sweep()

    def _sweep(self) -> None:
        self._live = {key: v for key, v in self._live.items()
                      if not v[0].expired()}
        self._live_bytes = sum(n for _, n in self._live.values())
        self._peak = max(self._peak, self._live_bytes)
        self._since_sweep = 0

    # ---------------------------------------------------------------- #
    def memory(self) -> dict:
        return {"argument_size_in_bytes": self._arg_bytes,
                **self._outputs, "temp_size_in_bytes": self._peak}

    def kernel_launches(self) -> dict:
        """Calls by ``kernel.variant``."""
        out = {}
        for e in self.kernels.values():
            key = f"{e['kernel']}.{e['variant']}"
            out[key] = out.get(key, 0) + e["count"]
        return dict(sorted(out.items()))

    def as_dict(self) -> dict:
        """The trace as ``hlo_parse.analyze_trace`` reads it (and as
        ``run_cell`` writes it)."""
        out = {"ops": self.ops, "kernels": list(self.kernels.values())}
        if self.fused_ops:
            out["fused"] = {"ops": self.fused_ops,
                            "calls": self.fused_calls}
        return out


def trace_mismatch(a: dict, b: dict) -> Optional[str]:
    """None when two traces (``OpTrace.as_dict()``) hold the same ops
    outside the kernels and the stand-ins (names, shapes and dtypes, in
    order), the same kernel entries (kernel, variant, shape, count, flops
    and bytes) and the same stand-ins' calls (``OpTrace.fused``); else
    what differs: the span between the first and the last op that
    differ, its first ops on each side, and the op names one side holds
    more often there; the kernel entries only one trace holds; the
    stand-ins' calls of each."""
    kept_a, kept_b = _outside_fused(a), _outside_fused(b)
    ops_a = [json.dumps(op[:3]) for op in kept_a]
    ops_b = [json.dumps(op[:3]) for op in kept_b]
    out = []
    if ops_a != ops_b:
        n = min(len(ops_a), len(ops_b))
        i = next((k for k in range(n) if ops_a[k] != ops_b[k]), n)
        j = 0
        while j < n - i and ops_a[-1 - j] == ops_b[-1 - j]:
            j += 1
        span_a = kept_a[i:len(ops_a) - j]
        span_b = kept_b[i:len(ops_b) - j]
        names_a = collections.Counter(op[0] for op in span_a)
        names_b = collections.Counter(op[0] for op in span_b)
        out.append(
            f"ops differ from {i} to {len(ops_a) - j} of {len(ops_a)} "
            f"against to {len(ops_b) - j} of {len(ops_b)}: "
            f"{ops_a[i:i + 3]} against {ops_b[i:i + 3]}; more often in the "
            f"first {dict(names_a - names_b)}, in the second "
            f"{dict(names_b - names_a)}")

    def entries(t):
        return {json.dumps(e, sort_keys=True) for e in t["kernels"]}

    ka, kb = entries(a), entries(b)
    if ka != kb:
        out.append(f"kernel entries differ: {sorted(ka - kb)} against "
                   f"{sorted(kb - ka)}")
    fa, fb = (t.get("fused", {}).get("calls", {}) for t in (a, b))
    if fa != fb:
        out.append(f"stand-ins' calls differ: {fa} against {fb}")
    return "; ".join(out) or None


def _outside_fused(t: dict) -> list:
    """The ops of a trace outside its stand-ins (``OpTrace.fused``)."""
    keep = [True] * len(t["ops"])
    for first, end in t.get("fused", {}).get("ops", []):
        keep[first:end] = [False] * (end - first)
    return [op for op, k in zip(t["ops"], keep) if k]


# --------------------------------------------------------------------- #
def cell_is_applicable(cfg, shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 524k-token decode state is "
                       "quadratic-regime; skipped per DESIGN.md section 5")
    return True, ""


def _values(tree):
    """The ``meta`` tensors of a tree of ``AbstractParam`` leaves."""
    if isinstance(tree, dict):
        return {key: _values(val) for key, val in tree.items()}
    return tree.value if isinstance(tree, AbstractParam) else tree


def step_inputs(cfg, shape, mesh):
    """(step, args) of one cell on ``meta``: the train, prefill or decode
    step of ``train/steps.py`` and its abstract inputs."""
    shd = Sharder(cfg, mesh)
    model = model_zoo.build_model(cfg)
    params_abs = model.table.abstract_sharded(shd)
    batch = _values(model_zoo.input_specs(model, shape, shd))
    params = _values(params_abs)
    if shape.kind == "train":
        opt = AdamW(moment_dtype=cfg.opt_moment_dtype)
        opt_state = _values(abstract_opt_state(params_abs, opt))
        return (steps_lib.make_train_step(cfg, model, opt),
                (params, opt_state, batch))
    if shape.kind == "prefill":
        return steps_lib.make_prefill_step(cfg, model), (params, batch)
    cache = _values(model.init_cache_abstract(shd, shape.global_batch,
                                              shape.seq_len))
    return (steps_lib.make_decode_step(cfg, model, mesh=mesh),
            (params, cache, batch))


def trace_step(step, args) -> OpTrace:
    """Run ``step(*args)`` once under a new :class:`OpTrace` (on ``meta``
    tensors, or on the card's)."""
    trace = OpTrace()
    trace.arguments(args)
    with trace.recording():
        out = step(*args)
    trace.set_outputs(out)
    return trace


def one_card_mesh():
    """The port's mesh of the dry run: (1, 1) over ("data", "model")."""
    return make_mesh_of((1, 1), ("data", "model"), device="meta")


def lower(cfg, shape, mesh=None, *, arch: Optional[str] = None):
    """Trace one cell's step on ``meta``: returns (record, trace).  The
    shape may be any ``ShapeConfig`` (``chip_smoke.py`` dry-runs its own
    cells); ``mesh`` defaults to :func:`one_card_mesh`."""
    mesh = mesh or one_card_mesh()
    step, args = step_inputs(cfg, shape, mesh)
    t0 = time.perf_counter()
    trace = trace_step(step, args)
    lower_s = time.perf_counter() - t0
    totals = hlo_parse.analyze_trace(trace.as_dict())
    sizes = mesh.devices.shape
    record = {
        "arch": arch or cfg.name,
        "shape": shape.name,
        "multi_pod": False,
        "mesh": "x".join(str(n) for n in sizes),
        "chips": int(mesh.devices.size),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "kind": shape.kind,
        "num_params": model_zoo.build_model(cfg).table.num_params(),
        "lower_s": round(lower_s, 2),
        "flops": totals.flops,
        "bytes_accessed": totals.bytes,
        "memory": trace.memory(),
        "kernel_launches": trace.kernel_launches(),
        "ops": len(trace.ops),
    }
    return record, trace


def cell(kind: str, seq_len: int, batch: int) -> ShapeConfig:
    """A cell outside ``SHAPES``: ``kind`` over ``batch`` rows of
    ``seq_len`` tokens (``chip_smoke.py``'s cells)."""
    return ShapeConfig(f"{kind}_{batch}x{seq_len}", seq_len=seq_len,
                       global_batch=batch, kind=kind)


def predict(cfg, shape):
    """:func:`lower` with the predicted peak memory of the step, its
    arguments and temps, in the record's ``predicted_peak_bytes``.  A
    prefill or decode cell is lowered under ``torch.no_grad``, as the port
    serves it (a layer count that is no multiple of ``remat_segments`` is
    served, not trained)."""
    with torch.no_grad() if shape.kind != "train" else \
            contextlib.nullcontext():
        record, trace = lower(cfg, shape)
    mem = record["memory"]
    record["predicted_peak_bytes"] = (mem["argument_size_in_bytes"] +
                                      mem["temp_size_in_bytes"])
    return record, trace


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               cfg_override=None):
    """Dry-run one (arch x shape x mesh) cell.  Returns (record, trace),
    or (record with ``skipped``, None)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": why}, None
    mesh = make_production_mesh(multi_pod=True) if multi_pod else None
    return lower(cfg, shape, mesh, arch=arch)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             save_hlo: bool = True, verbose: bool = True,
             cfg_override=None) -> dict:
    """Dry-run one cell and write its record (and, with ``save_hlo``, its
    op trace, the port's stand-in for the HLO) under ``ARTIFACT_DIR``."""
    record, trace = lower_cell(arch, shape_name, multi_pod=multi_pod,
                               cfg_override=cfg_override)
    if "skipped" in record:
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {record['skipped']}")
        return record

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{arch}__{shape_name}__{record['mesh']}".replace("/", "_")
    if save_hlo:
        trace_path = ARTIFACT_DIR / f"{stem}.trace.json"
        trace_path.write_text(json.dumps(trace.as_dict()))
        record["trace_path"] = str(trace_path)
    (ARTIFACT_DIR / f"{stem}.json").write_text(json.dumps(record, indent=2))

    if verbose:
        print(f"[dryrun] OK {arch} x {shape_name} mesh={record['mesh']} "
              f"lower={record['lower_s']}s flops={record['flops']:.3e} "
              f"bytes={record['bytes_accessed']:.3e}")
        print(f"  memory: {record['memory']}")
        print(f"  kernels: {record['kernel_launches']}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description="GEPS dry-run on the meta "
                                             "device")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-hlo", action="store_true",
                    help="write the record only, not the op trace")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="a cell outside SHAPES of this many tokens a row: "
                         "print its predicted peak (needs --arch, --kind "
                         "and --batch)")
    ap.add_argument("--kind", choices=("train", "prefill", "decode"))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="the arch cut to this many layers")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-segments", type=int, default=None,
                    help="two-level remat segments (0: none; a layer "
                         "count cut below the config's segments needs it)")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        # the (2, 16, 16) mesh needs 512 cards: this raises with the count
        make_production_mesh(multi_pod=True)
    if args.seq_len is not None:
        if not (args.arch and args.kind and args.batch):
            ap.error("--seq-len needs --arch, --kind and --batch")
        cfg = get_config(args.arch)
        for field, value in (("num_layers", args.layers),
                             ("microbatches", args.microbatches),
                             ("remat_segments", args.remat_segments)):
            if value is not None:
                cfg = dataclasses.replace(cfg, **{field: value})
        record, _ = predict(cfg, cell(args.kind, args.seq_len, args.batch))
        mem = record["memory"]
        print(json.dumps({
            "arch": cfg.name, "cell": record["shape"],
            "layers": cfg.num_layers, "microbatches": cfg.microbatches,
            "remat_segments": cfg.remat_segments,
            "params": record["num_params"],
            "arguments_gb": mem["argument_size_in_bytes"] / 1e9,
            "temps_gb": mem["temp_size_in_bytes"] / 1e9,
            "predicted_peak_gb": record["predicted_peak_bytes"] / 1e9,
            "kernel_launches": record["kernel_launches"],
            "ops": record["ops"], "lower_s": record["lower_s"]}))
        return

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                run_cell(arch, shape, multi_pod=False,
                         save_hlo=not args.no_hlo)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, False, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape}: {e}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
