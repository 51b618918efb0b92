"""Optimized-HLO walker: per-device FLOPs, bytes, and collective bytes
(port of ``analysis/hlo_parse.py``: the walker is a copy, as the module
has no framework code, so the port reads the reference's HLO artifacts
with the reference's rules; :func:`analyze_trace` is the port's own).

Why not ``compiled.cost_analysis()``: on the CPU backend it counts a
``while`` body ONCE, and our programs are scans-of-scans (microbatch loop x
layer scan x kv-chunk scan), so its numbers are off by the product of trip
counts.  This walker:

1. splits the optimized HLO into computations,
2. reads each while loop's trip count out of its condition computation
   (the ``constant(N)`` the induction variable is compared against),
3. walks the call graph from ENTRY with multiplicities
   (while body x trip count, fusions/calls x 1),
4. accumulates:
   - flops: 2 * prod(out_shape) * contraction_size for every dot (fusion
     internals included), conservative elementwise ignored,
   - bytes: at fusion granularity — operands + outputs of materialized
     ops (fusion internals are free, matching XLA's fusion model),
   - collective bytes: operand sizes of all-reduce / all-gather /
     reduce-scatter / all-to-all / collective-permute.

Everything is per-device (the SPMD module is the per-device program).

The port has no HLO: it runs eagerly, one ATen op after another, and its
dry run (``launch/dryrun.py``) records the ops of a step as it runs them
on the ``meta`` device.  :func:`analyze_trace` computes the same
``Totals`` over that op trace, the port's stand-in for the optimized
HLO:

- flops: matmuls and convolutions only, as :func:`analyze` counts only
  dots and convolutions, by ``torch.utils.flop_counter``'s formulas
  (the dry run stores each op's count), plus each kernel entry's own
  flops (``roofline.kernel_work``);
- bytes: operands plus outputs of every op that materialises; views and
  aliases are free, as ``_SKIP_BYTES_OPS`` are here.  The eager port
  fuses nothing, so this is what it moves; a kernel entry moves its
  inputs once and its outputs once;
- collective_bytes: 0.  The port drives one card: no op of its step is
  a collective;
- while_loops: empty.  The trace holds every op each time it ran, so no
  loop's trip count is read or guessed.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4, "u64": 8,
    "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1, "c64": 8,
    "c128": 16, "token": 0, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->.*\{\s*$")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of possibly-tuple shape string like 'f32[2,3]' or
    '(f32[2], bf16[4])'."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def shape_elems(shape_str: str) -> int:
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return 0
    n = 1
    for d in m.group(2).split(","):
        if d:
            n *= int(d)
    return n


@dataclasses.dataclass
class Instr:
    name: str
    shape: str       # output shape string
    op: str
    rest: str        # remainder of the line (operands + attrs)


@dataclasses.dataclass
class Computation:
    name: str
    instrs: List[Instr]
    defs: Dict[str, str]  # instr name -> output shape string


def parse_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in hlo.splitlines():
        mc = _COMP_RE.match(line)
        if mc:
            cur = Computation(mc.group(1), [], {})
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        md = _DEF_RE.match(line)
        if md:
            name, shape, op, rest = md.groups()
            cur.instrs.append(Instr(name, shape, op, rest))
            cur.defs[name] = shape
    return comps


def _operand_names(rest: str) -> List[str]:
    """Names of %operands up to the closing paren of the op call."""
    out = []
    depth = 1
    for m in re.finditer(r"%([\w.\-]+)|([()])", rest):
        if m.group(2) == "(":
            depth += 1
        elif m.group(2) == ")":
            depth -= 1
            if depth == 0:
                break
        elif m.group(1) and depth >= 1:
            out.append(m.group(1))
    return out


def dot_flops(instr: Instr, defs: Dict[str, str]) -> int:
    """2 * prod(output) * contraction size (batch dims handled since they
    appear in the output)."""
    ops = _operand_names(instr.rest)
    if not ops:
        return 0
    lhs_shape = defs.get(ops[0], "")
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", instr.rest)
    if not m or not lhs_shape:
        return 0
    dims_m = _SHAPE_RE.search(lhs_shape)
    if not dims_m:
        return 0
    lhs_dims = [int(d) for d in dims_m.group(2).split(",") if d]
    contraction = 1
    for i in (int(x) for x in m.group(1).split(",") if x):
        if i < len(lhs_dims):
            contraction *= lhs_dims[i]
    return 2 * shape_elems(instr.shape) * contraction


def while_trip_count(cond: Computation) -> int:
    """Largest s32 constant in the condition — scans compare the induction
    variable against the trip count."""
    best = 1
    for ins in cond.instrs:
        if ins.op == "constant" and ins.shape.startswith("s32"):
            m = re.search(r"constant\((\d+)\)", "constant(" + ins.rest)
            if m:
                best = max(best, int(m.group(1)))
    return best


_SKIP_BYTES_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "partition-id", "replica-id", "iota",
}


def instr_bytes(ins: Instr, defs: Dict[str, str]) -> float:
    """HBM traffic model per instruction.

    Slicing ops touch only the slice, not the buffer they index into
    (dynamic-slice of a (L, ...) weight stack inside a scan reads one
    layer's weights, not L layers'); updates are in-place (aliased)."""
    out_b = shape_bytes(ins.shape)
    ops = _operand_names(ins.rest)
    if ins.op in ("dynamic-slice", "slice", "gather"):
        return 2.0 * out_b
    if ins.op == "dynamic-update-slice":
        upd = shape_bytes(defs.get(ops[1], "")) if len(ops) > 1 else out_b
        return 2.0 * upd
    if ins.op == "scatter":
        upd = shape_bytes(defs.get(ops[2], "")) if len(ops) > 2 else out_b
        return 2.0 * upd
    if ins.op in ("reshape", "transpose", "copy", "convert", "broadcast",
                  "reverse", "concatenate", "pad"):
        return 2.0 * out_b
    # dot / reduce / elementwise / select etc: operands + output
    opb = sum(shape_bytes(defs.get(o, "")) for o in ops)
    return opb + out_b


def _internal_bytes(comp: Computation) -> float:
    total = 0.0
    for ins in comp.instrs:
        if ins.op in _SKIP_BYTES_OPS or ins.op == "fusion":
            continue
        total += instr_bytes(ins, comp.defs)
    return total


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    while_loops: List[Tuple[str, int, float]] = dataclasses.field(
        default_factory=list)  # (body name, trip, mult)


def analyze(hlo: str) -> Totals:
    comps = parse_computations(hlo)
    entry = None
    for line in hlo.splitlines():
        if line.startswith("ENTRY"):
            m = _COMP_RE.match(line)
            if m:
                entry = m.group(1)
            break
    if entry is None:  # fall back: last computation
        entry = list(comps)[-1]

    totals = Totals()
    visited_stack = []

    def walk(comp_name: str, mult: float, count_bytes: bool):
        comp = comps.get(comp_name)
        if comp is None or comp_name in visited_stack:
            return
        visited_stack.append(comp_name)
        for ins in comp.instrs:
            if ins.op == "while":
                m = re.search(r"condition=%?([\w.\-]+)", ins.rest)
                mb = re.search(r"body=%?([\w.\-]+)", ins.rest)
                trip = while_trip_count(comps[m.group(1)]) if (
                    m and m.group(1) in comps) else 1
                if mb and mb.group(1) in comps:
                    totals.while_loops.append((mb.group(1), trip, mult))
                    walk(mb.group(1), mult * trip, count_bytes)
                continue
            if ins.op in ("call", "conditional", "custom-call"):
                for mm in re.finditer(r"(?:to_apply|calls)=%?([\w.\-]+)",
                                      ins.rest):
                    walk(mm.group(1), mult, count_bytes)
                continue
            if ins.op == "fusion":
                mm = re.search(r"calls=%?([\w.\-]+)", ins.rest)
                callee = mm.group(1) if mm and mm.group(1) in comps else None
                if callee:
                    # fusion internals: flops only (bytes handled below)
                    walk(callee, mult, False)
                if count_bytes:
                    # two estimates, take the smaller:
                    # - boundary: operands + output (right for compute
                    #   fusions, overcounts in-place update fusions whose
                    #   output aliases a whole stacked buffer)
                    # - internals: sum of per-op traffic with slice/DUS
                    #   rules (right for update fusions, overcounts long
                    #   fused elementwise chains)
                    out_b = shape_bytes(ins.shape)
                    boundary = out_b + sum(
                        shape_bytes(comp.defs.get(o, ""))
                        for o in _operand_names(ins.rest))
                    internal = _internal_bytes(comps[callee]) if callee \
                        else boundary
                    totals.bytes += mult * min(boundary, internal)
                continue
            if ins.op == "dot":
                totals.flops += mult * dot_flops(ins, comp.defs)
            if ins.op.startswith("convolution"):
                # rough: 2 * out elems * kernel elems (kernel = operand 1)
                ops = _operand_names(ins.rest)
                kshape = comp.defs.get(ops[1], "") if len(ops) > 1 else ""
                totals.flops += mult * 2 * shape_elems(ins.shape) * max(
                    1, shape_elems(kshape) // max(1, shape_elems(ins.shape)))
            if any(ins.op.startswith(c) for c in COLLECTIVES):
                opb = sum(shape_bytes(comp.defs.get(o, ""))
                          for o in _operand_names(ins.rest))
                totals.collective_bytes += mult * opb
                key = ins.op
                totals.collective_by_op[key] = (
                    totals.collective_by_op.get(key, 0.0) + mult * opb)
            if count_bytes and ins.op not in _SKIP_BYTES_OPS:
                totals.bytes += mult * instr_bytes(ins, comp.defs)
        visited_stack.pop()

    walk(entry, 1.0, True)
    return totals


def analyze_trace(trace: dict) -> Totals:
    """``Totals`` of an op trace of the port's dry run
    (``launch/dryrun.OpTrace.as_dict()``, or its ``.trace.json``): the
    ops' flops and bytes as the trace stores them, and each kernel
    entry's, times its count."""
    totals = Totals()
    for op in trace["ops"]:
        totals.flops += op[3]
        totals.bytes += op[4]
    for entry in trace["kernels"]:
        totals.flops += entry["count"] * entry["flops"]
        totals.bytes += entry["count"] * entry["bytes"]
    return totals
