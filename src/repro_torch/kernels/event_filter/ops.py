"""Event-filter dispatch + query-AST pattern matcher.

``filter_and_summarize`` accepts the GEPS canonical hot-query family

    "<scalar> > A && count(pt > B) >= C [&& sum(pt) < D]"

extracts (A, B, C, D) from the parsed AST and dispatches to the fused
kernel; anything else goes to the plain compiled query (same results,
just without the fusion win).

:func:`event_filter` and :func:`event_filter_batch` dispatch on the
tensors' device: CUDA tensors launch the hand-written kernel
(``kernel.py``), CPU tensors take the plain version (``ref.py``), and
any other device raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import query as q
from repro_torch.kernels.event_filter import kernel as ef_kernel
from repro_torch.kernels.event_filter.ref import (event_filter_batch_ref,
                                                  event_filter_ref)


def match_canonical(expr: str, schema) -> Optional[dict]:
    """Returns kernel params if the expression matches the FULL hot
    family — a strictness check over :func:`match_epilogue` (one matcher
    encodes the kernel's term shapes): both the scalar-threshold and the
    count terms must be present."""
    params = match_epilogue(expr, schema)
    if params is None or not {"scalar", "count"} <= params["terms"]:
        return None
    return params


def batch_kernel_params(params, *, device: Union[str, torch.device]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble the batched kernel's inputs from per-target param dicts
    (``match_canonical`` / ``match_epilogue`` output): the ``(4, K)``
    float32 thresholds tensor — rows [scalar_thresh; pt_thresh;
    min_count; sum_cap] — and the ``(K,)`` int32 ``var_idx`` tensor, both
    on ``device``.  The single place the kernel's threshold-row layout is
    encoded on the host side."""
    thresholds = torch.tensor(
        [[p["scalar_thresh"] for p in params],
         [p["pt_thresh"] for p in params],
         [p["min_count"] for p in params],
         [p["sum_cap"] for p in params]], dtype=torch.float32,
        device=device)                                   # (4, K)
    var_idx = torch.tensor([p["var_idx"] for p in params], dtype=torch.int32,
                           device=device)
    return thresholds, var_idx


def match_epilogue(target, schema) -> Optional[dict]:
    """Relaxed matcher for kernel-EPILOGUE fusion of fragment-plan targets.

    ``match_canonical`` requires the full hot family (scalar threshold AND
    count term); a fragment plan's targets also include materialized
    boolean fragments that are *subsets* of it — a bare
    ``count(pt > 15) >= 2`` conjunct, a lone scalar cut.  This matcher
    accepts any ``&&``-conjunction of the kernel's three term shapes with
    each term OPTIONAL (at least one present):

        <scalar> > A    |    count(pt > B) >= C    |    sum(pt) < D

    and encodes missing terms as neutral thresholds the kernel epilogue
    already treats as pass-through: no scalar term -> ``scalar_thresh =
    -inf`` (any finite scalar passes), no count term -> ``min_count = 0``
    (the count accumulator is always >= 0), no sum term -> ``sum_cap =
    -1`` (the kernel's existing no-cap sentinel; a sum term with D <= 0
    is rejected rather than aliased onto it).  A scalar outside the
    schema's columns is outside the family (the kernel could not read
    it).  ``target`` is an AST node (what :meth:`FragmentPlan.targets`
    holds) or an expression string.  Returns kernel params — with
    ``"terms"``, the set of term kinds that were present, so
    :func:`match_canonical` can impose its stricter full-family
    requirement — or None when the target is outside the family."""
    if isinstance(target, str):
        try:
            target = q.parse(target)
        except q.QueryError:
            return None

    def is_cmp(node, op):
        return isinstance(node, q.Bin) and node.op == op

    terms = []

    def flatten_and(node):
        if isinstance(node, q.Bin) and node.op == "&&":
            flatten_and(node.lhs)
            flatten_and(node.rhs)
        else:
            terms.append(node)

    flatten_and(target)
    out = {"var_idx": 0, "scalar_thresh": float("-inf"),
           "pt_thresh": 0.0, "min_count": 0.0, "sum_cap": -1.0}
    seen = set()
    for t in terms:
        if (is_cmp(t, ">") and isinstance(t.lhs, q.Var)
                and isinstance(t.rhs, q.Num) and "scalar" not in seen):
            try:
                out["var_idx"] = schema.scalar_index(t.lhs.name)
            except ValueError:
                return None
            if out["var_idx"] >= schema.n_scalars:
                return None
            out["scalar_thresh"] = t.rhs.value
            seen.add("scalar")
        elif (is_cmp(t, ">=") and isinstance(t.lhs, q.Agg)
              and t.lhs.fn == "count" and is_cmp(t.lhs.arg, ">")
              and isinstance(t.lhs.arg.lhs, q.Var)
              and t.lhs.arg.lhs.name == "pt"
              and isinstance(t.lhs.arg.rhs, q.Num)
              and isinstance(t.rhs, q.Num) and "count" not in seen):
            out["pt_thresh"] = t.lhs.arg.rhs.value
            out["min_count"] = t.rhs.value
            seen.add("count")
        elif (is_cmp(t, "<") and isinstance(t.lhs, q.Agg)
              and t.lhs.fn == "sum" and isinstance(t.lhs.arg, q.Var)
              and t.lhs.arg.name == "pt" and isinstance(t.rhs, q.Num)
              and t.rhs.value > 0 and "sum" not in seen):
            out["sum_cap"] = t.rhs.value
            seen.add("sum")
        else:
            return None
    if not seen:
        return None
    out["terms"] = frozenset(seen)
    return out


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError("event_filter operands are on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"event_filter has no kernel for device {dev}")
    return dev


def event_filter(scalars, tracks, n_tracks, thresholds, var_idx, *,
                 calib_iters: int):
    """Single-query dispatch: thresholds (4,) f32 = [scalar_thresh,
    pt_thresh, min_count, sum_cap], var_idx a (1,) int32 tensor.  CUDA
    tensors launch the kernel, CPU tensors take the plain version.
    Returns (mask (N,), var (N,))."""
    dev = _device_of(scalars, tracks, n_tracks, thresholds, var_idx)
    if dev.type == "cuda":      # the wrapper validates
        return ef_kernel.event_filter_cuda(
            scalars, tracks, n_tracks, thresholds, var_idx,
            calib_iters=calib_iters)
    ef_kernel.validate(scalars, tracks, n_tracks, thresholds, batch=False)
    a, b, c, d = thresholds.tolist()
    return event_filter_ref(
        scalars, tracks, n_tracks, var_idx=int(var_idx[0]),
        scalar_thresh=a, pt_thresh=b, min_count=c, sum_cap=d,
        calib_iters=calib_iters)


def event_filter_batch(scalars, tracks, n_tracks, thresholds, var_idx, *,
                       calib_iters: int, threads=None):
    """K-query dispatch (thresholds and var_idx in the layout of
    :func:`batch_kernel_params`): CUDA tensors launch the kernel with
    ``threads`` a block (one of ``kernel.LAUNCH_THREADS``; None: the
    default), CPU tensors take the plain version, which validates
    ``threads`` and has no launch for it to shape.  Returns (mask (N, K),
    var (N,))."""
    dev = _device_of(scalars, tracks, n_tracks, thresholds, var_idx)
    if dev.type == "cuda":      # the wrapper validates
        return ef_kernel.event_filter_batch_cuda(
            scalars, tracks, n_tracks, thresholds, var_idx,
            calib_iters=calib_iters, threads=threads)
    ef_kernel.check_threads(threads)
    ef_kernel.validate(scalars, tracks, n_tracks, thresholds, batch=True)
    return event_filter_batch_ref(scalars, tracks, n_tracks, thresholds,
                                  var_idx=var_idx, calib_iters=calib_iters)


def filter_and_summarize(expr: str, schema, batch, *, calib_iters: int = 0):
    """(mask, var) for an arbitrary expression; kernel path when canonical.

    NOTE: when the kernel handles calibration the caller must pass the RAW
    batch (core.jse passes calib_iters through here instead of
    pre-calibrating)."""
    params = match_canonical(expr, schema)
    if params is None:
        pred = q.compile_query(expr, schema)
        b = batch
        if calib_iters:
            b = dict(b, tracks=q.calibrate(b, calib_iters))
        return pred(b), b["scalars"][:, 0]
    thresholds, var_idx = batch_kernel_params(
        [params], device=batch["scalars"].device)
    return event_filter(
        batch["scalars"], batch["tracks"], batch["n_tracks"],
        thresholds[:, 0].contiguous(), var_idx, calib_iters=calib_iters)


def filter_and_summarize_batch(exprs: Sequence[str], schema, batch, *,
                               calib_iters: int = 0):
    """K-query shared scan: (masks (K, N), var (N,)).

    The fused batched kernel runs when EVERY expression matches the
    canonical hot family; a single non-canonical straggler drops the whole
    window to the stacked-predicate plain path (still one sweep, one
    shared calibration — just without the kernel's track-streaming
    fusion)."""
    params = [match_canonical(e, schema) for e in exprs]
    if any(p is None for p in params):
        bpred = q.compile_query_batch(exprs, schema)
        b = batch
        if calib_iters:
            b = dict(b, tracks=q.calibrate(b, calib_iters))
        return bpred(b), b["scalars"][:, 0]
    thresholds, var_idx = batch_kernel_params(
        params, device=batch["scalars"].device)
    mask, var = event_filter_batch(
        batch["scalars"], batch["tracks"], batch["n_tracks"], thresholds,
        var_idx, calib_iters=calib_iters)
    # (K, N) in the plain path's layout, so the caller's reductions see
    # the same memory order whichever path produced the masks
    return mask.T.contiguous(), var
