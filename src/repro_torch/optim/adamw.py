"""AdamW on torch tensors (port of ``optim/adamw.py``).

Moments are f32 (params stay in cfg.param_dtype, bf16 on target); the
optimizer state mirrors the parameter tree leaf for leaf.  The update
runs in place and over slices of each leaf's leading axis (the layer
axis of the stacked layer parameters), at most ``SLICE_ELEMENTS`` at a
time: the reference's formula makes about six f32 temporaries of a whole
leaf, which for starcoder2-3b's ``layers/mlp/w_in`` (1.13 B elements) is
4.5 GB each on top of 54 GB of training state.  Each element still takes
the reference's operations in the reference's order, so a slice gives
the same bits as the whole leaf.  The grad norm's squares are summed in
f64 (``global_norm``, C-ref13).  ``abstract_opt_state`` and ``opt_specs``
give the state's shapes and partition specs without storage, leaf for
leaf those of the parameters (``ParamTable.abstract_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Union

import numpy as np
import torch

from repro_torch.models.params import torch_dtype

#: elements of one slice of the update and of the norm's squares
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {key: _map(fn, *(t[key] for t in trees)) for key in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree.leaves``: sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _slices(n_rows: int, row_elements: int) -> Iterator[slice]:
    """Ranges of the leading axis of about ``SLICE_ELEMENTS`` elements."""
    step = max(1, SLICE_ELEMENTS // max(1, row_elements))
    for i in range(0, n_rows, step):
        yield slice(i, min(i + step, n_rows))


def _row_slices(x: torch.Tensor) -> Iterator:
    """Index of each slice of ``x``'s leading axis (``...`` for a 0-dim
    tensor)."""
    if x.dim() == 0:
        yield ...
        return
    yield from _slices(x.shape[0], x[0].numel() if x.shape[0] else 0)


def init_opt_state(params, opt: AdamW):
    dt = torch_dtype(opt.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_leaves(params)[0].device)}


def abstract_opt_state(params_abstract, opt: AdamW):
    """The state of ``init_opt_state`` without storage: each moment an
    ``AbstractParam`` (``meta`` tensor in the moment dtype) keeping its
    parameter's spec, ``count`` a 0-dim int32 ``meta`` tensor."""
    from repro_torch.models.params import AbstractParam
    dt = torch_dtype(opt.moment_dtype)

    def mirror(p):
        return AbstractParam(torch.empty(p.value.shape, dtype=dt,
                                         device="meta"), p.spec)

    return {"m": _map(mirror, params_abstract),
            "v": _map(mirror, params_abstract),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def opt_specs(param_specs):
    """The partition-spec tree of the optimizer state for the parameters'
    spec tree: the moments sharded as their parameters, ``count``
    replicated."""
    return {"m": param_specs, "v": param_specs, "count": ()}


def opt_state_from_reference(cfg, state: dict,
                             device: Union[str, torch.device] = "cuda"
                             ) -> dict:
    """The JAX package's optimizer state for ``cfg``'s model (``m``, ``v``
    as nested dicts of numpy arrays, ``count``) as the port's on
    ``device``: the moments in their own dtype (f32, or bf16 read through
    f32, which holds it exactly), ``count`` int32.  Raises if a path is
    missing, extra, or of another shape."""
    from repro_torch.kernels import resolve_device
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import _flatten
    device = resolve_device(device)
    table = build_model(cfg).table
    out = {}
    for key in ("m", "v"):
        flat = _flatten(state[key])
        if set(flat) != set(table.defs):
            raise ValueError(
                f"{key}: paths differ from the table: missing "
                f"{sorted(set(table.defs) - set(flat))}, extra "
                f"{sorted(set(flat) - set(table.defs))}")

        def leaf(path, d, flat=flat, key=key):
            arr = np.asarray(flat[path])
            if tuple(arr.shape) != d.shape:
                raise ValueError(f"{key}/{path}: shape {tuple(arr.shape)}, "
                                 f"the table says {d.shape}")
            dt = torch_dtype(str(arr.dtype))
            t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
            return t.to(device=device, dtype=dt)

        out[key] = table._nested(leaf)
    out["count"] = torch.tensor(int(np.asarray(state["count"])),
                                dtype=torch.int32, device=device)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaves in the
    reference's order, as a 0-dim f32 tensor.  The squares are summed in
    f64, a slice of each leaf's leading axis at a time, then the root is
    rounded to f32: the reference sums them in f32, which overflows to inf
    once the norm passes ~1.8e19 although the norm itself is a finite f32
    (C-ref13: starcoder2-3b's first gradient at full width under the
    reference's initialisation has a norm of ~1e23), and its clip factor
    then zeroes the step.  Below that the two differ only in the sum's
    rounding (~1e-7 relative)."""
    total = None
    for leaf in _leaves(tree):
        for sl in _row_slices(leaf):
            part = torch.sum(torch.square(leaf[sl].double()))
            total = part if total is None else total + part
    return torch.sqrt(total).float()


def _update_slice(p, g, m, v, *, clip, c1, c2, lr, opt: AdamW):
    """The reference's ``upd`` on one slice, written back in place."""
    b1, b2 = opt.b1, opt.b2
    g = g.float() * clip
    m_new = b1 * m.float() + (1 - b1) * g
    v_new = b2 * v.float() + (1 - b2) * torch.square(g)
    mhat = m_new / c1
    vhat = v_new / c2
    step = mhat / (torch.sqrt(vhat) + opt.eps)
    step = step + opt.weight_decay * p.float()
    p.copy_((p.float() - lr * step).to(p.dtype))
    m.copy_(m_new.to(m.dtype))
    v.copy_(v_new.to(v.dtype))


@torch.no_grad()
def adamw_update(params, grads, state, lr, opt: AdamW):
    """One AdamW step, in place: ``params`` and ``state``'s ``m``, ``v``
    and ``count`` are updated and returned as ``(params, state,
    metrics)``, the reference's signature (the reference returns new
    trees).  ``lr`` is a float or a 0-dim tensor; ``metrics`` holds the
    grad norm before clipping, as a 0-dim f32 tensor."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=torch.float32,
                                      device=cf.device), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)
    flat = zip(_leaves(params), _leaves(grads), _leaves(state["m"]),
               _leaves(state["v"]))
    for p, g, m, v in flat:
        for sl in _row_slices(p):
            _update_slice(p[sl], g[sl], m[sl], v[sl], clip=clip, c1=c1,
                          c2=c2, lr=lr, opt=opt)
    state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm}
