"""AdamW on torch tensors (port of ``optim/adamw.py``).

Moments are in ``moment_dtype`` (f32, grok-1's bf16; params stay in
cfg.param_dtype, bf16 on target); the optimizer state mirrors the
parameter tree leaf for leaf.  The update runs in place.  On CUDA tensors
the grad norm and the update are two hand-written passes
(``kernels/adamw``): one read of each gradient for the norm, one read and
one write of p, m and v for the update, each element rounded as the plain
version below rounds it (the same bits; the norm within an ulp).  CPU and
``meta`` tensors take the plain version, over flat slices of each leaf,
at most ``SLICE_ELEMENTS`` elements at a time: the reference's formula
makes about six f32 temporaries of a whole leaf, which for starcoder2-3b's
``layers/mlp/w_in`` (1.13 B elements) is 4.5 GB each on top of 54 GB of
training state, and for one layer of grok-1's experts
(``layers/moe/w_in``, 1.61 B elements a layer) 6.4 GB each.  Slices cut
across the layer axis and within a layer alike.  Each element still takes
the reference's operations in the reference's order, so a slice gives the
same bits as the whole leaf; bf16 moments are read into f32 and rounded
back once, as the reference's ``m_new.astype(m.dtype)``.  The grad norm's
squares are summed in f64 (``global_norm``, C-ref13).  A traced step
(``obs/trace.py``) sees the update as a ``train.optimizer`` span around
``optim.norm`` and ``optim.update``, with the kernels' launches as its
``kernel_launches``; a dry run's op trace (``launch/dryrun.OpTrace``)
holds the plain version's ops on ``meta`` as the stand-in for the calls
the card launches (``OpTrace.fused``).
``abstract_opt_state`` and ``opt_specs`` give the state's shapes and
partition specs without storage, leaf for leaf those of the parameters
(``ParamTable.abstract_sharded``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Union

import numpy as np
import torch

from repro_torch import kernels as kernel_pkg
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.models.params import torch_dtype
from repro_torch.obs import trace

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


def _flat_slices(x: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``x`` flattened, ``SLICE_ELEMENTS`` elements each (the
    last fewer; ``x`` itself when 0-dim).  ``x`` must be contiguous: the
    views are written in place."""
    if x.dim() == 0:
        yield x
        return
    flat = x.view(-1)
    for i in range(0, flat.numel(), SLICE_ELEMENTS):
        yield flat[i:i + SLICE_ELEMENTS]


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
    reference's order, as a 0-dim f32 tensor: on CUDA tensors the norm
    pass of ``kernels/adamw`` (still being computed on the current
    stream), else :func:`global_norm_plain`."""
    leaves = _leaves(tree)
    if leaves[0].device.type == "cuda":
        return adamw_kernel.norm_and_clip(leaves, AdamW.grad_clip)[0]
    return global_norm_plain(tree)


def global_norm_plain(tree) -> torch.Tensor:
    """:func:`global_norm` in plain PyTorch.  The squares are summed in
    f64, a flat slice of each leaf at a time, then the root is rounded to
    f32: the reference sums them in f32, which overflows to inf once the
    norm passes ~1.8e19 although the norm itself is a finite f32 (C-ref13:
    starcoder2-3b's first gradient at full width under the reference's
    initialisation has a norm of ~1e23), and its clip factor then zeroes
    the step.  Below that the two differ only in the sum's rounding (~1e-7
    relative)."""
    total = None
    for leaf in _leaves(tree):
        for sl in _flat_slices(leaf):
            part = torch.sum(torch.square(sl.double()))
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


def _fused(calls_of, operands, device: torch.device):
    """While a dry run's op trace records a step on the card or on
    ``meta``, the ops inside as the stand-in for the calls ``calls_of``
    plans on ``operands`` (``OpTrace.fused``)."""
    trace_ = kernel_pkg.TRACE
    if trace_ is None or device.type == "cpu":
        return contextlib.nullcontext()
    return trace_.fused(calls_of(operands))


@torch.no_grad()
def adamw_update(params, grads, state, lr, opt: AdamW):
    """One AdamW step, in place: ``params`` and ``state``'s ``m``, ``v``
    and ``count`` are updated and returned as ``(params, state,
    metrics)``, the reference's signature (the reference returns new
    trees).  ``lr`` is a float or a 0-dim tensor; ``metrics`` holds the
    grad norm before clipping, as a 0-dim f32 tensor.  CUDA tensors go
    through the kernels (validated before the first launch), CPU and
    ``meta`` tensors through the plain slices."""
    leaves = list(zip(_leaves(params), _leaves(grads), _leaves(state["m"]),
                      _leaves(state["v"]), strict=True))
    device = leaves[0][0].device
    fused = device.type == "cuda"
    if fused:
        adamw_kernel.validate(leaves)
    grad_leaves = [leaf[1] for leaf in leaves]
    with trace.step_span("train.optimizer") as span:
        launched = adamw_kernel.launches()
        count = state["count"] + 1
        with trace.step_span("optim.norm"), \
                _fused(adamw_kernel.norm_calls, grad_leaves, device):
            if fused:
                gnorm, clip = adamw_kernel.norm_and_clip(grad_leaves,
                                                         opt.grad_clip)
            else:
                gnorm = global_norm_plain(grads)
                clip = torch.clamp(
                    opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=torch.float32,
                                          device=cf.device), cf)
        c2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=torch.float32,
                                          device=cf.device), cf)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)
        slices = 0
        with trace.step_span("optim.update"), \
                _fused(adamw_kernel.update_calls, leaves, device):
            if fused:
                adamw_kernel.update(leaves, clip, c1, c2, lr, opt)
            else:
                for leaf in leaves:
                    if len({x.numel() for x in leaf}) != 1:
                        raise ValueError(
                            "a parameter, its gradient and its moments "
                            f"differ in size: {[x.shape for x in leaf]}")
                    for p, g, m, v in zip(*map(_flat_slices, leaf)):
                        _update_slice(p, g, m, v, clip=clip, c1=c1, c2=c2,
                                      lr=lr, opt=opt)
                        slices += 1
        state["count"].copy_(count)
        if span is not None:
            span.attrs.update(
                slices=slices,
                elements=sum(leaf[0].numel() for leaf in leaves),
                kernel_launches=adamw_kernel.launches() - launched)
    return params, state, {"grad_norm": gnorm}
