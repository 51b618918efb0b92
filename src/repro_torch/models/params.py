"""Parameter tables: a single source of truth for shapes, sharding roles and
initialization of every model parameter (port of ``models/params.py``).

Each architecture family builds a ``ParamTable`` (path -> ParamDef).  From
the table the port derives its parameters:

- ``init(generator, device)``  -> real parameter tree, drawn with torch's RNG
- ``specs(sharder)``            -> partition specs (``parallel/sharding.py``)
- ``shardings(sharder)``        -> ``NamedSharding`` tree
- ``abstract_sharded(sharder)`` -> ``meta`` tensors with their specs
- ``params_from_reference(cfg, tree)`` -> the JAX package's parameters
  (numpy arrays) as the port's, so both packages compute the same thing

Paths are "/"-separated; the tree is a nested dict split on "/".  On the
port's meshes (one card, or a mesh emulated on it) every shard of a
parameter is the whole parameter, so the specs place nothing: they are
what the reference's mesh would do with each leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

NOT_PORTED = "is not ported to repro_torch yet"
#: ``init`` draws a normal or fan_in leaf in slices of its first axis, each
#: as many indices of it as DRAW_SLICE elements (4 GiB of f32) hold, and at
#: least one, so its f32 transient is at most one slice: a leaf of up to
#: DRAW_SLICE elements is one draw.  qwen3-32b's stacked MLP weights (64 x
#: 5120 x 25600, 8.4e9 elements) drawn whole would need a 33.6 GB f32
#: transient beside the model's other 48.7 GB of bf16 weights and the
#: leaf's own 16.8 GB: 99 GB, more than one 80 GB card
DRAW_SLICE = 1 << 30


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    roles: Tuple[Optional[str], ...]  # sharding roles, one per dim
    init: str = "normal"  # normal | zeros | ones | fan_in | lru_a
    scale: float = 0.02
    dtype: Optional[str] = None  # override cfg.param_dtype
    zero_pad: Optional[Tuple[int, int]] = None  # (axis, real_size): slots
    #   beyond real_size on axis are zero-initialized (exact head padding)

    def __post_init__(self):
        if len(self.shape) != len(self.roles):
            raise ValueError(f"shape {self.shape} and roles {self.roles} "
                             "differ in length")


@dataclasses.dataclass(frozen=True)
class AbstractParam:
    """A leaf without storage (the reference's sharded
    ``ShapeDtypeStruct``): ``value`` on the ``meta`` device, ``spec`` its
    partition spec."""
    value: torch.Tensor
    spec: tuple


def torch_dtype(name: str) -> torch.dtype:
    """``torch.bfloat16`` for ``"bfloat16"`` and so on."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class ParamTable:
    def __init__(self, cfg):
        self.cfg = cfg
        self.defs: Dict[str, ParamDef] = {}

    def add(self, path: str, shape, roles, init="normal", scale=0.02,
            dtype=None, zero_pad=None):
        if path in self.defs:
            raise ValueError(f"duplicate param {path}")
        self.defs[path] = ParamDef(tuple(shape), tuple(roles), init, scale,
                                   dtype, zero_pad)

    # ------------------------------------------------------------------ #
    def _nested(self, leaf_fn: Callable[[str, ParamDef], object]) -> dict:
        tree: dict = {}
        for path, d in self.defs.items():
            node = tree
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf_fn(path, d)
        return tree

    def dtype(self, d: ParamDef) -> torch.dtype:
        return torch_dtype(d.dtype or self.cfg.param_dtype)

    def init(self, generator: torch.Generator,
             device: Union[str, torch.device]) -> dict:
        """Draw every parameter on ``device`` from ``generator`` (which
        lives on the same device), path by path in sorted order, under the
        reference's rules: ``normal`` (scale 0.02), ``fan_in`` with scale
        ``1/sqrt(shape[-2])`` as the reference reads it (C-ref5: for
        ``wq (L, d, Hp, hd)`` that is Hp), ``zeros``, ``ones``, and
        ``zero_pad`` zeroing the padded heads, and ``lru_a`` (the RG-LRU
        decay parameter: ``u ~ U(0.9, 0.999)`` in f32, then
        ``log(exp(-8 log u) - 1)``).  As the reference, ``fan_in`` and
        ``ones`` ignore ``scale`` (C-ref6).  torch's RNG gives other
        numbers than ``jax.random`` for the same seed."""
        device = torch.device(device)
        values = {path: self._draw(self.defs[path], generator, device)
                  for path in sorted(self.defs)}
        return self._nested(lambda path, d: values[path])

    def _draw(self, d: ParamDef, gen, device) -> torch.Tensor:
        dt = self.dtype(d)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "lru_a":
            # softplus^-1 spacing, so that a = exp(-8 softplus(lam) r)
            # starts in a stable regime
            u = torch.rand(d.shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(0.999 - 0.9).add_(0.9)
            return torch.log(torch.exp(-8.0 * torch.log(u)) - 1.0).to(dt)
        scale = d.scale
        if d.init == "fan_in":
            scale = 1.0 / math.sqrt(max(1, d.shape[-2] if len(d.shape) > 1
                                        else d.shape[0]))
        elif d.init != "normal":
            raise ValueError(f"init {d.init!r} {NOT_PORTED}")
        # slice by slice of the first axis (DRAW_SLICE): the same
        # distribution from the same generator, in place in each slice
        out = torch.empty(d.shape, dtype=dt, device=device)
        rows = max(1, DRAW_SLICE // (math.prod(d.shape) // d.shape[0]))
        for lo in range(0, d.shape[0], rows):
            part = out[lo:lo + rows]
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32).mul_(scale))
        if d.zero_pad is not None:
            axis, real = d.zero_pad
            out.narrow(axis, real, d.shape[axis] - real).zero_()
        return out

    def specs(self, sharder) -> dict:
        return self._nested(lambda path, d: sharder.spec(d.roles, d.shape))

    def shardings(self, sharder) -> dict:
        return self._nested(lambda path, d: sharder.named(d.roles, d.shape))

    def abstract_sharded(self, sharder) -> dict:
        """Each leaf as an ``AbstractParam``: a tensor of its shape and
        dtype on the ``meta`` device (no storage) and its spec."""
        return self._nested(lambda path, d: AbstractParam(
            torch.empty(d.shape, dtype=self.dtype(d), device="meta"),
            sharder.spec(d.roles, d.shape)))

    def num_params(self) -> int:
        return sum(int(np_prod(d.shape)) for d in self.defs.values())

    def bytes(self) -> int:
        return sum(int(np_prod(d.shape)) * self.dtype(d).itemsize
                   for d in self.defs.values())


def np_prod(shape: Sequence[int]) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def params_from_reference(cfg, tree: dict,
                          device: Union[str, torch.device] = "cuda") -> dict:
    """The JAX package's parameter tree for ``cfg`` (nested dicts of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's
    parameter tree on ``device``, each leaf in its table dtype.  Raises if
    a path is missing, extra, or of another shape."""
    from repro_torch.kernels import resolve_device
    from repro_torch.models.model_zoo import build_model
    device = resolve_device(device)
    table = build_model(cfg).table
    flat = _flatten(tree)
    if set(flat) != set(table.defs):
        raise ValueError(
            f"parameter paths differ from the table: missing "
            f"{sorted(set(table.defs) - set(flat))}, extra "
            f"{sorted(set(flat) - set(table.defs))}")

    def leaf(path, d: ParamDef):
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != d.shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, the table "
                             f"says {d.shape}")
        # numpy has no bfloat16: go through f32, which holds it exactly
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return t.to(device=device, dtype=table.dtype(d))

    return table._nested(leaf)
