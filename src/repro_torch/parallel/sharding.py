"""Sharding rules: logical tensor roles -> mesh partition specs (port of
``parallel/sharding.py``).

The production mesh is ``("data", "model")`` single-pod or
``("pod", "data", "model")`` multi-pod (see ``launch/mesh.py``).  The
GEPS grid-brick placement maps:

- the *brick* axes (event/batch shards that never move) -> ``("pod","data")``,
- tensor parallelism inside a node group                 -> ``"model"``,
- FSDP (ZeRO-3) parameter sharding                       -> ``"data"``
  (never ``"pod"``: cross-pod traffic is kept to result merges).

Roles are resolved against actual dimension sizes: a dimension that does
not divide the mesh axis falls back to replication.  A spec is a tuple
with one entry a dimension: an axis name, a tuple of axis names, or
None, equal entry for entry to ``tuple(PartitionSpec(...))`` of the
reference (which writes a one-axis tuple as the bare name).

The port's meshes are one device, or emulated on one device
(``make_mesh_of(..., emulate=True)``): every shard of a tensor is the
whole tensor on that device, so the constraints ``ws`` and ``act_*``
return their input unchanged.  The Sharder reads only ``axis_names`` and
``devices.shape`` of its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple


class Sharder:
    """Resolves logical roles to mesh axes for one (config, mesh) pair.

    Roles:
      batch   – global batch / brick axis -> ("pod","data") (or ("data",))
      fsdp    – parameter d_model-like dim -> "data" (if cfg.fsdp_params)
      tensor  – TP dim (heads / d_ff / vocab / recurrent width) -> "model"
      expert  – MoE expert dim -> "model" when cfg.moe_sharding == "ep"
      moe_ff  – MoE d_ff dim   -> "model" when cfg.moe_sharding == "tp"
      seq     – sequence dim -> "model" when cfg.seq_shard_norm (SP sections)
      null    – replicated
    """

    def __init__(self, cfg, mesh):
        self.cfg = cfg
        self.mesh = mesh
        sizes = mesh_axis_sizes(mesh)
        names = mesh.axis_names
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.batch_size_total = 1
        for a in self.batch_axes:
            self.batch_size_total *= sizes[a]
        self.fsdp_axis: Optional[str] = "data" if "data" in names else None
        self.tensor_axis: Optional[str] = "model" if "model" in names else None
        self.tensor_size = sizes.get("model", 1)
        self.fsdp_size = sizes.get("data", 1)

    # ------------------------------------------------------------------ #
    def _resolve(self, role: Optional[str], dim: int):
        cfg = self.cfg
        if role in (None, "null"):
            return None
        if role == "batch":
            if not self.batch_axes:
                return None
            return self.batch_axes if dim % self.batch_size_total == 0 else None
        if role == "fsdp":
            if not cfg.fsdp_params or self.fsdp_axis is None:
                return None
            return self.fsdp_axis if dim % self.fsdp_size == 0 else None
        if role == "fsdp_act":  # activation dim sharded over data irrespective
            if self.fsdp_axis is None:
                return None
            return self.fsdp_axis if dim % self.fsdp_size == 0 else None
        if role == "tensor":
            if self.tensor_axis is None:
                return None
            return self.tensor_axis if dim % self.tensor_size == 0 else None
        if role == "expert":
            if cfg.num_experts and cfg.moe_sharding == "ep":
                return self._resolve("tensor", dim)
            return None
        if role == "moe_ff":
            if cfg.num_experts and cfg.moe_sharding == "tp":
                return self._resolve("tensor", dim)
            return None
        if role == "moe_d":
            return self._resolve("fsdp", dim)
        if role == "seq":
            if not cfg.seq_shard_norm:
                return None
            return self._resolve("tensor", dim)
        raise ValueError(f"unknown sharding role: {role}")

    def spec(self, roles: Sequence[Optional[str]],
             shape: Sequence[int]) -> tuple:
        if len(roles) != len(shape):
            raise ValueError(f"roles {tuple(roles)} and shape "
                             f"{tuple(shape)} differ in length")
        out = []
        for r, d in zip(roles, shape):
            axes = self._resolve(r, d)
            if isinstance(axes, tuple) and len(axes) == 1:
                axes = axes[0]
            out.append(axes)
        return tuple(out)

    def named(self, roles: Sequence[Optional[str]],
              shape: Sequence[int]) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(roles, shape))

    # ------------------------------------------------------------------ #
    def ws(self, x, *roles: Optional[str]):
        """The sharding constraint by logical roles: on the port's meshes
        (one device, or emulated on one) every shard is the whole tensor,
        so ``x`` comes back unchanged once its roles are checked."""
        self.spec(roles, x.shape)
        return x

    # Convenience activation constraints ------------------------------- #
    def act_btd(self, x):  # (batch, seq, d_model)
        return self.ws(x, "batch", None, None)

    def act_bthd(self, x):  # (batch, seq, heads, head_dim)
        return self.ws(x, "batch", None, "tensor", None)

    def act_btf(self, x):  # (batch, seq, d_ff)
        return self.ws(x, "batch", None, "tensor")

    def act_btv(self, x):  # (batch, seq, vocab)
        return self.ws(x, "batch", None, "tensor")

    def batch_spec(self, shape) -> tuple:
        return self.spec(["batch"] + [None] * (len(shape) - 1), shape)
