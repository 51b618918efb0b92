"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain GELU MLPs (port of
``models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  p holds w_in/(w_gate)/w_out."""
    if cfg.mlp_style in ("swiglu", "geglu"):
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        up = torch.einsum("bsd,df->bsf", x, p["w_in"])
        act = F.silu if cfg.mlp_style == "swiglu" else _gelu
        h = act(gate) * up
    elif cfg.mlp_style == "gelu":
        h = _gelu(torch.einsum("bsd,df->bsf", x, p["w_in"]) + p["b_in"])
    else:
        raise ValueError(cfg.mlp_style)
    out = torch.einsum("bsf,fd->bsd", h, p["w_out"])
    if "b_out" in p:
        out = out + p["b_out"]
    return out


def _gelu(x):
    """The reference's ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def add_mlp_params(table, cfg, prefix: str, layers: int | None = None):
    """Register MLP params; ``layers`` adds a leading layer-stack dim."""
    L = () if layers is None else (layers,)
    Lr = () if layers is None else ("null",)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_style in ("swiglu", "geglu"):
        table.add(f"{prefix}/w_gate", L + (d, f), Lr + ("fsdp", "tensor"), init="fan_in")
        table.add(f"{prefix}/w_in", L + (d, f), Lr + ("fsdp", "tensor"), init="fan_in")
        table.add(f"{prefix}/w_out", L + (f, d), Lr + ("tensor", "fsdp"), init="fan_in")
    elif cfg.mlp_style == "gelu":
        table.add(f"{prefix}/w_in", L + (d, f), Lr + ("fsdp", "tensor"), init="fan_in")
        table.add(f"{prefix}/b_in", L + (f,), Lr + ("tensor",), init="zeros")
        table.add(f"{prefix}/w_out", L + (f, d), Lr + ("tensor", "fsdp"), init="fan_in")
        table.add(f"{prefix}/b_out", L + (d,), Lr + ("null",), init="zeros")
    else:
        raise ValueError(cfg.mlp_style)
