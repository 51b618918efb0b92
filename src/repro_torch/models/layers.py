"""Shared neural-net layers on torch tensors (port of ``models/layers.py``).

Numerics: parameters/activations in cfg.dtype (bf16 target), all norm and
softmax statistics accumulated in f32.
"""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def norm(cfg, x: torch.Tensor, scale: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.norm_style == "layernorm":
        return layernorm(x, scale, bias, cfg.norm_eps)
    return rmsnorm(x, scale, cfg.norm_eps)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(V, d) table, integer tokens -> (..., d)."""
    return table[tokens]


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     rotary_dim: Optional[int] = None, *, device=None):
    rd = rotary_dim or head_dim
    exponent = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)  # (rd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               style: str = "neox") -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,) integer.

    style:
      neox  – rotate-half over the full head dim (llama/qwen/starcoder2)
      half  – rotary applied to the first half of the head dim only,
              interleaved pairs (chatglm "2d"/partial rotary)
      none  – identity
    """
    if style == "none":
        return x
    d = x.shape[-1]
    if positions.dim() == 1:
        positions = positions[None, :]
    pos = positions.float()[:, :, None, None]  # (B,S,1,1)

    if style == "neox":
        angles = pos * rope_frequencies(d, theta, device=x.device)
        sin, cos = torch.sin(angles), torch.cos(angles)
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    if style == "half":
        rd = d // 2
        angles = pos * rope_frequencies(d, theta, rotary_dim=rd,
                                        device=x.device)
        sin, cos = torch.sin(angles), torch.cos(angles)
        xr = x[..., :rd].float()
        xp = x[..., rd:]
        x_even = xr[..., 0::2]
        x_odd = xr[..., 1::2]
        rot_even = x_even * cos - x_odd * sin
        rot_odd = x_odd * cos + x_even * sin
        xr_out = torch.stack([rot_even, rot_odd], dim=-1).reshape(xr.shape)
        return torch.cat([xr_out.to(x.dtype), xp], dim=-1)

    raise ValueError(f"unknown rope style {style!r}")


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
