"""RG-LRU recurrent block (Griffin / RecurrentGemma) on torch tensors (port
of ``models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(gate_a(x_t))          # recurrence gate
    i_t = sigmoid(gate_x(x_t))          # input gate
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Gates are block-diagonal linear maps (one block per head).  The
full-sequence recurrence goes through ``kernels/rglru_scan/ops.py``: a
CUDA tensor launches the hand-written kernel (in training, through
``RglruScanFn``, whose backward is the hand-written backward kernel), a
CPU tensor takes the plain doubling scan.  Decode is the O(1) step.
The reference's ``shd.ws`` / ``shd.act_btd`` constraints are no-ops on
the port's meshes (one card, or a mesh emulated on it,
``parallel/sharding.py``), so the block takes no Sharder.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan as linear_scan

RGLRU_C = 8.0  # the paper's fixed constant


def block_diag_linear(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,W); w: (H, W/H, W/H); b: (H, W/H) -> (B,S,W)."""
    bsz, s, width = x.shape
    h = w.shape[0]
    xh = x.reshape(bsz, s, h, width // h)
    y = torch.einsum("bshc,hce->bshe", xh, w) + b
    return y.reshape(bsz, s, width)


def rglru_gates(p: dict, x: torch.Tensor):
    """Returns (a, gated_x) for the scan, both (B,S,W) f32."""
    xf = x.float()
    r = torch.sigmoid(block_diag_linear(xf, p["a_gate_w"].float(),
                                        p["a_gate_b"].float()))
    i = torch.sigmoid(block_diag_linear(xf, p["x_gate_w"].float(),
                                        p["x_gate_b"].float()))
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                        min=1e-12))
    return a, multiplier * (i * xf)


def rglru_scan(p: dict, x: torch.Tensor, h0=None):
    """Full-sequence RG-LRU.  x: (B,S,W) -> (y (B,S,W) in x's dtype,
    h_last (B,W) f32)."""
    a, bx = rglru_gates(p, x)  # (B,S,W) f32 each
    h, h_last = linear_scan(a, bx, None if h0 is None else h0.float())
    return h.to(x.dtype), h_last


def rglru_step(p: dict, x: torch.Tensor, h_prev: torch.Tensor):
    """One decode step. x: (B,1,W), h_prev: (B,W) f32 -> (y (B,1,W), h)."""
    a, bx = rglru_gates(p, x)
    h = a[:, 0] * h_prev.float() + bx[:, 0]
    return h[:, None, :].to(x.dtype), h


# --------------------------------------------------------------------------- #
# Full recurrent block: linear -> (conv1d -> RG-LRU) * gelu branch -> linear
# --------------------------------------------------------------------------- #
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state=None):
    """Depthwise causal conv. x:(B,S,W), w:(T,W), b:(W,).
    state: (B,T-1,W) previous inputs for decode. Returns (y, new_state).
    The taps are summed in the reference's order, ``i = 0 .. T-1`` in x's
    dtype, then ``+ b``."""
    t = w.shape[0]
    s = x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], t - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+T-1, W)
    y = xp[:, 0:s] * w[0]
    for i in range(1, t):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    new_state = xp[:, -(t - 1):] if t > 1 else torch.zeros_like(pad)
    return y, new_state


def recurrent_block(cfg, p: dict, x: torch.Tensor, *, h0=None,
                    conv_state=None, decode=False):
    """Griffin recurrent temporal block. x: (B,S,d).
    Returns (y (B,S,d), (h_last, conv_state))."""
    gate = torch.einsum("bsd,dw->bsw", x, p["w_gate"])
    branch = torch.einsum("bsd,dw->bsw", x, p["w_branch"])
    branch, conv_state = causal_conv1d(branch, p["conv_w"], p["conv_b"],
                                       conv_state)
    if decode:
        rec, h_last = rglru_step(p, branch, h0)
    else:
        rec, h_last = rglru_scan(p, branch, h0)
    y = F.gelu(gate, approximate="tanh") * rec
    out = torch.einsum("bsw,wd->bsd", y, p["w_out"])
    return out, (h_last, conv_state)


def add_recurrent_params(t, cfg, prefix: str, layers=None):
    d = cfg.d_model
    w = cfg.lru_width or d
    h = cfg.num_heads
    Ls = () if layers is None else (layers,)
    Lr = () if layers is None else ("null",)
    t.add(f"{prefix}/w_gate", Ls + (d, w), Lr + ("fsdp", "tensor"), init="fan_in")
    t.add(f"{prefix}/w_branch", Ls + (d, w), Lr + ("fsdp", "tensor"), init="fan_in")
    t.add(f"{prefix}/conv_w", Ls + (cfg.conv1d_width, w),
          Lr + ("null", "tensor"), init="fan_in")
    t.add(f"{prefix}/conv_b", Ls + (w,), Lr + ("tensor",), init="zeros")
    t.add(f"{prefix}/a_gate_w", Ls + (h, w // h, w // h),
          Lr + ("tensor", "null", "null"), init="fan_in")
    t.add(f"{prefix}/a_gate_b", Ls + (h, w // h), Lr + ("tensor", "null"),
          init="zeros")
    t.add(f"{prefix}/x_gate_w", Ls + (h, w // h, w // h),
          Lr + ("tensor", "null", "null"), init="fan_in")
    t.add(f"{prefix}/x_gate_b", Ls + (h, w // h), Lr + ("tensor", "null"),
          init="zeros")
    t.add(f"{prefix}/lam", Ls + (w,), Lr + ("tensor",), init="lru_a")
    t.add(f"{prefix}/w_out", Ls + (w, d), Lr + ("tensor", "fsdp"), init="fan_in")
