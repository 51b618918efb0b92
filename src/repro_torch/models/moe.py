"""Mixture-of-Experts block on torch tensors: grouped top-k routing with
capacity dropping (port of ``models/moe.py``).

The reference's MaxText/Switch "grouped one-hot dispatch", as it is:
tokens are split into routing groups of ``cfg.moe_group_size``, so the
dispatch tensor is (G, Sg, E, C) with C = Sg * topk / E * capacity_factor.
The router runs in f32: softmax, top-k, gates normalised over the k
chosen, the Switch load-balancing loss, and each token's place in its
expert's queue by a cumulative count (earlier tokens first; a place at or
past C is dropped).  The expert products are plain matrix products, as
the reference leaves them to XLA outside any Pallas kernel, so here they
are ``torch.einsum``.  Every expert's weights are read for every group,
whether a token was routed there or not: the dense one-hot dispatch.

The reference's sharding strategies (``cfg.moe_sharding``: "tp" / "ep")
place experts on a mesh; one card has none, so nothing reads them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def moe_capacity(cfg, group_size: int) -> int:
    c = int(
        math.ceil(group_size * cfg.num_experts_per_tok / cfg.num_experts
                  * cfg.moe_capacity_factor)
    )
    return max(8, ((c + 7) // 8) * 8)  # round to 8 for lane alignment


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over the last axis; an index outside ``[0, n)`` gives
    a row of zeros, as ``jax.nn.one_hot`` does (``F.one_hot`` raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, largest first, ties to the lower
    index first, as ``jax.lax.top_k``.  ``torch.topk`` does not document
    its order among equal values; a stable descending sort keeps equal
    values in index order, which is the reference's rule.  Returns
    (values, int64 indices)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def route(cfg, router: torch.Tensor, xg: torch.Tensor):
    """The router in f32 on xg (G, Sg, d): (probs (G,Sg,E), normalised
    gates (G,Sg,k), expert indices (G,Sg,k) int64)."""
    logits = torch.einsum("gsd,de->gse", xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.num_experts_per_tok)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def assign_capacity(onehot: torch.Tensor, cap: int):
    """Each (token, choice)'s place in its expert's queue, earlier tokens
    first: onehot (G,Sg,k,E) -> (within_cap (G,Sg,k,E) bool, cap_idx
    (G,Sg,k) int64, the place; a place >= cap is dropped)."""
    g, sg, k, e = onehot.shape
    pos = torch.cumsum(onehot.reshape(g, sg * k, e), dim=1) - 1.0
    pos = pos.reshape(g, sg, k, e)
    within_cap = (pos < cap) & (onehot > 0)
    cap_idx = (pos * onehot).sum(dim=-1).long()
    return within_cap, cap_idx


def moe_block(cfg, p: dict, x: torch.Tensor):
    """x: (B, S, d) -> ((B, S, d), aux_loss scalar f32)."""
    b, s, d = x.shape
    e = cfg.num_experts
    sg = min(cfg.moe_group_size, s)
    if s % sg:
        raise ValueError(f"{s} tokens do not split into routing groups of "
                         f"{sg}")
    g = b * (s // sg)
    cap = moe_capacity(cfg, sg)
    xg = x.reshape(g, sg, d)

    # --- router (f32) ---
    probs, gate_vals, expert_idx = route(cfg, p["router"], xg)

    # --- load-balancing auxiliary loss (Switch) ---
    onehot = _one_hot(expert_idx, e)  # (G,Sg,k,E)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = onehot.sum(dim=2).mean(dim=(0, 1))  # share routed to each expert
    aux_loss = e * torch.sum(me * ce)

    # --- capacity assignment and the dispatch/combine tensors ---
    within_cap, cap_idx = assign_capacity(onehot, cap)
    cap_onehot = _one_hot(cap_idx, cap)  # (G,Sg,k,C)
    mask = torch.where(within_cap, onehot, 0.0)  # (G,Sg,k,E)
    dispatch = torch.einsum("gske,gskc->gsec", mask, cap_onehot)
    combine = torch.einsum("gske,gskc,gsk->gsec", mask, cap_onehot,
                           gate_vals.float())
    dispatch = dispatch.to(x.dtype)

    # --- expert computation ---
    xe = torch.einsum("gsd,gsec->egcd", xg, dispatch)  # (E,G,C,d)
    gate = torch.einsum("egcd,edf->egcf", xe, p["w_gate"])
    up = torch.einsum("egcd,edf->egcf", xe, p["w_in"])
    h = F.silu(gate) * up
    ye = torch.einsum("egcf,efd->egcd", h, p["w_out"])  # (E,G,C,d)

    # --- combine back to token order, in the compute dtype ---
    out = torch.einsum("egcd,gsec->gsd", ye,
                       combine.to(ye.dtype)).to(x.dtype)
    return out.reshape(b, s, d), aux_loss


def add_moe_params(table, cfg, prefix: str, layers: int | None = None):
    L = () if layers is None else (layers,)
    Lr = () if layers is None else ("null",)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    table.add(f"{prefix}/router", L + (d, e), Lr + ("fsdp", "null"),
              init="fan_in", dtype="float32")
    table.add(f"{prefix}/w_gate", L + (e, d, f), Lr + ("expert", "moe_d", "moe_ff"),
              init="fan_in")
    table.add(f"{prefix}/w_in", L + (e, d, f), Lr + ("expert", "moe_d", "moe_ff"),
              init="fan_in")
    table.add(f"{prefix}/w_out", L + (e, f, d), Lr + ("expert", "moe_ff", "moe_d"),
              init="fan_in")
