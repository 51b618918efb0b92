"""Grouped-query attention with chunked online-softmax in plain PyTorch
(port of ``models/attention.py``).

This is the plain version: the CPU path of the port's attention, and the
function the hand-written CUDA kernel in
``repro_torch.kernels.flash_attention`` is held against on the card.  The
dense model reaches it only through ``kernels/flash_attention/ops.py``,
which launches the kernel on CUDA tensors.

Formulation: **repeat-KV**, as the reference: KV heads are repeated up to
the (padded) query head count, so q head ``h`` reads kv head
``h // (H // K)`` (with padded heads this is the reference's grouping,
C-ref4).  Dots take the input dtype's values with f32 accumulation
(``preferred_element_type=f32`` in the reference): here the operands are
upcast to f32, which holds every bf16 product exactly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import softcap as apply_softcap

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, D) -> (B, S, H, D) by repeating each kv head H//K times."""
    kh = k.shape[2]
    if kh == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kh, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(Sq, C) additive bias: 0 where attending is allowed, NEG_INF
    elsewhere.  ``k_pos`` -1 marks an empty slot."""
    valid = (k_pos >= 0)[None, :]
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, NEG_INF)


def _dot_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.float(), b.float())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, k_positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None,
              logit_cap: Optional[float] = None,
              chunk_size: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D) (H = padded head count), k/v (B, Sk, K, D);
    q_positions (Sq,), k_positions (Sk,) absolute positions, -1 for an
    empty slot.  GQA with online softmax over KV chunks.  Returns
    (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    scale = scale if scale is not None else d ** -0.5

    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    # scale in f32 for range, then back to the compute dtype (as the
    # reference: the dots see the input dtype's values)
    qf = (q.float() * scale).to(q.dtype)

    if sk <= chunk_size:
        return _attn_block(qf, k, v, q_positions, k_positions, causal,
                           window, logit_cap).to(q.dtype)

    # pad KV to a multiple of the chunk (padded slots get k_pos = -1)
    n_chunks = -(-sk // chunk_size)
    pad = n_chunks * chunk_size - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=-1)

    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        k_i, v_i, pos_i = k[:, sl], v[:, sl], k_positions[sl]
        s = _dot_f32("bqhd,bchd->bqhc", qf, k_i)
        s = apply_softcap(s, logit_cap)
        bias = _mask_bias(q_positions, pos_i, causal=causal, window=window)
        s = s + bias[:, None, :][None]  # (B,Sq,H,C)
        # clamp the running max so fully-masked chunks give exp(-huge) ~ 0,
        # not exp(0) = 1 (the classic online-softmax masking bug)
        m_new = torch.clamp(torch.maximum(m, s.amax(dim=-1)),
                            min=0.1 * NEG_INF)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _dot_f32(
            "bqhc,bchd->bqhd", p.to(v_i.dtype), v_i)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def _attn_block(qf, k, v, q_positions, k_positions, causal, window,
                logit_cap):
    """Single-block attention (Sk small): one stable softmax, f32 accum."""
    s = _dot_f32("bqhd,bchd->bqhc", qf, k)
    s = apply_softcap(s, logit_cap)
    bias = _mask_bias(q_positions, k_positions, causal=causal, window=window)
    s = s + bias[:, None, :][None]
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=0.1 * NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = (p / torch.clamp(l, min=1e-30)).to(v.dtype)
    return _dot_f32("bqhc,bchd->bqhd", p, v)
