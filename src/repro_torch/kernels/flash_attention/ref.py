"""Plain PyTorch version of the flash-attention kernel: the repeat-KV GQA
attention of ``models/attention.py`` with the kernel's signature (port of
``kernels/flash_attention/ref.py``).  A wrapper runs it for CPU tensors,
and the CUDA kernels are held against it on the card.

``flash_attention_split_ref`` is a plain model of the decode kernel's
split over the keys, for the tests only: no path calls it."""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, attention, repeat_kv
from repro_torch.models.layers import softcap as apply_softcap


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        logit_cap=None):
    """q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D); the queries are the
    last Sq of the Sk positions when causal."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, dtype=torch.int64, device=q.device) + \
        (sk - sq if causal else 0)
    k_pos = torch.arange(sk, dtype=torch.int64, device=q.device)
    return attention(q, k, v, q_positions=q_pos, k_positions=k_pos,
                     causal=causal, window=window, scale=scale,
                     logit_cap=logit_cap)


def flash_attention_split_ref(q, k, v, *, splits, causal=True, window=None,
                              scale=None, logit_cap=None):
    """The decode kernel's arithmetic over key ``splits`` (``[lo, hi)``
    ranges that tile the keys some query may see): each split's (m, l,
    acc) from f32 scores with the 0.1 * NEG_INF guard, P.V with P in two
    terms of v's dtype (its rounding and the rounding of the rest, as the
    kernel feeds the tensor cores), then the log-sum-exp merge of the
    splits in split order.  q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D) in
    q's dtype."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kf, vr = repeat_kv(k, h), repeat_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), kf.float()) * scale
    s = apply_softcap(s, logit_cap)
    q_pos = torch.arange(sq)[:, None] + (sk - sq if causal else 0)
    k_pos = torch.arange(sk)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    parts = []
    for lo, hi in splits:
        ok = (valid & (k_pos >= lo) & (k_pos < hi)).to(s.device)
        x = torch.where(ok[None, :, None, :], s, NEG_INF)[..., lo:hi]
        m = torch.clamp(x.amax(dim=-1), min=0.1 * NEG_INF)
        p = torch.exp(x - m[..., None])
        big = p.to(v.dtype).float()
        small = (p - big).to(v.dtype).float()
        vs = vr[:, lo:hi].float()
        acc = torch.einsum("bqhk,bkhd->bqhd", big, vs) + \
            torch.einsum("bqhk,bkhd->bqhd", small, vs)
        parts.append((m, p.sum(dim=-1), acc))
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    l_sum = torch.zeros_like(top)
    acc_sum = torch.zeros((b, sq, h, d), dtype=torch.float32,
                          device=q.device)
    for m, l_part, acc in parts:
        f = torch.exp(m - top)
        l_sum = l_sum + f * l_part
        acc_sum = acc_sum + f[..., None] * acc
    return (acc_sum / torch.clamp(l_sum, min=1e-30)[..., None]).to(q.dtype)
