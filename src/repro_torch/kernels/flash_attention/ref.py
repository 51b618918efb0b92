"""Plain PyTorch version of the flash-attention kernel: the repeat-KV GQA
attention of ``models/attention.py`` with the kernel's signature (port of
``kernels/flash_attention/ref.py``).  A wrapper runs it for CPU tensors,
and the CUDA kernels are held against it on the card.

``flash_attention_lse_ref`` is each row's lse as the forward kernels write
it for the backward (``flash_attention_ref(with_lse=True)`` returns it
beside the output).  ``flash_attention_bwd_ref`` is the backward kernels'
plain version: the gradient by its explicit formulas with P recomputed
from lse (the forward's, or its own), for the tests and ``chip_smoke.py``
(on the CPU autograd differentiates ``flash_attention_ref`` itself);
``flash_attention_bwd_split_ref`` is the same with dk and dv summed as
the tensor-core backward sums them, over runs of each kv head's query
heads in run order.  ``flash_attention_split_ref`` is a plain model of the
decode kernel's split over the keys.  No path calls the last two: they
are for the tests."""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, attention, repeat_kv
from repro_torch.models.layers import softcap as apply_softcap


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        logit_cap=None, with_lse=False):
    """q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D); the queries are the
    last Sq of the Sk positions when causal.  ``with_lse`` returns (out,
    lse) as the kernel does (``flash_attention_lse_ref``)."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, dtype=torch.int64, device=q.device) + \
        (sk - sq if causal else 0)
    k_pos = torch.arange(sk, dtype=torch.int64, device=q.device)
    out = attention(q, k, v, q_positions=q_pos, k_positions=k_pos,
                    causal=causal, window=window, scale=scale,
                    logit_cap=logit_cap)
    if not with_lse:
        return out
    return out, flash_attention_lse_ref(q, k, causal=causal, window=window,
                                        scale=scale, logit_cap=logit_cap)


def _scores(qf, kf, i0, sq, sk, *, causal, window, scale, logit_cap):
    """Scores of query rows [i0, i0 + r) against every key as the kernels
    form them, (B, H, r, Sk): raw = scale (q . k) (q * scale not rounded),
    s = cap tanh(raw / cap) (raw without a cap), t = tanh(raw / cap) or
    None, and the (r, Sk) valid mask."""
    raw = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    t = torch.tanh(raw / logit_cap) if logit_cap is not None else None
    s = raw if t is None else logit_cap * t
    q_pos = torch.arange(i0, i0 + qf.shape[1],
                         device=qf.device)[:, None] + (sk - sq if causal
                                                       else 0)
    k_pos = torch.arange(sk, device=qf.device)[None, :]
    valid = torch.ones_like(s[0, 0], dtype=torch.bool)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    return s, t, valid


def _lse(s, valid):
    """(B, H, r, 1) lse of masked scores: m = max(max_valid s, 0.1 *
    NEG_INF), lse = m + log(sum_valid exp(s - m)), +inf with no valid
    key."""
    masked = torch.where(valid, s, NEG_INF)
    m = torch.clamp(masked.amax(-1, keepdim=True), min=0.1 * NEG_INF)
    l = torch.exp(masked - m).sum(-1, keepdim=True)
    return torch.where(l > 0, m + torch.log(l), float("inf"))


def flash_attention_lse_ref(q, k, *, causal=True, window=None, scale=None,
                            logit_cap=None, rows=None):
    """(B, H, Sq) lse of each query row over its valid keys, in the units
    the backward reads: natural log of the scaled (capped) scores, +inf
    for a row with no valid key.  f32 (f64 for f64 operands); ``rows``
    query rows at a time (all by default)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = scale if scale is not None else d ** -0.5
    kf = repeat_kv(k, h).to(ct)
    step = rows or sq
    out = torch.empty((b, h, sq), dtype=ct, device=q.device)
    for i0 in range(0, sq, step):
        s, _, valid = _scores(q[:, i0:i0 + step].to(ct), kf, i0, sq, sk,
                              causal=causal, window=window, scale=scale,
                              logit_cap=logit_cap)
        out[:, :, i0:i0 + step] = _lse(s, valid)[..., 0]
    return out


def _bwd_heads(q, k, v, out, dout, lse, *, causal, window, scale,
               logit_cap, rows):
    """dq (B,Sq,H,D) and dk, dv per query head (B,Sk,H,D), in f32 (f64
    for f64 operands), by the backward's formulas."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = scale if scale is not None else d ** -0.5
    kf = repeat_kv(k, h).to(ct)
    vf = repeat_kv(v, h).to(ct)
    dq = torch.empty((b, sq, h, d), dtype=ct, device=q.device)
    dk = torch.zeros((b, sk, h, d), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    step = rows or sq
    for i0 in range(0, sq, step):
        qf = q[:, i0:i0 + step].to(ct)
        do = dout[:, i0:i0 + step].to(ct)
        delta = (do * out[:, i0:i0 + step].to(ct)).sum(-1)     # (B, r, H)
        s, t, valid = _scores(qf, kf, i0, sq, sk, causal=causal,
                              window=window, scale=scale,
                              logit_cap=logit_cap)
        if lse is None:
            row_lse = _lse(s, valid)
        else:
            row_lse = lse[:, :, i0:i0 + step, None].to(ct)
        p = torch.where(valid, torch.exp(s - row_lse), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
        ds = p * (dp - delta.permute(0, 2, 1)[..., None])
        if t is not None:
            ds = ds * (1 - t * t)
        ds = ds * scale
        dq[:, i0:i0 + step] = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq, dk, dv


def flash_attention_bwd_ref(q, k, v, out, dout, lse=None, *, causal=True,
                            window=None, scale=None, logit_cap=None,
                            rows=None):
    """dq (B,Sq,H,D), dk and dv (B,Sk,K,D) of ``flash_attention`` by the
    backward kernels' formulas (``csrc/flash_attention_bwd.cu``), in the
    operands' dtypes: the function the kernels compute (q * scale not
    rounded, the 0.1 * NEG_INF guard, a row with no valid key 0), with P
    recomputed as exp(s - lse), lse the forward's (B, H, Sq) when given
    and else computed here as the forward computes it, delta = sum(dout *
    out), dS = P (dP - delta) through the cap's 1 - tanh^2 and the scale,
    and dk, dv summed over each kv head's query heads.  Computed in f32,
    or in f64 for f64 operands; ``rows`` query rows at a time (all by
    default) bounds the (B, H, rows, Sk) temporaries."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dq, dk, dv = _bwd_heads(q, k, v, out, dout, lse, causal=causal,
                            window=window, scale=scale, logit_cap=logit_cap,
                            rows=rows)
    # the transpose of repeat_kv: each kv head sums its query heads
    dk = dk.view(b, sk, kh, h // kh, d).sum(3)
    dv = dv.view(b, sk, kh, h // kh, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_split_ref(q, k, v, out, dout, lse=None, *, splits,
                                  causal=True, window=None, scale=None,
                                  logit_cap=None, rows=None):
    """``flash_attention_bwd_ref`` with dk and dv summed as the tensor-core
    backward sums them: each kv head's G query heads cut into ``splits``
    runs of consecutive heads, each run's sum a partial, and the partials
    added in run order (``fa_bwd_sum_kernel``).  ``splits`` divides G."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    if g % splits:
        raise ValueError(f"{splits} runs do not divide {g} query heads")
    dq, dk, dv = _bwd_heads(q, k, v, out, dout, lse, causal=causal,
                            window=window, scale=scale, logit_cap=logit_cap,
                            rows=rows)

    def runs(x):
        parts = x.view(b, sk, kh, splits, g // splits, d).sum(4)
        acc = parts[:, :, :, 0]
        for i in range(1, splits):
            acc = acc + parts[:, :, :, i]
        return acc

    return dq.to(q.dtype), runs(dk).to(k.dtype), runs(dv).to(v.dtype)


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
