"""Grid-brick KV-cache attention (port of ``core/brick_attention.py``).

The paper's core move — split the data into node-resident bricks, run the
job where the data lives, merge the small per-node results at the JSE —
applied to the decode-time KV cache:

- the cache's sequence dim W is cut into ``tensor_size`` bricks along the
  mesh's ``model`` axis (each brick of the context stays where it is),
- every brick computes online-softmax statistics (m, l, acc) over its own
  slots only — the job ships to the brick, not the brick to the job,
- the per-brick partials are merged with an exact log-sum-exp combine
  (the max, then two sums of small tensors) — the result merge at the JSE.

On one card the bricks are views of the one ring cache tensor, so the
brick layout is the cache's own storage: the new token is written once,
into the brick that owns its slot, and the other bricks are not touched.
The bricks run one after the other and are merged in brick order.  The
reference computes this with XLA einsums under ``shard_map`` and no
Pallas kernel; the port's products are ``torch.einsum`` on f32 views of
the storage dtype (every bf16 product is exact in f32, as the
reference's ``preferred_element_type=f32``).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF
from repro_torch.models.layers import softcap as apply_softcap


def brick_active(cfg, shd, cache_w: int) -> bool:
    """Use the brick-sharded cache when the context is large, unwindowed,
    and the mesh has a model axis the cache length divides."""
    if not cfg.decode_cache_seq_shard or shd.tensor_size <= 1:
        return False
    if cfg.sliding_window or cfg.attention_window:
        return False  # window-bounded caches are already small
    return cache_w > 4096 and cache_w % shd.tensor_size == 0


def decode_attention(cfg, shd, q, k_cache, v_cache, kpos, new_k, new_v,
                     slot: int, t: int):
    """One decode step's attention over the brick cache.

    q (B, 1, Hp, hd); k_cache, v_cache (B, W, K, hd), W cut into
    ``shd.tensor_size`` bricks; kpos (W,) int32 on the cache's device,
    the absolute position of each slot (-1: empty), already holding ``t``
    at ``slot``; new_k, new_v (B, 1, K, hd); ``slot`` and ``t`` host ints.
    Writes the new k/v into the owning brick in place and returns the
    attention output (B, 1, Hp, hd) in q's dtype."""
    b, w, kh, hd = k_cache.shape
    n_bricks = shd.tensor_size
    if w % n_bricks:
        raise ValueError(f"a cache of {w} slots does not cut into "
                         f"{n_bricks} bricks")
    w_loc = w // n_bricks
    h = q.shape[2]
    g = h // kh
    scale = (cfg.attn_scale_override
             if cfg.attn_scale_override is not None else cfg.head_dim ** -0.5)
    # GQA in the grouped (B,1,K,G,hd) formulation: no repeat-KV, each
    # brick's cache read once in its storage dtype
    qg = (q.float() * scale).to(q.dtype).reshape(b, 1, kh, g, hd).float()

    ms, ls, accs = [], [], []
    for i in range(n_bricks):
        lo = i * w_loc
        k = k_cache[:, lo:lo + w_loc]
        v = v_cache[:, lo:lo + w_loc]
        if lo <= slot < lo + w_loc:      # the brick that owns the slot
            k[:, slot - lo] = new_k[:, 0].to(k.dtype)
            v[:, slot - lo] = new_v[:, 0].to(v.dtype)
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float())
        s = apply_softcap(s, cfg.attn_logit_softcap)
        kp = kpos[lo:lo + w_loc]
        valid = (kp >= 0) & (kp <= t)
        s = torch.where(valid, s, NEG_INF)
        m = torch.clamp(s.amax(dim=-1), min=0.1 * NEG_INF)   # (B,1,K,G)
        p = torch.exp(s - m[..., None])
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).float(),
                                 v.float()))
        ms.append(m)

    # the JSE merge: exact log-sum-exp combine across bricks, in order
    m_g = ms[0]
    for m in ms[1:]:
        m_g = torch.maximum(m_g, m)
    l_g, acc_g = None, None
    for m, l, acc in zip(ms, ls, accs):
        corr = torch.exp(m - m_g)
        l_i, acc_i = l * corr, acc * corr[..., None]
        l_g = l_i if l_g is None else l_g + l_i
        acc_g = acc_i if acc_g is None else acc_g + acc_i
    out = acc_g / torch.clamp(l_g[..., None], min=1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)
