"""Decoder-only dense transformer LM on torch tensors (port of
``models/transformer.py``, without MoE and the VLM front end).

Layers run in a Python loop over the stacked layer parameters; the
reference's ``scan_layers``, remat and ``Sharder`` are TPU and mesh
devices with no port.  Every attention call goes through
``kernels/flash_attention/ops.py``: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain version.

Param paths (all stacked with leading L), as the reference:
  embed/table (Vp, d)            out/head (d, Vp)          final_norm/scale
  layers/ln1/scale               layers/ln2/scale
  layers/attn/{wq,wk,wv,wo}      layers/attn/{q_norm,k_norm}  (qk_norm)
  layers/mlp/...
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.model_zoo import LanguageModel
from repro_torch.models.params import NOT_PORTED, ParamTable, torch_dtype


# --------------------------------------------------------------------------- #
# Parameter table
# --------------------------------------------------------------------------- #
def param_table(cfg) -> ParamTable:
    if cfg.num_experts:
        raise NotImplementedError(f"MoE layers ({cfg.name}) {NOT_PORTED}")
    if cfg.num_patches:
        raise NotImplementedError(f"the VLM patch front end ({cfg.name}) "
                                  f"{NOT_PORTED}")
    t = ParamTable(cfg)
    d = cfg.d_model
    vp = cfg.vocab_padded
    nl = cfg.num_layers

    t.add("embed/table", (vp, d), ("tensor", "fsdp"), init="normal")
    if not cfg.tie_embeddings:
        t.add("out/head", (d, vp), ("fsdp", "tensor"), init="fan_in")
    ln_init = "ones" if cfg.norm_style == "layernorm" else "zeros"
    t.add("final_norm/scale", (d,), ("null",), init=ln_init)
    if cfg.norm_style == "layernorm":
        t.add("final_norm/bias", (d,), ("null",), init="zeros")

    add_attn_layer_params(t, cfg, "layers", nl)
    mlp_lib.add_mlp_params(t, cfg, "layers/mlp", nl)
    return t


def add_attn_layer_params(t: ParamTable, cfg, prefix: str, nl: Optional[int]):
    d, kh, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    hp = cfg.num_heads_padded  # zero-masked padding (C-ref4 grouping)
    Ls = () if nl is None else (nl,)
    Lr = () if nl is None else ("null",)
    nL = len(Ls)
    ln_init = "ones" if cfg.norm_style == "layernorm" else "zeros"
    t.add(f"{prefix}/ln1/scale", Ls + (d,), Lr + ("null",), init=ln_init)
    t.add(f"{prefix}/ln2/scale", Ls + (d,), Lr + ("null",), init=ln_init)
    if cfg.norm_style == "layernorm":
        t.add(f"{prefix}/ln1/bias", Ls + (d,), Lr + ("null",), init="zeros")
        t.add(f"{prefix}/ln2/bias", Ls + (d,), Lr + ("null",), init="zeros")
    if cfg.post_attn_norm:
        t.add(f"{prefix}/ln1_post/scale", Ls + (d,), Lr + ("null",), init="zeros")
        t.add(f"{prefix}/ln2_post/scale", Ls + (d,), Lr + ("null",), init="zeros")
    pad = (None if hp == cfg.num_heads else (nL + 1, cfg.num_heads))
    t.add(f"{prefix}/attn/wq", Ls + (d, hp, hd), Lr + ("fsdp", "tensor", "null"),
          init="fan_in", zero_pad=pad)
    t.add(f"{prefix}/attn/wk", Ls + (d, kh, hd), Lr + ("fsdp", "tensor", "null"),
          init="fan_in")
    t.add(f"{prefix}/attn/wv", Ls + (d, kh, hd), Lr + ("fsdp", "tensor", "null"),
          init="fan_in")
    pad_o = (None if hp == cfg.num_heads else (nL, cfg.num_heads))
    t.add(f"{prefix}/attn/wo", Ls + (hp, hd, d), Lr + ("tensor", "null", "fsdp"),
          init="fan_in", zero_pad=pad_o)
    if cfg.attn_bias:
        t.add(f"{prefix}/attn/bq", Ls + (hp, hd), Lr + ("tensor", "null"),
              init="zeros")
        t.add(f"{prefix}/attn/bk", Ls + (kh, hd), Lr + ("tensor", "null"),
              init="zeros")
        t.add(f"{prefix}/attn/bv", Ls + (kh, hd), Lr + ("tensor", "null"),
              init="zeros")
        t.add(f"{prefix}/attn/bo", Ls + (d,), Lr + ("null",), init="zeros")
    if cfg.qk_norm:
        t.add(f"{prefix}/attn/q_norm", Ls + (hd,), Lr + ("null",), init="zeros")
        t.add(f"{prefix}/attn/k_norm", Ls + (hd,), Lr + ("null",), init="zeros")


# --------------------------------------------------------------------------- #
# Attention sub-block
# --------------------------------------------------------------------------- #
def head_mask(cfg, dtype, device):
    """(Hp,) mask zeroing padded heads so padding is mathematically exact."""
    hp = cfg.num_heads_padded
    if hp == cfg.num_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.num_heads).to(dtype)


def attn_qkv(cfg, p, x, positions):
    """Project + rope. x:(B,S,d) -> q:(B,S,Hp,hd), k/v:(B,S,K,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.attn_bias and "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, theta=cfg.rope_theta, style=cfg.rope_style)
    k = L.apply_rope(k, positions, theta=cfg.rope_theta, style=cfg.rope_style)
    return q, k, v


def attn_out_proj(cfg, p, out):
    """Mask padded heads, project back to d_model."""
    hm = head_mask(cfg, out.dtype, out.device)
    if hm is not None:
        out = out * hm[None, None, :, None]
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if cfg.attn_bias and "bo" in p:
        y = y + p["bo"]
    return y


def self_attention(cfg, p, x, positions, *, window=None):
    """Causal self-attention sub-block over ``positions = arange(S)``
    (no residual).  Returns (B,S,d).  With q and k at the same positions
    the kernel's own position rule (queries at the last Sq of Sk) is the
    reference's ``q_positions = k_positions = positions``."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    out = flash_attention(q, k, v, causal=True, window=window,
                          scale=cfg.attn_scale_override,
                          logit_cap=cfg.attn_logit_softcap)
    return attn_out_proj(cfg, p, out)


# --------------------------------------------------------------------------- #
# Layer body + forward
# --------------------------------------------------------------------------- #
def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer parameters (views)."""
    return {key: layer_params(val, i) if isinstance(val, dict) else val[i]
            for key, val in layers.items()}


def _layer(cfg, p, x, positions):
    """One pre-norm transformer layer. Returns x."""
    h = L.norm(cfg, x, p["ln1"]["scale"], p["ln1"].get("bias"))
    a = self_attention(cfg, p["attn"], h, positions,
                       window=cfg.sliding_window)
    if cfg.post_attn_norm:
        a = L.norm(cfg, a, p["ln1_post"]["scale"])
    x = x + a
    h = L.norm(cfg, x, p["ln2"]["scale"], p["ln2"].get("bias"))
    m = mlp_lib.mlp(cfg, p["mlp"], h)
    if cfg.post_attn_norm:
        m = L.norm(cfg, m, p["ln2_post"]["scale"])
    return x + m


def embed_tokens(cfg, params, tokens):
    dt = torch_dtype(cfg.dtype)
    x = L.embed_lookup(params["embed"]["table"], tokens)
    return x.to(dt) * torch.tensor(cfg.embed_scale, dtype=dt,
                                   device=x.device)


def unembed(cfg, params, x):
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["out"]["head"])
    return torch.einsum("bsd,dv->bsv", x, table)


def forward(cfg, params, tokens):
    """tokens: (B, S) -> (logits (B, S, Vp), aux loss 0 for dense)."""
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int64, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.num_layers):
        x = _layer(cfg, layer_params(params["layers"], i), x, positions)
    x = L.norm(cfg, x, params["final_norm"]["scale"],
               params["final_norm"].get("bias"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params, x), aux


# --------------------------------------------------------------------------- #
# Decode (one token, ring KV cache)
# --------------------------------------------------------------------------- #
def cache_len(cfg, seq_len: int) -> int:
    w = cfg.sliding_window or cfg.attention_window
    return min(seq_len, w) if w else seq_len


def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    """The ring KV cache: k/v (L, B, W, K, hd) in cfg.dtype, kpos (W,)
    int32 with -1 marking an empty slot, and ``t``, the number of tokens
    decoded so far, as a host int (so finding the filled prefix costs no
    device sync)."""
    w = cache_len(cfg, seq_len)
    shape = (cfg.num_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((w,), -1, dtype=torch.int32, device=device),
            "t": 0}


def decode_attention(cfg, p, h, positions, k_i, v_i, slot, n):
    """The attention sub-block of one decode step (no residual): write the
    new k/v into ``slot`` of the layer's ring cache ``k_i``/``v_i``
    (B, W, K, hd) in place, attend over the filled prefix ``[0, n)``.
    h:(B,1,d) -> (B,1,d)."""
    q, k_new, v_new = attn_qkv(cfg, p, h, positions)
    k_i[:, slot] = k_new[:, 0].to(k_i.dtype)
    v_i[:, slot] = v_new[:, 0].to(v_i.dtype)
    # every slot of [0, n) holds one of the last n positions <= t, all
    # inside the window (see decode_step): a causal call with the query at
    # the last position attends to all of them
    out = flash_attention(q, k_i[:, :n], v_i[:, :n], causal=True,
                          window=None, scale=cfg.attn_scale_override,
                          logit_cap=cfg.attn_logit_softcap)
    return attn_out_proj(cfg, p, out)


def ring_slot(cache: dict, window) -> tuple:
    """``(t, slot, n)`` of a decode step on a ring cache: ``t`` the host
    int position, ``slot = t % W`` where the new k/v go, and ``n = min(t
    + 1, W)`` the filled prefix (see ``decode_step``).  Raises for a bad
    ``t`` or a cache longer than the window."""
    t = cache["t"]
    w = cache["k"].shape[2]
    if not isinstance(t, int) or t < 0:
        raise ValueError(f"cache['t'] must be a host int >= 0, got {t!r}")
    if window is not None and w > window:
        raise ValueError(f"a cache of {w} slots is longer than the window "
                         f"{window}: its filled slots are not all visible")
    return t, t % w, min(t + 1, w)


def _decode_layer(cfg, p, x, positions, k_i, v_i, slot, n):
    """Decode step for one layer: write the new k/v into ``slot`` of the
    layer's cache (in place), attend over the filled prefix ``[0, n)``.
    x:(B,1,d)."""
    h = L.norm(cfg, x, p["ln1"]["scale"], p["ln1"].get("bias"))
    a = decode_attention(cfg, p["attn"], h, positions, k_i, v_i, slot, n)
    if cfg.post_attn_norm:
        a = L.norm(cfg, a, p["ln1_post"]["scale"])
    x = x + a
    h = L.norm(cfg, x, p["ln2"]["scale"], p["ln2"].get("bias"))
    m = mlp_lib.mlp(cfg, p["mlp"], h)
    if cfg.post_attn_norm:
        m = L.norm(cfg, m, p["ln2_post"]["scale"])
    return x + m


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B,1,Vp), cache).

    The cache's tensors are updated in place (the reference returns new
    arrays; one card has no use for the copy) and the returned dict holds
    them with ``t`` advanced.  The reference attends over all W slots with
    ``kpos`` masking the empty ones; the port attends over the filled
    prefix ``[0, n)``, ``n = min(t + 1, W)``, which holds exactly the slots
    the reference finds valid: before the ring wraps ``kpos[j] = j <= t``;
    after it wraps all W slots hold the last W positions; and a windowed
    cache has ``W <= window``, so no filled slot lies outside the window."""
    t, slot, n = ring_slot(cache, cfg.sliding_window or
                           cfg.attention_window)
    positions = torch.full((1,), t, dtype=torch.int64, device=tokens.device)
    cache["kpos"][slot] = t

    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.num_layers):
        x = _decode_layer(cfg, layer_params(params["layers"], i), x,
                          positions, cache["k"][i], cache["v"][i], slot, n)
    x = L.norm(cfg, x, params["final_norm"]["scale"],
               params["final_norm"].get("bias"))
    logits = unembed(cfg, params, x)
    return logits, {**cache, "t": t + 1}


# --------------------------------------------------------------------------- #
class TransformerLM(LanguageModel):
    """The dense LM as an ``nn.Module``: ``LanguageModel`` on the dense
    facade of ``cfg``."""

    def __init__(self, cfg, params: dict):
        from repro_torch.models.model_zoo import build_model
        super().__init__(build_model(cfg), params)
