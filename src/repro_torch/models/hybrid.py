"""Hybrid recurrent/attention LM (RecurrentGemma-9B / Griffin) on torch
tensors (port of ``models/hybrid.py``).

Block pattern: (recurrent, recurrent, local-attention) repeated.  38 layers
= 12 super-blocks of 3 + a tail of 2 recurrent blocks; the super-blocks'
parameters are stacked (``blocks/u{j}``), the tail's are not
(``tail/u{j}``).  Layers run in a Python loop, as in the dense port.  With
grad mode on each super-block runs under ``transformer._remat``
(``cfg.remat_policy``: ``"full"`` checkpoints it whole, so the backward
keeps one input a super-block and recomputes the rest), as the
reference's remat of its ``lax.scan`` body; the tail is not checkpointed,
as in the reference.  Serving (grad mode off) runs the plain loop.

Each block unit is a Griffin residual pair: x += temporal(norm(x));
x += geglu_mlp(norm(x)).  Temporal is either the RG-LRU recurrent block
(``models/rglru.py``, whose full-sequence scan launches the ``rglru_scan``
CUDA kernel on the card, and its backward kernel in training) or local
sliding-window MQA attention through ``kernels/flash_attention/ops.py``.

Decode state: per recurrent layer an RG-LRU hidden (B, W_lru) f32 + conv
state (B, 3, W_lru); per attention layer a ring KV cache bounded by the
attention window (2048).  ``decode_step`` updates them in place; the
local attention's cache is bounded by its window, so the grid-brick cache
(``brick_active``) never applies and the step takes no Sharder.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru
from repro_torch.models import transformer
from repro_torch.models.model_zoo import Model, abstract_cache
from repro_torch.models.params import ParamTable, torch_dtype
from repro_torch.models.transformer import (add_attn_layer_params,
                                            decode_attention, embed_tokens,
                                            layer_params, ring_slot,
                                            unembed)


def _pattern(cfg):
    """Returns (unit, n_super, tail): 38 -> (unit, 12, ('rec','rec'))."""
    unit = cfg.block_pattern or ("rec", "rec", "attn")
    n_super = cfg.num_layers // len(unit)
    n_tail = cfg.num_layers - n_super * len(unit)
    return unit, n_super, unit[:n_tail]


def param_table(cfg) -> ParamTable:
    t = ParamTable(cfg)
    d, vp = cfg.d_model, cfg.vocab_padded
    unit, n_super, tail = _pattern(cfg)

    t.add("embed/table", (vp, d), ("tensor", "fsdp"), init="normal")
    t.add("final_norm/scale", (d,), ("null",), init="zeros")

    for j, kind in enumerate(unit):
        prefix = f"blocks/u{j}"
        if kind == "rec":
            t.add(f"{prefix}/ln1/scale", (n_super, d), ("null", "null"), init="zeros")
            t.add(f"{prefix}/ln2/scale", (n_super, d), ("null", "null"), init="zeros")
            rglru.add_recurrent_params(t, cfg, f"{prefix}/rec", n_super)
            mlp_lib.add_mlp_params(t, cfg, f"{prefix}/mlp", n_super)
        else:
            add_attn_layer_params(t, cfg, prefix, n_super)
            mlp_lib.add_mlp_params(t, cfg, f"{prefix}/mlp", n_super)
    for j, kind in enumerate(tail):
        prefix = f"tail/u{j}"
        t.add(f"{prefix}/ln1/scale", (d,), ("null",), init="zeros")
        t.add(f"{prefix}/ln2/scale", (d,), ("null",), init="zeros")
        rglru.add_recurrent_params(t, cfg, f"{prefix}/rec", None)
        mlp_lib.add_mlp_params(t, cfg, f"{prefix}/mlp", None)
    return t


# --------------------------------------------------------------------------- #
def _rec_unit(cfg, p, x, *, h0=None, conv0=None, decode=False):
    h = L.norm(cfg, x, p["ln1"]["scale"])
    y, (h_last, conv_state) = rglru.recurrent_block(
        cfg, p["rec"], h, h0=h0, conv_state=conv0, decode=decode)
    x = x + y
    h = L.norm(cfg, x, p["ln2"]["scale"])
    x = x + mlp_lib.mlp(cfg, p["mlp"], h)
    return x, (h_last, conv_state)


def _attn_unit(cfg, p, x, positions):
    h = L.norm(cfg, x, p["ln1"]["scale"])
    x = x + transformer.self_attention(cfg, p["attn"], h, positions,
                                       window=cfg.attention_window)
    h = L.norm(cfg, x, p["ln2"]["scale"])
    return x + mlp_lib.mlp(cfg, p["mlp"], h)


def forward(cfg, params, tokens):
    """tokens: (B, S) -> (logits (B, S, Vp), aux loss 0)."""
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int64, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    unit, n_super, tail = _pattern(cfg)

    def super_block(p, x):
        for j, kind in enumerate(unit):
            if kind == "rec":
                x, _ = _rec_unit(cfg, p[f"u{j}"], x)
            else:
                x = _attn_unit(cfg, p[f"u{j}"], x, positions)
        return x

    body = (transformer._remat(cfg, super_block) if torch.is_grad_enabled()
            else super_block)
    for i in range(n_super):
        x = body(layer_params(params["blocks"], i), x)
    for j in range(len(tail)):
        x, _ = _rec_unit(cfg, params["tail"][f"u{j}"], x)
    x = L.norm(cfg, x, params["final_norm"]["scale"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params, x), aux


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    """Decode state under the reference's keys: ``lru_h`` (n_rec_in_unit,
    n_super, B, W_lru) f32, ``conv`` (n_rec_in_unit, n_super, B, T-1,
    W_lru), the ring ``k``/``v`` (n_super, B, W, K, hd) of ``W =
    min(seq_len, attention_window)`` slots, ``kpos`` (W,) int32 with -1
    marking an empty slot, ``tail{j}_h`` / ``tail{j}_conv``, and ``t`` as
    a host int, as the dense port keeps it."""
    unit, n_super, tail = _pattern(cfg)
    n_rec = sum(1 for k in unit if k == "rec")
    w_attn = min(seq_len, cfg.attention_window or seq_len)
    w_lru = cfg.lru_width or cfg.d_model
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    ct = cfg.conv1d_width - 1
    dt = torch_dtype(cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {
        "lru_h": zeros((n_rec, n_super, batch, w_lru), torch.float32),
        "conv": zeros((n_rec, n_super, batch, ct, w_lru)),
        "k": zeros((n_super, batch, w_attn, kh, hd)),
        "v": zeros((n_super, batch, w_attn, kh, hd)),
        "kpos": torch.full((w_attn,), -1, dtype=torch.int32, device=device),
        "t": 0,
    }
    for j in range(len(tail)):
        cache[f"tail{j}_h"] = zeros((batch, w_lru), torch.float32)
        cache[f"tail{j}_conv"] = zeros((batch, ct, w_lru))
    return cache


def _rec_decode(cfg, p, x, h_i, conv_i):
    """A recurrent unit's decode step; writes its new state into the
    cache views ``h_i`` (B, W) and ``conv_i`` (B, T-1, W) in place."""
    x, (h_last, cstate) = _rec_unit(cfg, p, x, h0=h_i, conv0=conv_i,
                                    decode=True)
    h_i.copy_(h_last)
    conv_i.copy_(cstate)
    return x


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B,1,Vp), cache).  The cache's tensors
    are updated in place and the returned dict holds them with ``t``
    advanced; attention runs over the ring's filled prefix, as the dense
    port's ``decode_step`` explains."""
    t, slot, n = ring_slot(cache, cfg.attention_window)
    positions = torch.full((1,), t, dtype=torch.int64, device=tokens.device)
    cache["kpos"][slot] = t
    unit, n_super, tail = _pattern(cfg)

    x = embed_tokens(cfg, params, tokens)
    for i in range(n_super):
        p = layer_params(params["blocks"], i)
        ri = 0
        for j, kind in enumerate(unit):
            pj = p[f"u{j}"]
            if kind == "rec":
                x = _rec_decode(cfg, pj, x, cache["lru_h"][ri, i],
                                cache["conv"][ri, i])
                ri += 1
            else:
                h = L.norm(cfg, x, pj["ln1"]["scale"])
                x = x + decode_attention(cfg, pj["attn"], h, positions,
                                         cache["k"][i], cache["v"][i],
                                         slot, n)
                h = L.norm(cfg, x, pj["ln2"]["scale"])
                x = x + mlp_lib.mlp(cfg, pj["mlp"], h)
    for j in range(len(tail)):
        x = _rec_decode(cfg, params["tail"][f"u{j}"], x,
                        cache[f"tail{j}_h"], cache[f"tail{j}_conv"])

    x = L.norm(cfg, x, params["final_norm"]["scale"])
    logits = unembed(cfg, params, x)
    return logits, {**cache, "t": t + 1}


def cache_roles(cfg) -> dict:
    """The reference's sharding roles of each cache tensor
    (``init_cache_abstract``)."""
    _, _, tail = _pattern(cfg)
    kv = ("null", "batch", "null", "tensor", "null")
    roles = {"lru_h": ("null", "null", "batch", "tensor"),
             "conv": ("null", "null", "batch", "null", "tensor"),
             "k": kv, "v": kv, "kpos": ("null",)}
    for j in range(len(tail)):
        roles[f"tail{j}_h"] = ("batch", "tensor")
        roles[f"tail{j}_conv"] = ("batch", "null", "tensor")
    return roles


# --------------------------------------------------------------------------- #
def build(cfg) -> Model:
    return Model(
        cfg=cfg,
        table=param_table(cfg),
        forward=lambda params, batch: forward(
            cfg, params, batch["tokens"]),
        decode_step=lambda params, cache, tokens, shd=None: decode_step(
            cfg, params, cache, tokens),
        init_cache=lambda b, s, device: init_cache(cfg, b, s, device),
        init_cache_abstract=lambda shd, b, s: abstract_cache(
            init_cache(cfg, b, s, "meta"), cache_roles(cfg), shd, s),
        extra_inputs=lambda shape, shd: {},
    )
