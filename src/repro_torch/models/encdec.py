"""Encoder-decoder backbone (whisper-medium) on torch tensors (port of
``models/encdec.py``).

The audio conv frontend is a STUB, as in the reference: the caller
supplies precomputed frame embeddings (B, S_enc, d_model).  Everything
behind the frontend is real: sinusoidal encoder positions, learned decoder
positions, pre-LN layernorm blocks with q/v/o biases, GELU MLPs, cross
attention, tied decoder embedding/unembedding, ring-buffer decode cache.
Layers run in a Python loop, as in the decoder port.

Every attention call goes through ``kernels/flash_attention/ops.py`` (by
way of ``transformer.flash_attention``, the one name the decoder models
call it by): a CUDA tensor launches the hand-written kernel, a CPU tensor
takes the plain version.  The encoder's self-attention is non-causal; the
decoder's is causal, over the ring's filled prefix at decode as in
``transformer.decode_step``; cross-attention is non-causal over the
``encoder_seq_len`` encoder positions.

Given a Sharder for which ``brick_active`` holds (an emulated mesh whose
``model`` axis cuts an unwindowed cache of more than 4096 slots into
bricks), the decoder's self-attention decodes through the grid-brick
cache (``core/brick_attention.py``), as the reference's does on that
mesh; ``use_brick=True`` asks for that path whatever the cache length.

Param layout:
  enc/layers/*          (L_enc-stacked: ln1, attn, ln2, mlp)
  enc/final_norm/*
  dec/embed/table       (Vp, d)  (tied unembed)
  dec/pos/table         (max_positions, d)
  dec/layers/*          (L_dec-stacked: ln1, attn, lnx, xattn, ln2, mlp)
  dec/final_norm/*
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import model_zoo
from repro_torch.models import transformer
from repro_torch.models.params import ParamTable, torch_dtype
from repro_torch.models.transformer import (attn_out_proj, cache_len,
                                            layer_params, ring_slot)


def _add_attn(t: ParamTable, cfg, prefix: str, nl: int, *, cross=False):
    d, kh, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    hp = cfg.num_heads_padded
    Ls, Lr = (nl,), ("null",)
    pad_q = None if hp == cfg.num_heads else (2, cfg.num_heads)
    pad_o = None if hp == cfg.num_heads else (1, cfg.num_heads)
    t.add(f"{prefix}/wq", Ls + (d, hp, hd), Lr + ("fsdp", "tensor", "null"),
          init="fan_in", zero_pad=pad_q)
    t.add(f"{prefix}/wk", Ls + (d, kh, hd), Lr + ("fsdp", "tensor", "null"),
          init="fan_in")
    t.add(f"{prefix}/wv", Ls + (d, kh, hd), Lr + ("fsdp", "tensor", "null"),
          init="fan_in")
    t.add(f"{prefix}/wo", Ls + (hp, hd, d), Lr + ("tensor", "null", "fsdp"),
          init="fan_in", zero_pad=pad_o)
    if cfg.attn_bias:
        t.add(f"{prefix}/bq", Ls + (hp, hd), Lr + ("tensor", "null"), init="zeros")
        t.add(f"{prefix}/bv", Ls + (kh, hd), Lr + ("tensor", "null"), init="zeros")
        t.add(f"{prefix}/bo", Ls + (d,), Lr + ("null",), init="zeros")


def _add_norm(t, cfg, path, nl=None):
    Ls = () if nl is None else (nl,)
    Lr = () if nl is None else ("null",)
    t.add(f"{path}/scale", Ls + (cfg.d_model,), Lr + ("null",), init="ones")
    t.add(f"{path}/bias", Ls + (cfg.d_model,), Lr + ("null",), init="zeros")


def param_table(cfg) -> ParamTable:
    t = ParamTable(cfg)
    d = cfg.d_model
    vp = cfg.vocab_padded
    le, ld = cfg.num_encoder_layers, cfg.num_layers

    # encoder
    _add_norm(t, cfg, "enc/layers/ln1", le)
    _add_attn(t, cfg, "enc/layers/attn", le)
    _add_norm(t, cfg, "enc/layers/ln2", le)
    mlp_lib.add_mlp_params(t, cfg, "enc/layers/mlp", le)
    _add_norm(t, cfg, "enc/final_norm")

    # decoder
    t.add("dec/embed/table", (vp, d), ("tensor", "fsdp"), init="normal")
    t.add("dec/pos/table", (cfg.max_positions, d), ("null", "fsdp"),
          init="normal")
    _add_norm(t, cfg, "dec/layers/ln1", ld)
    _add_attn(t, cfg, "dec/layers/attn", ld)
    _add_norm(t, cfg, "dec/layers/lnx", ld)
    _add_attn(t, cfg, "dec/layers/xattn", ld, cross=True)
    _add_norm(t, cfg, "dec/layers/ln2", ld)
    mlp_lib.add_mlp_params(t, cfg, "dec/layers/mlp", ld)
    _add_norm(t, cfg, "dec/final_norm")
    return t


# --------------------------------------------------------------------------- #
def _ln(cfg, x, p):
    return L.layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


def _proj_qkv(cfg, p, xq, xkv):
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        v = v + p["bv"]
    return q, k, v


def _cross_query(cfg, p, h):
    qx = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if cfg.attn_bias:
        qx = qx + p["bq"]
    return qx


def _cross_kv(cfg, p, enc_out):
    """Cross-attention K/V of one decoder layer from the encoder output."""
    ek = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    ev = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    if cfg.attn_bias:
        ev = ev + p["bv"]
    return ek, ev


def _attn_out(cfg, p, out):
    y = attn_out_proj(cfg, {"wo": p["wo"]}, out)
    if cfg.attn_bias:
        y = y + p["bo"]
    return y


def _attend(cfg, q, k, v, causal):
    """Attention through the flash kernel's dispatch.  Causal calls have
    the queries at the last Sq of the Sk keys (the decoder's q and k share
    positions, or the query is the ring's newest); non-causal calls see
    every key, so positions do not enter."""
    return transformer.flash_attention(
        q, k, v, causal=causal, window=None,
        scale=cfg.attn_scale_override, logit_cap=cfg.attn_logit_softcap)


def sinusoid_positions(s: int, d: int, dtype,
                       device=None) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(dtype)


def encode(cfg, params, frames):
    """frames: (B, S_enc, d) stub embeddings -> encoder output (B,S_enc,d)."""
    dt = torch_dtype(cfg.dtype)
    _, s, d = frames.shape
    x = frames.to(dt) + sinusoid_positions(s, d, dt, frames.device)[None]
    for i in range(cfg.num_encoder_layers):
        p = layer_params(params["enc"]["layers"], i)
        h = _ln(cfg, x, p["ln1"])
        q, k, v = _proj_qkv(cfg, p["attn"], h, h)
        x = x + _attn_out(cfg, p["attn"], _attend(cfg, q, k, v, False))
        h = _ln(cfg, x, p["ln2"])
        x = x + mlp_lib.mlp(cfg, p["mlp"], h)
    return _ln(cfg, x, params["enc"]["final_norm"])


def _dec_layer(cfg, p, x, enc_kv):
    h = _ln(cfg, x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p["attn"], h, h)
    x = x + _attn_out(cfg, p["attn"], _attend(cfg, q, k, v, True))

    h = _ln(cfg, x, p["lnx"])
    qx = _cross_query(cfg, p["xattn"], h)
    ek, ev = enc_kv
    x = x + _attn_out(cfg, p["xattn"], _attend(cfg, qx, ek, ev, False))

    h = _ln(cfg, x, p["ln2"])
    return x + mlp_lib.mlp(cfg, p["mlp"], h)


def _embed(cfg, params, tokens, pos_table_rows):
    dt = torch_dtype(cfg.dtype)
    x = L.embed_lookup(params["dec"]["embed"]["table"], tokens).to(dt)
    return x + pos_table_rows[None].to(dt)


def _unembed(params, x):
    return torch.einsum("bsd,vd->bsv", x, params["dec"]["embed"]["table"])


def forward(cfg, params, tokens, frames):
    """Teacher-forced enc-dec forward -> (logits (B,S,Vp), aux=0)."""
    enc_out = encode(cfg, params, frames)
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens, params["dec"]["pos"]["table"][:s])
    for i in range(cfg.num_layers):
        p = layer_params(params["dec"]["layers"], i)
        # cross-attention K/V projected per layer from the encoder output
        x = _dec_layer(cfg, p, x, _cross_kv(cfg, p["xattn"], enc_out))
    x = _ln(cfg, x, params["dec"]["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(params, x), aux


# --------------------------------------------------------------------------- #
# Decode: ring-buffer self cache + precomputed cross K/V
# --------------------------------------------------------------------------- #
def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    """The decode state: the self-attention ring k/v (L, B, W, K, hd),
    the cross-attention xk/xv (L, B, S_enc, K, hd), both zero in
    cfg.dtype, kpos (W,) int32 with -1 marking an empty slot, and ``t``
    as a host int (as ``transformer.init_cache``).  The cross K/V stay
    zero until :func:`prefill_cross_cache` fills them."""
    w = cache_len(cfg, seq_len)
    kh, hd, nl = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    dt = torch_dtype(cfg.dtype)
    ring = (nl, batch, w, kh, hd)
    cross = (nl, batch, cfg.encoder_seq_len, kh, hd)
    return {"k": torch.zeros(ring, dtype=dt, device=device),
            "v": torch.zeros(ring, dtype=dt, device=device),
            "xk": torch.zeros(cross, dtype=dt, device=device),
            "xv": torch.zeros(cross, dtype=dt, device=device),
            "kpos": torch.full((w,), -1, dtype=torch.int32, device=device),
            "t": 0}


def cache_roles(cfg, shd, seq_len: int) -> dict:
    """The reference's sharding roles of each cache tensor: the ring's as
    the decoder LM's (``transformer.cache_roles``), the cross K/V's along
    the kv heads."""
    roles = transformer.cache_roles(cfg, shd, seq_len)
    cross = ("null", "batch", "null", "tensor", "null")
    return {**roles, "xk": cross, "xv": cross}


def prefill_cross_cache(cfg, params, frames, cache):
    """Run the encoder once and fill the cross-attention K/V: returns a
    new cache dict whose ``xk``/``xv`` hold every decoder layer's
    projection of the encoder output."""
    dt = torch_dtype(cfg.dtype)
    enc_out = encode(cfg, params, frames)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        p = layer_params(params["dec"]["layers"], i)
        ek, ev = _cross_kv(cfg, p["xattn"], enc_out)
        ks.append(ek.to(dt))
        vs.append(ev.to(dt))
    return dict(cache, xk=torch.stack(ks), xv=torch.stack(vs))


def decode_step(cfg, params, cache, tokens, shd=None, *,
                use_brick: Optional[bool] = None):
    """tokens: (B, 1) -> (logits (B,1,Vp), cache).  The ring's tensors
    are updated in place and the returned dict holds them with ``t``
    advanced; the self-attention attends over the ring's filled prefix
    (see ``transformer.decode_step``), the cross-attention over every
    encoder position.

    ``use_brick`` None takes the grid-brick cache where ``brick_active``
    holds for ``shd``, as the reference; True takes it whatever the cache
    length (the Sharder's bricks must cut the cache), False never."""
    from repro_torch.core import brick_attention
    t, slot, n = ring_slot(cache, None)
    w = cache["k"].shape[2]
    if use_brick is None:
        use_brick = shd is not None and brick_attention.brick_active(
            cfg, shd, w)
    elif use_brick and shd is None:
        raise ValueError("use_brick needs the Sharder of a mesh whose model "
                         "axis cuts the cache into bricks")
    cache["kpos"][slot] = t
    row = min(max(t, 0), cfg.max_positions - 1)
    x = _embed(cfg, params, tokens,
               params["dec"]["pos"]["table"][row:row + 1])

    for i in range(cfg.num_layers):
        p = layer_params(params["dec"]["layers"], i)
        k_i, v_i = cache["k"][i], cache["v"][i]
        h = _ln(cfg, x, p["ln1"])
        q, k_new, v_new = _proj_qkv(cfg, p["attn"], h, h)
        if use_brick:
            out = brick_attention.decode_attention(
                cfg, shd, q, k_i, v_i, cache["kpos"], k_new, v_new, slot, t)
        else:
            k_i[:, slot] = k_new[:, 0].to(k_i.dtype)
            v_i[:, slot] = v_new[:, 0].to(v_i.dtype)
            # every slot of [0, n) holds one of the last n positions <= t
            out = _attend(cfg, q, k_i[:, :n], v_i[:, :n], True)
        x = x + _attn_out(cfg, p["attn"], out)

        h = _ln(cfg, x, p["lnx"])
        qx = _cross_query(cfg, p["xattn"], h)
        out = _attend(cfg, qx, cache["xk"][i], cache["xv"][i], False)
        x = x + _attn_out(cfg, p["xattn"], out)

        h = _ln(cfg, x, p["ln2"])
        x = x + mlp_lib.mlp(cfg, p["mlp"], h)

    x = _ln(cfg, x, params["dec"]["final_norm"])
    return _unembed(params, x), {**cache, "t": t + 1}


# --------------------------------------------------------------------------- #
def build(cfg) -> "model_zoo.Model":
    return model_zoo.Model(
        cfg=cfg,
        table=param_table(cfg),
        forward=lambda params, batch: forward(
            cfg, params, batch["tokens"], batch["frames"]),
        decode_step=lambda params, cache, tokens, shd=None: decode_step(
            cfg, params, cache, tokens, shd),
        init_cache=lambda b, s, device: init_cache(cfg, b, s, device),
        init_cache_abstract=lambda shd, b, s: model_zoo.abstract_cache(
            init_cache(cfg, b, s, "meta"), cache_roles(cfg, shd, s), shd,
            s),
        extra_inputs=model_zoo.embeds_input(cfg, "frames",
                                            cfg.encoder_seq_len),
    )
