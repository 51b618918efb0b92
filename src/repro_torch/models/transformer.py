"""Decoder-only transformer LM on torch tensors (dense / MoE / VLM
backbone; port of ``models/transformer.py``).

Layers run in a Python loop over the stacked layer parameters (the
reference's ``scan_layers`` is a TPU compile-size device with no port).
The reference's ``Sharder`` constraints are no-ops on the port's meshes
(one card, or a mesh emulated on it), so the forward takes none; the
decode step takes one, and where ``brick_active`` holds for it the step
attends through the grid-brick cache (``core/brick_attention.py``).
With grad mode on, ``run_layers`` applies the reference's
remat: ``remat_policy`` ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the
products without batch dims and recomputes the rest, and
``remat_segments`` G > 1 checkpoints G segments of L / G layers around
them; serving (grad mode off) runs the plain loop.  In a step traced by
the step tracer (``obs/trace.py``) each recompute of a checkpointed layer
or segment is a ``train.recompute`` span and the unembedding a
``model.unembed`` span.  Every attention call goes through
``kernels/flash_attention/ops.py``: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain version.  A config
with experts runs ``models/moe.py`` in place of the MLP (forward returns
the summed load-balancing loss); a config with patches projects
precomputed patch embeddings in front of the tokens (pixtral's stubbed
vision front end).

Param paths (all stacked with leading L), as the reference:
  embed/table (Vp, d)            out/head (d, Vp)          final_norm/scale
  layers/ln1/scale               layers/ln2/scale
  layers/attn/{wq,wk,wv,wo}      layers/attn/{q_norm,k_norm}  (qk_norm)
  layers/mlp/...  or  layers/moe/...
  vlm/patch_proj (d_patch_in, d) (pixtral stub frontend)
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.model_zoo import LanguageModel
from repro_torch.models.params import ParamTable, torch_dtype
from repro_torch.obs import trace


# --------------------------------------------------------------------------- #
# Parameter table
# --------------------------------------------------------------------------- #
def param_table(cfg) -> ParamTable:
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
    if cfg.num_experts:
        moe_lib.add_moe_params(t, cfg, "layers/moe", nl)
    else:
        mlp_lib.add_mlp_params(t, cfg, "layers/mlp", nl)

    if cfg.num_patches:
        # pixtral stub frontend: project precomputed patch embeddings
        t.add("vlm/patch_proj", (d, d), ("fsdp", "null"), init="fan_in")
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
    """Layer ``i``'s slice of the stacked layer parameters (views), or its
    entry where a path holds a list of per-layer tensors."""
    return {key: layer_params(val, i) if isinstance(val, dict) else val[i]
            for key, val in layers.items()}


def _ffn(cfg, p, h):
    """The layer's feed-forward: the experts (``moe_block``) when the
    config has them, else the MLP.  Returns (out, aux loss f32)."""
    if cfg.num_experts:
        return moe_lib.moe_block(cfg, p["moe"], h)
    return mlp_lib.mlp(cfg, p["mlp"], h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def _layer(cfg, p, x, positions):
    """One pre-norm transformer layer. Returns (x, aux_loss)."""
    h = L.norm(cfg, x, p["ln1"]["scale"], p["ln1"].get("bias"))
    a = self_attention(cfg, p["attn"], h, positions,
                       window=cfg.sliding_window)
    if cfg.post_attn_norm:
        a = L.norm(cfg, a, p["ln1_post"]["scale"])
    x = x + a
    h = L.norm(cfg, x, p["ln2"]["scale"], p["ln2"].get("bias"))
    m, aux = _ffn(cfg, p, h)
    if cfg.post_attn_norm:
        m = L.norm(cfg, m, p["ln2_post"]["scale"])
    return x + m, aux


def _dots_policy():
    """Selective-checkpoint contexts that keep the outputs of products
    without batch dims (the reference's
    ``checkpoint_dots_with_no_batch_dims``: the projections, which einsum
    runs as ``mm`` or as ``bmm`` over one batch) and recompute the rest."""
    aten = torch.ops.aten

    def policy(ctx, op, *args, **kwargs):
        dot = op in (aten.mm.default, aten.addmm.default) or (
            op == aten.bmm.default and args[0].shape[0] == 1)
        return (ckpt.CheckpointPolicy.MUST_SAVE if dot
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return ckpt.create_selective_checkpoint_contexts(policy)


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat_policy``: ``"none"`` as it is, ``"dots"``
    checkpointed keeping the products without batch dims, ``"full"``
    checkpointed whole (its activations recomputed in the backward).  In
    a traced step each call's recompute is a ``train.recompute`` span
    whose ``layer`` is the call's place among the calls of the returned
    function (a layer's or super-block's index in a forward that runs
    each once, in order)."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        remat = functools.partial(ckpt.checkpoint, use_reentrant=False,
                                  context_fn=_dots_policy)
    elif cfg.remat_policy == "full":
        remat = functools.partial(ckpt.checkpoint, use_reentrant=False)
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    if trace.step_tracer() is None:
        return functools.partial(remat, fn)
    calls = itertools.count()
    return lambda *args: remat(trace.recomputed(fn, layer=next(calls)),
                               *args)


def run_layers(cfg, layers: dict, x, positions):
    """The layers over x, in order: (x, summed aux loss).

    ``layers`` holds the stacked layer parameters (or, as the trainer
    gives them, a list of per-layer tensors at each path).  With grad mode
    on each layer runs under ``_remat``, and with ``cfg.remat_segments`` =
    G > 1 the L layers are G checkpointed segments of L / G (sqrt remat:
    the backward keeps G segment inputs instead of L layer inputs).  With
    grad mode off (serving) no layer is checkpointed."""
    n = cfg.num_layers

    def layer(p_i, x):
        return _layer(cfg, p_i, x, positions)

    if not torch.is_grad_enabled():
        body = layer
    else:
        body = _remat(cfg, layer)

    def run(lo, hi, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lo, hi):
            x, aux_i = body(layer_params(layers, i), x)
            aux = aux + aux_i
        return x, aux

    g = cfg.remat_segments
    if not torch.is_grad_enabled() or g <= 1:
        return run(0, n, x)
    if n % g:
        raise ValueError(f"{n} layers do not split into {g} segments")
    k = n // g
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(g):
        x, aux_s = ckpt.checkpoint(trace.recomputed(run, segment=s), s * k,
                                   (s + 1) * k, x, use_reentrant=False)
        aux = aux + aux_s
    return x, aux


def embed_tokens(cfg, params, tokens, patch_embeds=None):
    """Token embeddings times ``embed_scale``; with a patch front end
    (``cfg.num_patches``) and ``patch_embeds`` (B, P, d), the first P
    positions are the projected patch embeddings instead."""
    dt = torch_dtype(cfg.dtype)
    x = L.embed_lookup(params["embed"]["table"], tokens)
    x = x.to(dt) * torch.tensor(cfg.embed_scale, dtype=dt, device=x.device)
    if cfg.num_patches and patch_embeds is not None:
        # pixtral stub: precomputed patch embeddings projected and prepended
        pe = torch.einsum("bpd,de->bpe", patch_embeds.to(dt),
                          params["vlm"]["patch_proj"])
        x = torch.cat([pe, x[:, cfg.num_patches:, :]], dim=1)
    return x


def unembed(cfg, params, x):
    """x (B, S, d) -> logits (B, S, Vp); in a traced step a
    ``model.unembed`` span with the ``positions`` it unembeds and, as the
    step marks them, the ``served`` ones whose logits it uses."""
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["out"]["head"])
    n = x.shape[0] * x.shape[1]
    with trace.step_span("model.unembed", positions=n, served=n):
        return torch.einsum("bsd,dv->bsv", x, table)


def forward(cfg, params, tokens, patch_embeds=None):
    """tokens: (B, S) [+ patch_embeds (B, P, d)] -> (logits (B, S, Vp),
    aux loss: the experts' summed over the layers, 0 without experts)."""
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int64, device=tokens.device)
    x = embed_tokens(cfg, params, tokens, patch_embeds)
    x, aux = run_layers(cfg, params["layers"], x, positions)
    x = L.norm(cfg, x, params["final_norm"]["scale"],
               params["final_norm"].get("bias"))
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


def cache_roles(cfg, shd, seq_len: int) -> dict:
    """The reference's sharding roles of each cache tensor
    (``init_cache_abstract``): k/v cut along the sequence over the model
    axis where the grid-brick layout holds (``brick_active``), along the
    kv heads otherwise."""
    from repro_torch.core import brick_attention
    seq = "tensor" if brick_attention.brick_active(
        cfg, shd, cache_len(cfg, seq_len)) else "null"
    kv = ("null", "batch", seq, "tensor" if seq == "null" else "null",
          "null")
    return {"k": kv, "v": kv, "kpos": ("null",)}


def decode_attention(cfg, p, h, positions, k_i, v_i, slot, n, brick=None):
    """The attention sub-block of one decode step (no residual): write the
    new k/v into ``slot`` of the layer's ring cache ``k_i``/``v_i``
    (B, W, K, hd) in place, attend over the filled prefix ``[0, n)``.
    With ``brick = (shd, kpos, t)`` the step attends instead over all W
    slots of the grid-brick cache, ``kpos`` masking the empty ones, as
    the reference's brick path (``core/brick_attention.py``).
    h:(B,1,d) -> (B,1,d)."""
    q, k_new, v_new = attn_qkv(cfg, p, h, positions)
    if brick is not None:
        from repro_torch.core import brick_attention
        shd, kpos, t = brick
        out = brick_attention.decode_attention(cfg, shd, q, k_i, v_i, kpos,
                                               k_new, v_new, slot, t)
        return attn_out_proj(cfg, p, out)
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


def _decode_layer(cfg, p, x, positions, k_i, v_i, slot, n, brick=None):
    """Decode step for one layer: write the new k/v into ``slot`` of the
    layer's cache (in place), attend over the filled prefix ``[0, n)`` (or
    the brick cache, see ``decode_attention``).  x:(B,1,d)."""
    h = L.norm(cfg, x, p["ln1"]["scale"], p["ln1"].get("bias"))
    a = decode_attention(cfg, p["attn"], h, positions, k_i, v_i, slot, n,
                         brick)
    if cfg.post_attn_norm:
        a = L.norm(cfg, a, p["ln1_post"]["scale"])
    x = x + a
    h = L.norm(cfg, x, p["ln2"]["scale"], p["ln2"].get("bias"))
    m, _ = _ffn(cfg, p, h)
    if cfg.post_attn_norm:
        m = L.norm(cfg, m, p["ln2_post"]["scale"])
    return x + m


def decode_step(cfg, params, cache, tokens, shd=None):
    """tokens: (B, 1) -> (logits (B,1,Vp), cache).

    The cache's tensors are updated in place (the reference returns new
    arrays; one card has no use for the copy) and the returned dict holds
    them with ``t`` advanced.  The reference attends over all W slots with
    ``kpos`` masking the empty ones; the port attends over the filled
    prefix ``[0, n)``, ``n = min(t + 1, W)``, which holds exactly the slots
    the reference finds valid: before the ring wraps ``kpos[j] = j <= t``;
    after it wraps all W slots hold the last W positions; and a windowed
    cache has ``W <= window``, so no filled slot lies outside the window.

    Given a Sharder ``shd`` for which ``brick_active`` holds (an
    unwindowed cache of more than 4096 slots cut into the mesh's
    ``tensor_size`` bricks), every layer attends as the reference does on
    that mesh: over all W slots of the brick cache, ``kpos`` masking the
    empty ones, the bricks merged by an exact log-sum-exp combine."""
    from repro_torch.core import brick_attention
    t, slot, n = ring_slot(cache, cfg.sliding_window or
                           cfg.attention_window)
    positions = torch.full((1,), t, dtype=torch.int64, device=tokens.device)
    cache["kpos"][slot] = t
    brick = None
    if shd is not None and brick_attention.brick_active(
            cfg, shd, cache["k"].shape[2]):
        brick = (shd, cache["kpos"], t)

    x = embed_tokens(cfg, params, tokens)
    for i in range(cfg.num_layers):
        x = _decode_layer(cfg, layer_params(params["layers"], i), x,
                          positions, cache["k"][i], cache["v"][i], slot, n,
                          brick)
    x = L.norm(cfg, x, params["final_norm"]["scale"],
               params["final_norm"].get("bias"))
    logits = unembed(cfg, params, x)
    return logits, {**cache, "t": t + 1}


# --------------------------------------------------------------------------- #
class TransformerLM(LanguageModel):
    """The decoder LM (dense, MoE or VLM) as an ``nn.Module``:
    ``LanguageModel`` on the decoder facade of ``cfg``."""

    def __init__(self, cfg, params: dict):
        from repro_torch.models.model_zoo import build_model
        super().__init__(build_model(cfg), params)
