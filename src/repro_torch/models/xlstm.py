"""xLSTM LM (sLSTM + mLSTM blocks), xLSTM[7:1]-style, on torch tensors
(port of ``models/xlstm.py``).

24 layers = 3 super-blocks of (7 mLSTM + 1 sLSTM), with the super-blocks'
parameters stacked; layers run in a Python loop, as in the dense port.

mLSTM: matrix-memory cell.  The full sequence goes through
``kernels/mlstm_scan/ops.py``: a CUDA tensor launches the hand-written
chunkwise kernel (in training, through ``MlstmFn``, whose backward is the
hand-written backward kernel), a CPU tensor takes ``mlstm_parallel`` (the
flash-attention-like oracle, with gate decay biases instead of softmax
normalisation).  Decode is the O(1) recurrent update on the (H, hd, hd)
matrix state, in plain PyTorch as in the reference.

sLSTM: scalar-memory cell with per-head block-diagonal recurrent weights;
inherently sequential, so a time loop in f32.

Remat in training (grad mode on), as the reference: each super-block runs
under ``transformer._remat`` (``cfg.remat_policy``); the sLSTM's time
loop is checkpointed in chunks of ``SLSTM_REMAT_CHUNK`` steps when the
sequence is longer than one chunk and a multiple of it (the backward
keeps one state a chunk and recomputes the chunk's steps), nested in the
super-block's checkpoint; and the plain mLSTM checkpoints each query
chunk (``kernels/mlstm_scan/ref.py``; on the card ``MlstmFn`` saves only
its inputs and the row stats).  Serving runs the plain loops.

Both blocks keep O(1) decode state; ``decode_step`` updates it in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.mlstm_scan.ops import mlstm as mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import NEG, mlstm_ref
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import Model, abstract_cache
from repro_torch.models.params import ParamTable, torch_dtype
from repro_torch.models.rglru import causal_conv1d
from repro_torch.models.transformer import _remat, embed_tokens, \
    layer_params, unembed

MLSTM_PF = 2.0  # mLSTM up-projection factor
SLSTM_PF = 4.0 / 3.0  # sLSTM post-FFN factor
#: time steps of one checkpointed chunk of the sLSTM loop in training
SLSTM_REMAT_CHUNK = 256


def _dims(cfg):
    d = cfg.d_model
    inner = int(MLSTM_PF * d)
    h = cfg.num_heads
    return d, inner, h, inner // h, d // h  # d, inner, H, hd_m, hd_s


def _pattern(cfg):
    unit = cfg.xlstm_pattern or ("mlstm",) * 7 + ("slstm",)
    n_super = cfg.num_layers // len(unit)
    if n_super * len(unit) != cfg.num_layers:
        raise ValueError(f"{cfg.num_layers} layers are not a whole number "
                         f"of {unit}")
    return unit, n_super


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def _add_mlstm(t: ParamTable, cfg, prefix, nl):
    d, inner, h, hd, _ = _dims(cfg)
    Ls, Lr = (nl,), ("null",)
    t.add(f"{prefix}/ln/scale", Ls + (d,), Lr + ("null",), init="zeros")
    t.add(f"{prefix}/w_up", Ls + (d, inner), Lr + ("fsdp", "tensor"), init="fan_in")
    t.add(f"{prefix}/w_gate", Ls + (d, inner), Lr + ("fsdp", "tensor"), init="fan_in")
    t.add(f"{prefix}/conv_w", Ls + (cfg.conv1d_width, inner),
          Lr + ("null", "tensor"), init="fan_in")
    t.add(f"{prefix}/conv_b", Ls + (inner,), Lr + ("tensor",), init="zeros")
    t.add(f"{prefix}/wq", Ls + (h, hd, hd), Lr + ("tensor", "null", "null"),
          init="fan_in")
    t.add(f"{prefix}/wk", Ls + (h, hd, hd), Lr + ("tensor", "null", "null"),
          init="fan_in")
    t.add(f"{prefix}/wv", Ls + (h, hd, hd), Lr + ("tensor", "null", "null"),
          init="fan_in")
    t.add(f"{prefix}/w_i", Ls + (inner, h), Lr + ("fsdp", "null"), init="fan_in")
    t.add(f"{prefix}/b_i", Ls + (h,), Lr + ("null",), init="zeros")
    t.add(f"{prefix}/w_f", Ls + (inner, h), Lr + ("fsdp", "null"), init="fan_in")
    t.add(f"{prefix}/b_f", Ls + (h,), Lr + ("null",), init="ones", scale=3.0)
    t.add(f"{prefix}/out_norm/scale", Ls + (inner,), Lr + ("tensor",), init="zeros")
    t.add(f"{prefix}/w_down", Ls + (inner, d), Lr + ("tensor", "fsdp"),
          init="fan_in")


def _add_slstm(t: ParamTable, cfg, prefix, nl):
    d, _, h, _, hd = _dims(cfg)
    Ls, Lr = (nl,), ("null",)
    t.add(f"{prefix}/ln/scale", Ls + (d,), Lr + ("null",), init="zeros")
    for g in ("z", "i", "f", "o"):
        t.add(f"{prefix}/w_{g}", Ls + (d, d), Lr + ("fsdp", "null"), init="fan_in")
        t.add(f"{prefix}/r_{g}", Ls + (h, hd, hd), Lr + ("null", "null", "null"),
              init="fan_in", scale=0.01)
        t.add(f"{prefix}/b_{g}", Ls + (d,), Lr + ("null",),
              init="ones" if g == "f" else "zeros")
    t.add(f"{prefix}/out_norm/scale", Ls + (d,), Lr + ("null",), init="zeros")
    # post-FFN (pf = 4/3 gated)
    f_ff = int(SLSTM_PF * d)
    t.add(f"{prefix}/ln_ff/scale", Ls + (d,), Lr + ("null",), init="zeros")
    t.add(f"{prefix}/ff_gate", Ls + (d, f_ff), Lr + ("fsdp", "tensor"), init="fan_in")
    t.add(f"{prefix}/ff_in", Ls + (d, f_ff), Lr + ("fsdp", "tensor"), init="fan_in")
    t.add(f"{prefix}/ff_out", Ls + (f_ff, d), Lr + ("tensor", "fsdp"), init="fan_in")


def param_table(cfg) -> ParamTable:
    t = ParamTable(cfg)
    d, vp = cfg.d_model, cfg.vocab_padded
    unit, n_super = _pattern(cfg)
    t.add("embed/table", (vp, d), ("tensor", "fsdp"), init="normal")
    if not cfg.tie_embeddings:
        t.add("out/head", (d, vp), ("fsdp", "tensor"), init="fan_in")
    t.add("final_norm/scale", (d,), ("null",), init="zeros")
    for j, kind in enumerate(unit):
        prefix = f"blocks/u{j}"
        (_add_mlstm if kind == "mlstm" else _add_slstm)(t, cfg, prefix, n_super)
    return t


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #
def _mlstm_qkv_gates(cfg, p, x):
    """x: (B,S,d). Returns xu, q,k,v (B,S,H,hd), log_i, log_f (B,S,H)
    f32."""
    d, inner, h, hd, _ = _dims(cfg)
    b, s, _ = x.shape
    xu = torch.einsum("bsd,de->bse", x, p["w_up"])  # (B,S,inner)
    xc, _ = causal_conv1d(xu, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    xh = xc.reshape(b, s, h, hd)
    q = torch.einsum("bshc,hce->bshe", xh, p["wq"])
    k = torch.einsum("bshc,hce->bshe", xh, p["wk"])
    v = torch.einsum("bshc,hce->bshe", xu.reshape(b, s, h, hd), p["wv"])
    xuf = xu.float()
    log_i = (torch.einsum("bse,eh->bsh", xuf, p["w_i"].float())
             + p["b_i"].float())
    log_f = F.logsigmoid(
        torch.einsum("bse,eh->bsh", xuf, p["w_f"].float())
        + p["b_f"].float())
    return xu, q, k, v, log_i, log_f


def mlstm_parallel(cfg, q, k, v, log_i, log_f, chunk_size=1024):
    """Chunkwise-parallel mLSTM, the plain version of the kernel (see
    ``kernels/mlstm_scan/ref.py``).  q,k,v: (B,S,H,hd); log_i/log_f:
    (B,S,H) f32.  Returns h: (B,S,H,hd)."""
    return mlstm_ref(q, k, v, log_i, log_f, chunk_size=chunk_size)


def mlstm_block(cfg, p, x):
    """Full mLSTM residual block. x: (B,S,d)."""
    d, inner, h, hd, _ = _dims(cfg)
    b, s, _ = x.shape
    xin = L.rmsnorm(x, p["ln"]["scale"], cfg.norm_eps)
    xu, q, k, v, log_i, log_f = _mlstm_qkv_gates(cfg, p, xin)
    hh = mlstm_scan(q, k, v, log_i, log_f)
    hh = hh.reshape(b, s, inner)
    hh = L.rmsnorm(hh, p["out_norm"]["scale"], cfg.norm_eps)
    z = torch.einsum("bsd,de->bse", xin, p["w_gate"])
    y = hh * F.silu(z)
    return x + torch.einsum("bse,ed->bsd", y, p["w_down"])


def mlstm_decode(cfg, p, x, state):
    """One-token mLSTM step. state: dict(C (B,H,hd,hd), n (B,H,hd), m (B,H),
    conv (B,T-1,inner)) all f32 except conv.  Returns (out, new state)."""
    d, inner, h, hd, _ = _dims(cfg)
    b = x.shape[0]
    xin = L.rmsnorm(x, p["ln"]["scale"], cfg.norm_eps)
    xu = torch.einsum("bsd,de->bse", xin, p["w_up"])
    xc, conv = causal_conv1d(xu, p["conv_w"], p["conv_b"], state["conv"])
    xc = F.silu(xc)
    xh = xc.reshape(b, 1, h, hd)
    q = torch.einsum("bshc,hce->bshe", xh, p["wq"])[:, 0]  # (B,H,hd)
    kk = torch.einsum("bshc,hce->bshe", xh, p["wk"])[:, 0]
    vv = torch.einsum("bshc,hce->bshe", xu.reshape(b, 1, h, hd),
                      p["wv"])[:, 0]
    xuf = xu.float()[:, 0]
    log_i = (xuf @ p["w_i"].float()) + p["b_i"].float()
    log_f = F.logsigmoid((xuf @ p["w_f"].float()) + p["b_f"].float())

    m_new = torch.maximum(log_f + state["m"], log_i)  # (B,H)
    decay = torch.exp(log_f + state["m"] - m_new)
    inp = torch.exp(log_i - m_new)
    kf = kk.float()
    vf = vv.float()
    C = (state["C"] * decay[..., None, None]
         + inp[..., None, None] * torch.einsum("bhk,bhv->bhkv", kf, vf))
    n = state["n"] * decay[..., None] + inp[..., None] * kf
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.sum(n * qf, dim=-1).abs(), torch.exp(-m_new))
    hh = (num / den[..., None]).reshape(b, 1, inner).to(x.dtype)
    hh = L.rmsnorm(hh, p["out_norm"]["scale"], cfg.norm_eps)
    z = torch.einsum("bsd,de->bse", xin, p["w_gate"])
    y = hh * F.silu(z)
    out = x + torch.einsum("bse,ed->bsd", y, p["w_down"])
    return out, {"C": C, "n": n, "m": m_new, "conv": conv}


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #
def _slstm_cell(cfg, rec_w, zifo, state):
    """One time step. rec_w: the four (H, hd, hd) recurrent weights in f32,
    in z, i, f, o order; zifo: tuple of (B,d) pre-activations (x-part
    only).  state: (c,n,h,m) each (B,d) f32.  Returns (h_out (B,d), new
    state)."""
    d, _, heads, _, hd = _dims(cfg)
    b = zifo[0].shape[0]
    hh = state["h"].reshape(b, heads, hd)

    def rec(w):  # (H, hd, hd) applied per head
        return torch.einsum("bhc,hce->bhe", hh, w).reshape(b, d)

    z = torch.tanh(zifo[0] + rec(rec_w[0]))
    i_raw = zifo[1] + rec(rec_w[1])
    f_raw = zifo[2] + rec(rec_w[2])
    o = torch.sigmoid(zifo[3] + rec(rec_w[3]))

    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state["m"], i_raw)
    i_st = torch.exp(i_raw - m_new)
    f_st = torch.exp(log_f + state["m"] - m_new)
    c = f_st * state["c"] + i_st * z
    n = f_st * state["n"] + i_st
    h_out = o * c / torch.clamp(n, min=1e-6)
    return h_out, {"c": c, "n": n, "h": h_out, "m": m_new}


def slstm_block(cfg, p, x, state=None, decode=False):
    """sLSTM residual block + post-FFN. x: (B,S,d).  Returns (x, state)."""
    d, _, heads, _, hd = _dims(cfg)
    b, s, _ = x.shape
    xin = L.rmsnorm(x, p["ln"]["scale"], cfg.norm_eps)
    xf = xin.float()
    pre = [torch.einsum("bsd,de->bse", xf, p[f"w_{g}"].float())
           + p[f"b_{g}"].float() for g in ("z", "i", "f", "o")]
    rec_w = [p[f"r_{g}"].float() for g in ("z", "i", "f", "o")]
    if state is None:
        state = {k: torch.zeros((b, d), dtype=torch.float32,
                                device=x.device) for k in ("c", "n", "h")}
        state["m"] = torch.full((b, d), NEG, dtype=torch.float32,
                                device=x.device)

    def steps(state, lo, hi):
        """Time steps [lo, hi): (their h (B, hi - lo, d), the state)."""
        outs = []
        for t in range(lo, hi):
            h_out, state = _slstm_cell(cfg, rec_w,
                                       tuple(g[:, t] for g in pre), state)
            outs.append(h_out)
        return torch.stack(outs, dim=1), state

    chunk = SLSTM_REMAT_CHUNK
    if decode:
        hs, state = steps(state, 0, 1)
    elif torch.is_grad_enabled() and s > chunk and s % chunk == 0:
        # time-chunked remat: the backward keeps one state a chunk, not
        # every step's, and recomputes the chunk's steps
        parts = []
        for lo in range(0, s, chunk):
            h_c, state = ckpt.checkpoint(steps, state, lo, lo + chunk,
                                         use_reentrant=False)
            parts.append(h_c)
        hs = torch.cat(parts, dim=1)  # (B,S,d)
    else:
        hs, state = steps(state, 0, s)

    hs = L.rmsnorm(hs.to(x.dtype), p["out_norm"]["scale"], cfg.norm_eps)
    x = x + hs
    # post-FFN
    hf = L.rmsnorm(x, p["ln_ff"]["scale"], cfg.norm_eps)
    gate = torch.einsum("bsd,df->bsf", hf, p["ff_gate"])
    up = torch.einsum("bsd,df->bsf", hf, p["ff_in"])
    y = F.silu(gate) * up
    x = x + torch.einsum("bsf,fd->bsd", y, p["ff_out"])
    return x, state


# --------------------------------------------------------------------------- #
# Model assembly
# --------------------------------------------------------------------------- #
def forward(cfg, params, tokens):
    """tokens: (B, S) -> (logits (B, S, Vp), aux loss 0)."""
    unit, n_super = _pattern(cfg)
    x = embed_tokens(cfg, params, tokens)

    def super_block(p, x):
        for j, kind in enumerate(unit):
            if kind == "mlstm":
                x = mlstm_block(cfg, p[f"u{j}"], x)
            else:
                x, _ = slstm_block(cfg, p[f"u{j}"], x)
        return x

    body = (_remat(cfg, super_block) if torch.is_grad_enabled()
            else super_block)
    for i in range(n_super):
        x = body(layer_params(params["blocks"], i), x)
    x = L.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params, x), aux


def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    """Decode state under the reference's keys: per mLSTM layer ``C`` (B,
    H, hd, hd), ``n``, ``m`` (-1e30) and ``conv`` (B, T-1, inner) in
    cfg.dtype; per sLSTM layer ``s_c``, ``s_n``, ``s_h``, ``s_m`` (-1e30),
    (B, d); each stacked as (n_of_kind, n_super, ...).  All f32 but
    ``conv``; ``t`` is a host int.  ``seq_len`` is not read: the state is
    O(1) in the context."""
    d, inner, h, hd, _ = _dims(cfg)
    unit, n_super = _pattern(cfg)
    n_m = sum(1 for k in unit if k == "mlstm")
    n_s = len(unit) - n_m
    ct = cfg.conv1d_width - 1
    f32 = torch.float32

    def full(shape, value=0.0, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "C": full((n_m, n_super, batch, h, hd, hd)),
        "n": full((n_m, n_super, batch, h, hd)),
        "m": full((n_m, n_super, batch, h), NEG),
        "conv": full((n_m, n_super, batch, ct, inner),
                     dtype=torch_dtype(cfg.dtype)),
        "s_c": full((n_s, n_super, batch, d)),
        "s_n": full((n_s, n_super, batch, d)),
        "s_h": full((n_s, n_super, batch, d)),
        "s_m": full((n_s, n_super, batch, d), NEG),
        "t": 0,
    }


def decode_step(cfg, params, cache, tokens):
    """tokens: (B, 1) -> (logits (B,1,Vp), cache).  The cache's tensors
    are updated in place and the returned dict holds them with ``t``
    advanced."""
    unit, n_super = _pattern(cfg)
    x = embed_tokens(cfg, params, tokens)
    for i in range(n_super):
        p = layer_params(params["blocks"], i)
        mi = si = 0
        for j, kind in enumerate(unit):
            pj = p[f"u{j}"]
            if kind == "mlstm":
                views = {key: cache[key][mi, i]
                         for key in ("C", "n", "m", "conv")}
                x, st = mlstm_decode(cfg, pj, x, views)
                mi += 1
            else:
                views = {key: cache[f"s_{key}"][si, i]
                         for key in ("c", "n", "h", "m")}
                x, st = slstm_block(cfg, pj, x, state=dict(views),
                                    decode=True)
                si += 1
            for key, view in views.items():
                view.copy_(st[key])

    x = L.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(cfg, params, x)
    return logits, {**cache, "t": cache["t"] + 1}


#: the reference's sharding roles of each cache tensor
#: (``init_cache_abstract``)
CACHE_ROLES = {
    "C": ("null", "null", "batch", "null", "null", "null"),
    "n": ("null", "null", "batch", "null", "null"),
    "m": ("null", "null", "batch", "null"),
    "conv": ("null", "null", "batch", "null", "tensor"),
    **{key: ("null", "null", "batch", "null")
       for key in ("s_c", "s_n", "s_h", "s_m")}}


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
            init_cache(cfg, b, s, "meta"), CACHE_ROLES, shd, s),
        extra_inputs=lambda shape, shd: {},
    )
