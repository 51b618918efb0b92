"""Analytic MODEL_FLOPS (the 6ND yardstick) per architecture x shape (port
of ``analysis/flops.py``, function for function).

MODEL_FLOPS is the *useful* compute: 6 * N * D for dense training
(N = non-embedding params, D = tokens), 6 * N_active * D for MoE, and the
forward third of that (2ND) for prefill; decode counts one token per
sequence.  The ratio MODEL_FLOPS / step FLOPs exposes remat recompute,
padded-head waste, MoE capacity slack, and attention's quadratic extra.
The counts read the port's ``ParamTable``, whose paths are the
reference's, so its embedding and expert markers hold as written.
"""
from __future__ import annotations

from repro_torch.models import model_zoo
from repro_torch.models.params import np_prod


def param_counts(cfg):
    """(total, embedding-ish, active) parameter counts from the ParamTable."""
    model = model_zoo.build_model(cfg)
    total = 0
    embed = 0
    moe = 0
    for path, d in model.table.defs.items():
        n = np_prod(d.shape)
        total += n
        if "embed" in path or "out/head" in path or "pos/table" in path:
            embed += n
        if "/moe/w_" in path:
            moe += n
    active = total - embed
    if cfg.num_experts and cfg.num_experts_per_tok:
        active -= moe * (1 - cfg.num_experts_per_tok / cfg.num_experts)
    return total, embed, active


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per global step for the cell."""
    total, embed, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * active * tokens
        # embedding/unembed matmul: the unembed dot is real compute
        base += 6.0 * cfg.d_model * cfg.vocab_padded * tokens
        return base
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens + 2.0 * cfg.d_model * cfg.vocab_padded * tokens
    # decode: one token per sequence
    tokens = shape.global_batch
    flops = 2.0 * active * tokens + 2.0 * cfg.d_model * cfg.vocab_padded * tokens
    # attention over the cache: 2 * 2 * H * hd * W per token
    w = min(shape.seq_len, cfg.sliding_window or cfg.attention_window
            or shape.seq_len)
    flops += 4.0 * cfg.num_heads_padded * cfg.head_dim * w * tokens * (
        cfg.num_layers)
    return flops
