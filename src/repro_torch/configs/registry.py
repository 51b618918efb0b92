"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module name under repro.configs
_ARCH_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-14b": "qwen3_14b",
    "chatglm3-6b": "chatglm3_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
    "grok-1-314b": "grok1_314b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "xlstm-350m": "xlstm_350m",
    "pixtral-12b": "pixtral_12b",
    "geps-events": "geps_events",  # the paper's own event-processing workload
}


def list_archs() -> List[str]:
    return [a for a in _ARCH_MODULES if a != "geps-events"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: few layers, narrow,
    small vocab — preserves every structural feature (GQA ratio, qk-norm,
    MoE top-k, block patterns, enc-dec, patches...)."""
    cfg = get_config(arch)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    # preserve GQA (kv < heads) whenever the full config has it
    if cfg.num_kv_heads < cfg.num_heads and kv >= heads:
        kv = max(1, heads // 2)
    head_dim = 16
    d_model = heads * head_dim * 2  # keep d_model != heads*head_dim (q proj real)
    changes = dict(
        num_layers=min(cfg.num_layers, 4),
        remat_segments=min(cfg.remat_segments, 2),
        microbatches=1,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
        param_dtype="float32",
        moe_group_size=64,
    )
    if cfg.num_experts:
        changes["num_experts"] = min(cfg.num_experts, 4)
        changes["num_experts_per_tok"] = min(cfg.num_experts_per_tok, 2)
    if cfg.num_encoder_layers:
        changes["num_encoder_layers"] = min(cfg.num_encoder_layers, 2)
        changes["encoder_seq_len"] = 32
    if cfg.lru_width:
        changes["lru_width"] = d_model
    if cfg.xlstm_pattern:
        changes["xlstm_pattern"] = ("mlstm", "slstm")  # keep both kinds
    if cfg.attention_window:
        changes["attention_window"] = 16
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.num_patches:
        changes["num_patches"] = 4
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
