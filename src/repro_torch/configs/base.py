"""Base configuration dataclasses for the GEPS grid-brick framework.

A copy of the JAX package's ``configs/base.py`` (no framework code).
Every assigned architecture is expressed as a ``ModelConfig``; every
input-shape cell as a ``ShapeConfig``.  Configs are frozen dataclasses.
The TPU and mesh knobs (``remat_*``, ``scan_layers``, ``fsdp_params``,
``seq_shard_norm``, ...) are kept as data; the port's one-card model
reads none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to_multiple(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (exact values from the assignment table)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention ---
    qk_norm: bool = False
    rope_style: str = "neox"  # neox | half (chatglm 2d) | none
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None  # grok-1 style
    attn_scale_override: Optional[float] = None

    # --- mlp ---
    mlp_style: str = "swiglu"  # swiglu | geglu | gelu

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_sharding: str = "tp"  # tp: shard d_ff over model axis | ep: shard experts

    # --- hybrid (recurrentgemma): repeating block pattern ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "local_attn")
    lru_width: Optional[int] = None
    attention_window: Optional[int] = None  # local attention window (hybrid)
    conv1d_width: int = 4

    # --- xLSTM ---
    xlstm_pattern: Tuple[str, ...] = ()  # e.g. ("mlstm",) or ("slstm","mlstm")

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30 s audio -> 1500 frames
    attn_bias: bool = False  # q/v/o projection biases (whisper)
    learned_pos_embed: bool = False  # decoder learned positions (whisper)
    max_positions: int = 32768  # learned pos-embed table size

    # --- vlm (pixtral): stub patch embeddings prepended to the sequence ---
    num_patches: int = 0

    # --- norms / embeddings ---
    embed_scale: float = 1.0  # sqrt(d_model) for gemma/grok-style models
    moe_group_size: int = 1024  # tokens per routing group (capacity locality)
    moe_capacity_factor: float = 1.25
    norm_eps: float = 1e-6
    norm_style: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    post_attn_norm: bool = False  # extra sandwich norms (grok style)

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- compile/perf knobs (hillclimbed in EXPERIMENTS.md section Perf) ---
    remat_policy: str = "full"  # none | full | dots
    scan_layers: bool = True
    remat_segments: int = 0  # >0: two-level (sqrt) remat — scan G segments
    #   of K layers with the segment checkpointed; bounds the saved residual
    #   stack at G carries instead of L (kills the L x (B,S,d) f32 hoist)
    use_pallas: bool = False  # kept as data: no model reads it, and the
    #   port's attention takes the CUDA kernel on every CUDA tensor
    seq_shard_norm: bool = False  # sequence-parallel norms (perf pass)
    fsdp_params: bool = True  # shard params over the data axis (ZeRO-3)
    grad_compression: str = "none"  # none | int8_cross_pod
    microbatches: int = 1  # gradient-accumulation steps per train_step
    unroll_microbatches: bool = False  # python-loop accumulation: avoids
    #   the while-carry double buffer of the full gradient tree
    opt_moment_dtype: str = "float32"  # bf16 for models that only fit
    #   256 chips with low-precision moments (grok-1: 314B x 10B > 4TB)
    grad_accum_dtype: str = "float32"
    pad_heads_to: int = 0  # pad q-heads to a multiple (0 = off); padded
    #   heads are zero-masked so the math is EXACTLY the unpadded model —
    #   this buys even 16-way TP sharding for head counts like 40 or 24.
    decode_cache_seq_shard: bool = True  # grid-brick KV cache: shard the
    #   cache sequence dim over the model axis and merge partial softmax
    #   stats (the paper's split->local-compute->merge, applied to KV)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded so the embedding shards evenly over 16-way TP and
        lands on MXU-friendly multiples of 128 (lcm(128, 16) -> use 256)."""
        return pad_to_multiple(self.vocab_size, 256)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    @property
    def num_heads_padded(self) -> int:
        if self.pad_heads_to and self.num_heads % self.pad_heads_to:
            return pad_to_multiple(self.num_heads, self.pad_heads_to)
        return self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and not any(
            b == "attn" for b in self.xlstm_pattern
        )

    @property
    def supports_long_context(self) -> bool:
        """True when decode state is sub-quadratic in context (O(1) recurrent
        state and/or window-bounded KV): required for the long_500k cell."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None or self.attention_window is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment table."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
