"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 — attention logit softcap 30, sandwich
norms, sqrt(d) embedding scale.  [hf:xai-org/grok-1; unverified]"""
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_experts_per_tok=2,
    moe_sharding="tp",  # 8 experts don't divide 16-way TP: shard d_ff
    #                     (expert compute stays brick-local, GEPS-style)
    rope_style="neox",
    rope_theta=10_000.0,
    attn_logit_softcap=30.0,
    post_attn_norm=True,  # grok sandwich norms
    mlp_style="swiglu",
    norm_style="rmsnorm",
    norm_eps=1e-5,
    embed_scale=math.sqrt(6144.0),
    microbatches=16,
    remat_segments=8,  # sqrt remat: 8 segments x 8 layers
    moe_group_size=1024,
    opt_moment_dtype="bfloat16",
    grad_accum_dtype="bfloat16",  # f32 accumulator tree would add 2x4.9 GB
    # NOTE: 314B x 10B/param would exceed the pod 4TB HBM; bf16 moments
    # bring params+opt to 6B/param = 1.9 TB (documented in DESIGN.md)
)
