"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    num_experts_per_tok=2,
    moe_sharding="ep",  # 16 experts == 16-way model axis: 1 expert/chip
    rope_style="neox",
    rope_theta=10_000.0,
    mlp_style="swiglu",
    norm_style="layernorm",
    norm_eps=1e-5,
    attn_bias=False,
    microbatches=8,
    moe_group_size=1024,
)
