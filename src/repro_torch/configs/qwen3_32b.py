"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_style="neox",
    rope_theta=1_000_000.0,
    mlp_style="swiglu",
    norm_style="rmsnorm",
    norm_eps=1e-6,
    microbatches=8,
    remat_segments=8,  # sqrt remat over 64 layers: 18.1 -> 8.2 GB temp
)
