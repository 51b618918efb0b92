"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (partial rotary on half the head dim), GQA.
[arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",  # GLM 2D/partial rotary: first half of head dim
    rope_theta=10_000.0,
    mlp_style="swiglu",
    norm_style="rmsnorm",
    norm_eps=1e-5,
    microbatches=4,
)
