"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, sliding-window 4096, layernorm + biases,
plain-GELU MLP.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_style="neox",
    rope_theta=100_000.0,
    sliding_window=4096,  # arXiv:2402.19173 section 2: 4096-token window ->
    #                       window-bounded KV makes long_500k decode feasible
    mlp_style="gelu",
    norm_style="layernorm",
    norm_eps=1e-5,
    attn_bias=True,
    pad_heads_to=16,  # 24 heads -> 32 zero-masked for even 16-way TP
    microbatches=4,
)
