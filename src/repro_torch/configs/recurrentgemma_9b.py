"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427 (Griffin); unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,  # 12 x (rec, rec, attn) + (rec, rec)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope_style="neox",
    rope_theta=10_000.0,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    attention_window=2048,  # local attention -> O(window) decode state
    conv1d_width=4,
    mlp_style="geglu",
    norm_style="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=True,
    embed_scale=64.0,  # sqrt(d_model), gemma convention
    microbatches=8,
)
