"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT frontend STUBBED (input_specs supplies
precomputed patch embeddings), mistral-nemo decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    num_patches=256,  # stub ViT: 256 precomputed patch embeddings / sample
    rope_style="neox",
    rope_theta=1_000_000.0,
    mlp_style="swiglu",
    norm_style="rmsnorm",
    norm_eps=1e-5,
    microbatches=8,
)
