"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — encoder-decoder, conv frontend STUBBED (input_specs supplies
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,  # full MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq_len=1500,  # 30 s audio -> 1500 frames after the conv stub
    rope_style="none",
    learned_pos_embed=True,
    max_positions=32768,  # decode_32k cell needs learned positions to 32k
    mlp_style="gelu",
    norm_style="layernorm",
    norm_eps=1e-5,
    attn_bias=True,
    microbatches=2,
)
