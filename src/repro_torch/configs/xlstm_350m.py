"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks at 7:1 (xLSTM[7:1]); O(1) recurrent decode state.
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,  # 3 x (7 mLSTM + 1 sLSTM)
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,  # no standard FFN: mLSTM blocks carry the up-projection
    vocab_size=50304,
    xlstm_pattern=("mlstm",) * 7 + ("slstm",),
    conv1d_width=4,
    rope_style="none",
    norm_style="rmsnorm",
    norm_eps=1e-6,
    microbatches=4,  # 19.7 -> 5.1 GB temp (sequential cells are state-heavy)
)
