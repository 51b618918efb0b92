"""chip_smoke.py's predictions for each LM path, on the CPU: the exact
flash_attention launch counts it asserts (by device kernel, counted from
each model's layer pattern and the plan each call takes), the attention
bound it reports for non-causal calls, and the rule that decides whether
a path's end-to-end logits are gated."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402

STEPS = chip_smoke.LM_PROMPT + chip_smoke.LM_NEW


def _cfg(arch):
    cfg = get_config(arch)
    if arch in chip_smoke.LM_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=chip_smoke.LM_LAYERS[arch])
    return cfg


@pytest.mark.parametrize("arch,serve,forward", [
    ("qwen3-14b", {"decode": 960}, {"wgmma": 40}),
    ("pixtral-12b", {"decode": 960}, {"wgmma": 40}),
    ("phi3.5-moe-42b-a6.6b", {"decode": 384}, {"wgmma": 16}),
    # the encoder fills the cross cache, then each decoder layer's self-
    # and cross-attention at every step; the forward: encoder + 2 x 24
    ("whisper-medium", {"wgmma": 24, "decode": 1152}, {"wgmma": 72}),
])
def test_path_launches(arch, serve, forward):
    gen, fwd = chip_smoke.path_launches(_cfg(arch))
    for want, got in ((serve, gen), (forward, fwd)):
        assert got["flash_attention"] == sum(want.values())
        assert {v: got[f"flash_attention.{v}"] for v in fa_kernel.VARIANTS} \
            == {v: want.get(v, 0) for v in fa_kernel.VARIANTS}


@pytest.mark.parametrize("arch", ["pixtral-12b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-medium"])
def test_each_call_of_the_new_paths_takes_the_counted_kernel(arch):
    """The plan of every attention call shape on the path gives the
    kernel path_launches counts: the decode steps' calls (up to the
    24-slot prefix of the ring) on ``decode``, the forward's and the
    encoder's on ``wgmma``."""
    cfg = _cfg(arch)
    h, kh, d = cfg.num_heads_padded, cfg.num_kv_heads, cfg.head_dim
    b, dt = chip_smoke.LM_BATCH, torch.bfloat16
    for n in range(1, STEPS + 1):
        assert fa_kernel.plan(b, 1, n, h, kh, d, dt).variant == "decode"
    length = chip_smoke.FORWARD_LEN[arch]
    assert fa_kernel.plan(1, length, length, h, kh, d, dt).variant == "wgmma"
    if cfg.is_encoder_decoder:
        se = cfg.encoder_seq_len
        assert fa_kernel.plan(b, se, se, h, kh, d, dt, False).variant == \
            "wgmma"
        cross = fa_kernel.plan(b, 1, se, h, kh, d, dt, False)
        assert (cross.variant, len(cross.splits)) == ("decode", 4)
        assert fa_kernel.plan(1, length, se, h, kh, d, dt, False).variant \
            == "wgmma"


def test_whisper_plans_match_the_phase_3_rows():
    for name, b, sq, sk, h, kh, d, dt, kw in chip_smoke.WHISPER_FA_CASES:
        pl = fa_kernel.plan(b, sq, sk, h, kh, d, dt, kw["causal"])
        assert (pl.variant, len(pl.splits)) == \
            chip_smoke.WHISPER_FA_PLANS[name]
    # the cross-attention decode's last split is ragged: 1500 = 23 x 64 + 28
    pl = fa_kernel.plan(2, 1, 1500, 16, 16, 64, torch.bfloat16, False)
    assert pl.splits[-1][1] == 1500 and (1500 - pl.splits[-1][0]) % 64 == 28


def test_attention_bound_counts_every_key_when_not_causal():
    b, sq, sk, h, kh, d = 2, 1500, 1500, 16, 16, 64
    ms, by = chip_smoke.fa_bound_ms(b, sq, sk, h, kh, d, 2, causal=False)
    assert by == "operations"
    assert ms == pytest.approx(4 * b * h * sq * sk * d /
                               chip_smoke.BF16_FLOPS_PER_S * 1e3)
    causal, _ = chip_smoke.fa_bound_ms(b, sq, sk, h, kh, d, 2)
    assert causal == pytest.approx(ms * (sk + 1) / (2 * sk))
    ms, by = chip_smoke.fa_bound_ms(2, 1, 1500, 16, 16, 64, 2, causal=False)
    assert by == "bytes"
    assert ms == pytest.approx(2 * (2 * 2 * 16 * 64 + 2 * 2 * 1500 * 16 * 64)
                               / chip_smoke.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("arch,base,top1,gated", [
    ("qwen3-14b", 0.9, 0.0, True),              # always gated
    ("recurrentgemma-9b", 0.0, 1.0, False),     # never: chaotic (C-ref5)
    ("pixtral-12b", 0.01, 0.95, True),          # its plain runs agree
    ("pixtral-12b", 0.49, 0.23, False),         # they do not
    ("whisper-medium", 0.01, 0.5, False),       # top-1 below LM_TOP1_MIN
])
def test_end_to_end_gate_follows_the_plain_baseline(arch, base, top1, gated):
    cmp = {"plain_vs_plain_f32": {"max_rel_logit_diff": base,
                                  "top1_agreement": top1}}
    assert chip_smoke.e2e_gated(get_config(arch), cmp) is gated


def test_train_launch_counts():
    """starcoder2-3b's train phase: 30 layers x 4 microbatches x 3 steps,
    each layer's forward twice (the step's and remat "full"'s recompute
    in the backward), all on the tensor-core kernel, and the backward
    once: 720 forward and 360 backward launches."""
    cfg = get_config(chip_smoke.TRAIN_ARCH)
    assert (cfg.num_layers, cfg.microbatches, cfg.remat_policy) == \
        (30, 4, "full")
    got = chip_smoke.train_launches(cfg, chip_smoke.TRAIN_STEPS)
    assert got["flash_attention"] == 30 * 4 * 3 * 2 == 720
    assert got["flash_attention.wgmma"] == 720
    assert got["flash_attention_bwd"] == 30 * 4 * 3 == 360
    assert got["rglru_scan"] == got["mlstm"] == 0
    # each forward call of a microbatch (2 rows of 2048) takes wgmma
    mb = chip_smoke.TRAIN_BATCH // cfg.microbatches
    seq = chip_smoke.TRAIN_SEQ
    pl = fa_kernel.plan(mb, seq, seq, cfg.num_heads_padded,
                        cfg.num_kv_heads, cfg.head_dim, torch.bfloat16,
                        True, cfg.sliding_window)
    assert (mb, pl.variant) == (2, "wgmma")


def test_backward_bound_counts_ten_flops_a_valid_pair():
    """10 * B * H * pairs * D at 989 TFLOP/s: about 0.174 ms at starcoder2's
    (2, 2048^2, 32, 128) causal; its 4096 window masks nothing there."""
    ms, by = chip_smoke.fa_bwd_bound_ms(2, 2048, 2048, 32, 2, 128, 2, 4096)
    pairs = 2048 * 2049 // 2
    assert by == "operations"
    assert ms == pytest.approx(10 * 2 * 32 * pairs * 128 /
                               chip_smoke.BF16_FLOPS_PER_S * 1e3)
    assert ms == pytest.approx(0.174, abs=5e-4)
    assert chip_smoke.fa_bwd_bound_ms(2, 2048, 2048, 32, 2, 128, 2)[0] == ms
