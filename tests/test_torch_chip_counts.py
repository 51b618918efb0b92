"""chip_smoke.py's predictions for each LM path, on the CPU: the exact
flash_attention launch counts it asserts (by device kernel, counted from
each model's layer pattern and the plan each call takes), the attention
bound it reports for non-causal calls (``analysis/roofline.py``'s work
counts), and the rule that decides whether a path's end-to-end logits
are gated."""
import dataclasses
import itertools
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    bound_ms as bound, flash_attention_bwd_work, flash_attention_work,
    mlstm_bwd_work, rglru_scan_bwd_work)
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
    # chatglm3-6b's and qwen3-32b's every layer, grok-1's 4 of 64
    ("chatglm3-6b", {"decode": 28 * 24}, {"wgmma": 28}),
    ("qwen3-32b", {"decode": 64 * 24}, {"wgmma": 64}),
    ("grok-1-314b", {"decode": 4 * 24}, {"wgmma": 4}),
])
def test_path_launches(arch, serve, forward):
    gen, fwd = chip_smoke.path_launches(_cfg(arch))
    for want, got in ((serve, gen), (forward, fwd)):
        assert got["flash_attention"] == sum(want.values())
        assert {v: got[f"flash_attention.{v}"] for v in fa_kernel.VARIANTS} \
            == {v: want.get(v, 0) for v in fa_kernel.VARIANTS}


@pytest.mark.parametrize("arch", ["pixtral-12b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-medium", "chatglm3-6b",
                                  "qwen3-32b", "grok-1-314b"])
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


def _count_attention(monkeypatch):
    """Calls of ``transformer.flash_attention`` (every attention call of
    the dense, moe, vlm and audio models goes through it), counted."""
    from repro_torch.models import transformer
    calls = []
    kernel = transformer.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw.get("causal", True)))
        return kernel(q, k, v, **kw)

    monkeypatch.setattr(transformer, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen3-32b", "grok-1-314b",
                                  "qwen3-14b", "pixtral-12b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_path_launches_equal_the_reduced_models_calls(monkeypatch, arch):
    """``path_launches`` counted from a model's pattern against the
    attention calls its reduced model makes on the CPU on chip_smoke's
    paths: ``generate`` (LM_BATCH prompts of LM_PROMPT, LM_NEW new tokens)
    and one forward of FORWARD_LEN tokens (pixtral's first positions its
    stub patch embeddings).  Reduced grok-1 keeps 4 layers, its depth on
    the card."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model_zoo
    cfg = reduced_config(arch)
    if arch in chip_smoke.LM_LAYERS:
        assert cfg.num_layers == min(4, chip_smoke.LM_LAYERS[arch])
    model = model_zoo.build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.table.init(gen, "cpu")
    want_gen, want_fwd = chip_smoke.path_launches(cfg)
    calls = _count_attention(monkeypatch)
    prompt = torch.randint(0, cfg.vocab_size,
                           (chip_smoke.LM_BATCH, chip_smoke.LM_PROMPT),
                           generator=gen)
    with torch.inference_mode():
        toks = generate(cfg, model, params, prompt,
                        max_new_tokens=chip_smoke.LM_NEW)
        assert toks.shape == (chip_smoke.LM_BATCH, chip_smoke.LM_NEW)
        assert len(calls) == want_gen["flash_attention"] == \
            want_gen["flash_attention.decode"]
        assert all(q[1] == 1 for q, _, _ in calls)
        del calls[:]
        length = chip_smoke.FORWARD_LEN[arch]
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, length),
                                         generator=gen)}
        if cfg.num_patches:
            batch["patch_embeds"] = torch.randn(
                (1, cfg.num_patches, cfg.d_model), generator=gen)
        logits, aux = model.forward(params, batch)
    assert logits.shape[:2] == (1, length) and bool(torch.isfinite(aux))
    assert len(calls) == want_fwd["flash_attention"] == \
        want_fwd["flash_attention.wgmma"]
    assert all(q[1] == length for q, _, _ in calls)


def test_chatglm_decode_fills_the_decode_rows():
    """chatglm3-6b's 32 q heads over 2 kv heads: G = 16 rows a kv head at
    Sq 1, DECODE_ROWS exactly.  Every call of chip_smoke's generate (up to
    LM_PROMPT + LM_NEW = 24 keys, one tile) is one split of the decode
    kernel; over the card test's 2048-key ring (32 tiles) B * K = 4 blocks
    split 32 ways, within one wave of 132 SMs."""
    cfg = get_config("chatglm3-6b")
    h, kh, d = cfg.num_heads_padded, cfg.num_kv_heads, cfg.head_dim
    assert (h // kh, d) == (fa_kernel.DECODE_ROWS, 128)
    for n in range(1, STEPS + 1):
        pl = fa_kernel.plan(chip_smoke.LM_BATCH, 1, n, h, kh, d,
                            torch.bfloat16)
        assert (pl.variant, pl.splits) == ("decode", ((0, n),))
    pl = fa_kernel.plan(2, 1, 2048, h, kh, d, torch.bfloat16)
    assert pl.variant == "decode" and len(pl.splits) == 32
    assert 2 * kh * len(pl.splits) <= fa_kernel.H100_SMS
    # two rows a query head more, and the call takes the prefill kernel
    assert fa_kernel.plan(2, 2, 24, h, kh, d, torch.bfloat16).variant == \
        "wgmma"


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
    ms, by = bound(flash_attention_work(b, sq, sk, h, kh, d, causal=False))
    assert by == "operations"
    assert ms == pytest.approx(4 * b * h * sq * sk * d /
                               chip_smoke.BF16_FLOPS_PER_S * 1e3)
    causal, _ = bound(flash_attention_work(b, sq, sk, h, kh, d))
    assert causal == pytest.approx(ms * (sk + 1) / (2 * sk))
    ms, by = bound(flash_attention_work(2, 1, 1500, 16, 16, 64,
                                        causal=False))
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


@pytest.mark.parametrize("arch,want", [
    # no remat (the encoder-decoder checkpoints nothing): (24 encoder + 2 x
    # 24 decoder) attention calls x 2 microbatches x 2 steps, forward and
    # backward once each
    ("whisper-medium", {"flash_attention": 288, "flash_attention_bwd": 288}),
    # 8 layers x 8 microbatches x 2 steps, the forward twice (remat)
    ("pixtral-12b", {"flash_attention": 256, "flash_attention_bwd": 128}),
    # 2 layers x 8 microbatches x 2 steps
    ("phi3.5-moe-42b-a6.6b", {"flash_attention": 64,
                              "flash_attention_bwd": 32}),
    # 1 layer x 16 microbatches x 2 steps, no remat segment in one layer
    ("grok-1-314b", {"flash_attention": 64, "flash_attention_bwd": 32}),
    # 4 layers in 2 remat segments: 3 x 4 - 2 = 10 forwards a microbatch,
    # x 8 microbatches x 2 steps
    ("qwen3-32b", {"flash_attention": 160, "flash_attention_bwd": 64}),
    # 8 layers x 8 microbatches x 2 steps, the forward twice (remat)
    ("qwen3-14b", {"flash_attention": 256, "flash_attention_bwd": 128}),
    # 18 layers x 4 microbatches x 2 steps
    ("chatglm3-6b", {"flash_attention": 288, "flash_attention_bwd": 144}),
])
def test_new_family_train_launch_counts(arch, want):
    """The moe, vlm and audio families' train phase: depth, batch, tokens
    and steps as cut in TRAIN_ARCHS, every forward on the tensor-core
    kernel (with lse) and every backward on the tensor-core backward at
    each microbatch's shapes."""
    from repro_torch.kernels.flash_attention import backward as fa_bwd
    cfg = chip_smoke.train_config(arch)
    spec = chip_smoke.TRAIN_ARCHS[arch]
    got = chip_smoke.train_launches(cfg, spec["steps"])
    assert (spec["batch"], spec["steps"]) == \
        ((16, 2) if arch == "grok-1-314b" else (8, 2))
    for key, n in want.items():
        assert got[key] == n, key
    assert got["flash_attention.wgmma"] == want["flash_attention"]
    assert got["flash_attention_bwd.wgmma"] == want["flash_attention_bwd"]
    assert got["flash_attention_bwd.simt"] == got["rglru_scan"] == \
        got["mlstm"] == 0
    mb = spec["batch"] // cfg.microbatches
    seq = spec.get("seq", chip_smoke.TRAIN_SEQ)
    h, kh, d = cfg.num_heads_padded, cfg.num_kv_heads, cfg.head_dim
    shapes = [(seq, seq, True)]
    if cfg.is_encoder_decoder:
        se = cfg.encoder_seq_len
        shapes += [(se, se, False), (seq, se, False)]
    for sq, sk, causal in shapes:
        args = (mb, sq, sk, h, kh, d, torch.bfloat16)
        assert fa_kernel.plan(*args, causal, with_lse=True).variant == \
            "wgmma"
        assert fa_bwd.plan(*args).variant == "wgmma"
    assert (mb, seq, cfg.num_layers, cfg.remat_segments) == \
        {"whisper-medium": (4, 448, 24, 0), "pixtral-12b": (1, 2048, 8, 0),
         "phi3.5-moe-42b-a6.6b": (1, 2048, 2, 0),
         "grok-1-314b": (1, 2048, 1, 0), "qwen3-32b": (1, 2048, 4, 2),
         "qwen3-14b": (1, 2048, 8, 0), "chatglm3-6b": (2, 2048, 18, 0)}[arch]
    # the backward's plans: qwen3-14b's 48/8 heads as grok-1's capped
    # shape (2 runs of 3 heads), chatglm3-6b's 32/2 as starcoder2-3b's
    # (4 runs of 4 heads)
    if arch == "qwen3-14b":
        assert fa_bwd.plan(mb, seq, seq, h, kh, d, torch.bfloat16) == \
            fa_bwd.Plan("wgmma", 2) == fa_bwd.plan(
                *next(c[1:8] for c in chip_smoke.BWD_CASES
                      if c[0] == "grok-1 train"))
    if arch == "chatglm3-6b":
        tr = get_config(chip_smoke.TRAIN_ARCH)
        assert fa_bwd.plan(mb, seq, seq, h, kh, d, torch.bfloat16) == \
            fa_bwd.Plan("wgmma", 4) == fa_bwd.plan(
                2, seq, seq, tr.num_heads_padded, tr.num_kv_heads,
                tr.head_dim, torch.bfloat16)
        assert tr.sliding_window >= seq and cfg.rope_style == "half"
    if arch == "grok-1-314b":
        assert fa_bwd.plan(mb, seq, seq, h, kh, d, torch.bfloat16) == \
            fa_bwd.plan(*next(c[1:8] for c in chip_smoke.BWD_CASES
                              if c[0] == "grok-1 train"))
        assert cfg.attn_logit_softcap == chip_smoke.GROK_CAP


@pytest.mark.parametrize("arch", ["whisper-medium", "pixtral-12b",
                                  "phi3.5-moe-42b-a6.6b", "starcoder2-3b",
                                  "grok-1-314b", "qwen3-32b", "qwen3-14b",
                                  "chatglm3-6b"])
def test_train_launches_equal_the_reduced_models_calls(monkeypatch, arch):
    """``train_launches`` against the attention calls one step of the
    reduced model makes on the CPU (two microbatches of 2 x 128 tokens,
    with the family's stub inputs): with remat "full" every checkpointed
    forward runs again in the backward, so the forward's calls are the
    flash launches; with remat "none" they are the backward's (one a
    forward call).  grok-1 and qwen3-32b keep the reduced config's 2
    remat segments of 2 layers: each segment's recompute stops before
    its last layer, so "full" makes 3 x 4 - 2 = 10 calls a microbatch,
    and "none" 2 x 4 (the segments' recompute runs every layer); with
    no segment, 8 and 4."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.train import steps as steps_lib
    gen = torch.Generator().manual_seed(0)
    segments = (0, 2) if arch in ("grok-1-314b", "qwen3-32b") else (0,)
    for policy, g in itertools.product(("full", "none"), segments):
        cfg = reduced_config(arch, microbatches=2, remat_policy=policy,
                             remat_segments=g)
        model = model_zoo.build_model(cfg)
        params = model.table.init(gen, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
        batch = {"tokens": toks, "labels": toks}
        if cfg.num_patches:
            batch["patch_embeds"] = torch.randn(
                (4, cfg.num_patches, cfg.d_model), generator=gen)
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn(
                (4, cfg.encoder_seq_len, cfg.d_model), generator=gen)
        calls = _count_attention(monkeypatch)
        _, total, _ = steps_lib.make_grads_fn(cfg, model)(params, batch)
        assert bool(torch.isfinite(total))
        want = chip_smoke.train_launches(cfg, 1)
        assert len(calls) == want["flash_attention"], (policy, g, len(calls),
                                                       want)
        n = 1 if cfg.is_encoder_decoder else cfg.num_layers
        per_mb = {("none", 0): 1, ("full", 0): 2}.get((policy, g), 0) * n
        if g:
            per_mb = 3 * n - g if policy == "full" else 2 * n
        if cfg.is_encoder_decoder:
            per_mb = want["flash_attention_bwd"] // 2
        assert len(calls) == 2 * per_mb
        if (policy, g) == ("none", 0):
            assert len(calls) == want["flash_attention_bwd"]
        monkeypatch.undo()


def test_backward_bound_counts_ten_flops_a_valid_pair():
    """10 * B * H * pairs * D at 989 TFLOP/s: about 0.174 ms at starcoder2's
    (2, 2048^2, 32, 128) causal; its 4096 window masks nothing there."""
    ms, by = bound(flash_attention_bwd_work(2, 2048, 2048, 32, 2, 128,
                                            window=4096))
    pairs = 2048 * 2049 // 2
    assert by == "operations"
    assert ms == pytest.approx(10 * 2 * 32 * pairs * 128 /
                               chip_smoke.BF16_FLOPS_PER_S * 1e3)
    assert ms == pytest.approx(0.174, abs=5e-4)
    assert bound(flash_attention_bwd_work(2, 2048, 2048, 32, 2, 128))[0] \
        == ms


def test_backward_bound_at_recurrentgemma_training_shape():
    """recurrentgemma-9b's microbatch (1, 2048^2, 16 heads of 256), its
    2048 window masking nothing: about 0.0869 ms at 989 TFLOP/s in bf16;
    the CUDA-core variant's f32 row is bound at 67 TFLOP/s."""
    ms, by = bound(flash_attention_bwd_work(1, 2048, 2048, 16, 1, 256,
                                            window=2048))
    pairs = 2048 * 2049 // 2
    assert by == "operations"
    assert ms == pytest.approx(10 * 16 * pairs * 256 /
                               chip_smoke.BF16_FLOPS_PER_S * 1e3)
    assert ms == pytest.approx(0.0869, abs=5e-5)
    f32, by32 = bound(flash_attention_bwd_work(
        1, 2048, 2048, 16, 1, 256, "float32", window=2048))
    assert by32 == "operations"
    assert f32 == pytest.approx(ms * chip_smoke.BF16_FLOPS_PER_S /
                                chip_smoke.FP32_FLOPS_PER_S)


@pytest.mark.parametrize("arch,want", [
    # 5 units of (rec, rec, attn) x 8 microbatches x 3 steps, remat "full"
    # of each unit: 240 flash forwards (the recompute doubles them) and
    # 120 backwards (head dim 256), all on the tensor cores, 480 RG-LRU
    # scans and 240 backwards
    ("recurrentgemma-9b", {"flash_attention": 240,
                           "flash_attention.wgmma": 240,
                           "flash_attention_bwd": 120,
                           "flash_attention_bwd.simt": 0,
                           "flash_attention_bwd.wgmma": 120,
                           "rglru_scan": 480, "rglru_scan_bwd": 240,
                           "mlstm": 0, "mlstm_bwd": 0,
                           "mlstm_bwd.wgmma": 0, "mlstm_bwd.simt": 0}),
    # one super-block's 7 mLSTM layers x 1 microbatch x 1 step, remat
    # "full" of the super-block: 14 forwards, 7 backwards, all on the
    # tensor cores (bf16 at head dim 512)
    ("xlstm-350m", {"flash_attention": 0, "flash_attention_bwd": 0,
                    "rglru_scan": 0, "rglru_scan_bwd": 0, "mlstm": 14,
                    "mlstm.wgmma": 14, "mlstm_bwd": 7,
                    "mlstm_bwd.wgmma": 7, "mlstm_bwd.simt": 0}),
])
def test_recurrent_train_launch_counts(arch, want):
    """The recurrent models' train phase: depth, batch and steps as cut in
    TRAIN_ARCHS, each backward kernel once a layer and microbatch, each
    forward twice (remat "full" of the super-blocks); every microbatch's
    calls take the counted variants."""
    cfg = chip_smoke.train_config(arch)
    spec = chip_smoke.TRAIN_ARCHS[arch]
    got = chip_smoke.train_launches(cfg, spec["steps"])
    for key, n in want.items():
        assert got[key] == n, key
    mb = spec["batch"] // cfg.microbatches
    seq = chip_smoke.TRAIN_SEQ
    assert cfg.remat_policy == "full"
    if arch == "recurrentgemma-9b":
        assert (cfg.num_layers, mb) == (15, 1)
        from repro_torch.kernels.flash_attention import backward as fa_bwd
        args = (mb, seq, seq, cfg.num_heads_padded, cfg.num_kv_heads,
                cfg.head_dim, torch.bfloat16)
        assert fa_kernel.plan(*args, True, cfg.attention_window,
                              with_lse=True).variant == "wgmma"
        # 32 key blocks of 64: 8 runs of 2 heads give 256 blocks
        assert fa_bwd.plan(*args) == fa_bwd.Plan("wgmma", 8)
    else:
        from repro_torch.kernels.mlstm_scan import backward as ml_backward
        from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
        assert (cfg.num_layers, mb) == (8, 2)
        assert ml_kernel.plan(mb, seq, 4, 512,
                              torch.bfloat16).variant == "wgmma"
        assert ml_backward.plan(mb, seq, 4, 512, torch.bfloat16) == "wgmma"


def test_scan_backward_bounds():
    """The B4 backward moves 20 bytes an element (a, dy, h in; db, da
    out): 0.050 ms at (1, 2048, 4096) at 3.35 TB/s; the B5 backward does
    10 flops a valid pair and head dim: ~0.087 ms at (2, 2048, 4, 512) at
    989 TFLOP/s."""
    ms, by = bound(rglru_scan_bwd_work(1, 2048, 4096))
    assert by == "bytes"
    assert ms == pytest.approx(20 * 2048 * 4096 /
                               chip_smoke.HBM_BYTES_PER_S * 1e3)
    ms, by = bound(mlstm_bwd_work(2, 2048, 4, 512))
    assert by == "operations"
    assert ms == pytest.approx(0.0869, abs=2e-4)


@pytest.mark.parametrize("arch,full,none", [
    # one (rec, rec, attn) unit: the attention and the two scans
    ("recurrentgemma-9b", {"flash_attention": 2, "rglru_scan": 4},
     {"flash_attention": 1, "rglru_scan": 2}),
    # one 8-layer super-block: 7 mLSTMs
    ("xlstm-350m", {"mlstm": 14}, {"mlstm": 7}),
    # the train cell's 4 layers, "full" in 2 segments: 3 x 4 - 2
    ("qwen3-32b", {"flash_attention": 10}, {"flash_attention": 4}),
    # 2 layers, "full" and "dots" each: B3's forward is no product "dots"
    # keeps, so it is recomputed
    ("qwen3-14b", {"flash_attention": 4}, {"flash_attention": 2}),
])
def test_remat_check_launch_counts(arch, full, none):
    """The remat check's step 1 on one super-block (qwen3-32b: its train
    cell's layers; qwen3-14b: 2 layers) and one microbatch: "full" and
    "dots" run each forward kernel twice (three times in two-level remat
    but the last layer's of each segment), "none" once; the backwards
    once either way.  The hybrid unit has no tail."""
    spec = chip_smoke.REMAT_CHECK[arch]
    policies = spec.get("policies", ("full",))
    assert policies == (("full", "dots") if arch == "qwen3-14b"
                        else ("full",))
    for policy, want in [(p, full) for p in policies] + [("none", none)]:
        cfg = chip_smoke.remat_check_config(arch, policy)
        assert (cfg.num_layers, cfg.microbatches) == (spec["layers"], 1)
        assert cfg.remat_segments == (spec.get("remat_segments", 0)
                                      if policy == "full" else 0)
        got = chip_smoke.train_launches(cfg, 1)
        for key, n in want.items():
            assert got[key] == n, (policy, key)
        assert got["rglru_scan_bwd"] == none.get("rglru_scan", 0)
        assert got["mlstm_bwd"] == none.get("mlstm", 0)
        assert got["flash_attention_bwd"] == none.get("flash_attention", 0)


def test_brick_phase_takes_the_brick_path_at_qwen3_14b():
    """The brick phase's (1, 4) mesh cuts qwen3-14b's unwindowed cache of
    8192 slots into 4 bricks (``brick_active``), the (1, 1) mesh does not;
    the fill leaves every brick live and the steps write the last brick,
    then wrap into brick 0; and the (1, 1) decode's flash calls over the
    prefixes of 8190 to 8192 slots take the decode kernel: 40 x 6 = 240
    launches."""
    from repro_torch.core.brick_attention import brick_active
    from repro_torch.launch.mesh import make_mesh_of
    from repro_torch.parallel.sharding import Sharder
    cfg = get_config(chip_smoke.LM_ARCH)
    assert cfg.num_layers == 40 and not (cfg.sliding_window or
                                         cfg.attention_window)

    def shd(shape):
        return Sharder(cfg, make_mesh_of(shape, ("data", "model"),
                                         device="cpu",
                                         emulate=shape != (1, 1)))
    assert brick_active(cfg, shd(chip_smoke.BRICK_MESH),
                        chip_smoke.BRICK_CACHE)
    assert shd(chip_smoke.BRICK_MESH).tensor_size == 4
    assert not brick_active(cfg, shd((1, 1)), chip_smoke.BRICK_CACHE)
    w, fill, steps = (chip_smoke.BRICK_CACHE, chip_smoke.BRICK_FILL,
                      chip_smoke.BRICK_STEPS)
    brick = w // 4
    assert fill > 3 * brick and fill < w < fill + steps
    slots = [(fill + s) % w for s in range(steps)]
    assert {sl // brick for sl in slots} == {0, 3}
    want = chip_smoke.lm_launches(decode=40 * steps)
    assert want["flash_attention"] == want["flash_attention.decode"] == 240
    for t in range(fill, fill + steps + 1):
        assert fa_kernel.plan(chip_smoke.LM_BATCH, 1, min(t + 1, w),
                              cfg.num_heads_padded, cfg.num_kv_heads,
                              cfg.head_dim, torch.bfloat16).variant == \
            "decode"


@pytest.mark.parametrize("arch,fill,w", [("qwen3-14b", 11, 16),
                                         ("qwen3-32b", 16, 16)])
def test_fill_ring_gives_the_token_by_token_cache(arch, fill, w):
    """``chip_smoke.fill_ring`` (one batched forward) leaves reduced f32
    caches as ``prefill_into_cache`` (one decode step a token) does: k/v
    within 1e-5 of their largest magnitude (readings ~1e-7: the batched
    and the one-token products round differently), kpos and t equal; and
    a decode step from either gives logits within 1e-5 of their
    spread."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import model_zoo
    cfg = reduced_config(arch, dtype="float32", param_dtype="float32")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, fill + 1),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got = chip_smoke.fill_ring(cfg, params, toks[:, :fill],
                                   model.init_cache(2, w, "cpu"))
        _, want = prefill_into_cache(cfg, model, params,
                                     model.init_cache(2, w, "cpu"),
                                     toks[:, :fill])
        assert got["t"] == want["t"] == fill
        assert torch.equal(got["kpos"], want["kpos"])
        for key in ("k", "v"):
            scale = float(want[key].abs().max())
            assert float((got[key] - want[key]).abs().max()) <= 1e-5 * scale
        a, _ = model.decode_step(params, got, toks[:, fill:])
        b, _ = model.decode_step(params, want, toks[:, fill:])
    assert float((a - b).abs().max()) <= 1e-5 * float(b.max() - b.min())
    with pytest.raises(ValueError, match="empty cache"):
        chip_smoke.fill_ring(cfg, params, toks.repeat(1, 2),
                             model.init_cache(2, w, "cpu"))


@pytest.mark.parametrize("arch,microbatches,want", [
    # bf16 param and microbatch grad, f32 moments and sum: 2 + 2 + 8 + 4
    ("starcoder2-3b", None, 16),
    # grok-1's bf16 moments and bf16 sum over its microbatches: 5 x 2
    ("grok-1-314b", None, 10),
    # one microbatch sums into f32 whatever grad_accum_dtype says
    ("grok-1-314b", 1, 12),
    ("xlstm-350m", None, 16),
    # the last two dense cells: f32 moments and sum
    ("qwen3-14b", None, 16),
    ("chatglm3-6b", None, 16),
])
def test_train_state_bytes_follow_the_config(arch, microbatches, want):
    """The train phase's reckoning of its state (``train_state_gb``):
    bytes a param from the config's ``param_dtype``, ``opt_moment_dtype``
    and ``grad_accum_dtype`` (f32 with one microbatch, as
    ``steps.accum_dtype`` gives it).  grok-1's cell: 6.53 B params, 65.3
    GB."""
    cfg = chip_smoke.train_config(arch)
    if microbatches is not None:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    assert chip_smoke.train_state_bytes(cfg) == want
    if (arch, microbatches) == ("grok-1-314b", None):
        assert (cfg.opt_moment_dtype, cfg.grad_accum_dtype,
                cfg.microbatches) == ("bfloat16", "bfloat16", 16)
        from repro_torch.models import model_zoo
        n = model_zoo.build_model(cfg).table.num_params()
        assert n * want / 1e9 == pytest.approx(65.3, abs=0.05)
