"""chip_smoke.py's per-call flash check, on the CPU.

``shadow_kernels()`` holds every flash_attention call of an LM path
against the plain version in f32 (FA_TOL).  Where the scores spread so
wide that the plain version in f32 is itself outside FA_TOL of the exact
(f64) value, the call is held instead against the exact value, element by
element, within FA_TOL plus SENS_KAPPA times the element's sensitivity to
f32 score rounding, with its largest and mean errors no more than
ERR_RATIO times the plain version's.  Here the "kernel" is the plain
version in f32 with the head dim summed in the other order (as correct as
f32 arithmetic allows, and rounded differently): it must pass the check
and still disagree with the plain version in f32, as an evaluation with
no error does; faults a kernel can have must fail it.

The backward's capped rows must see the cap: left out, it moves the
plain dq and dk by more than BWD_TOL (``cap_check``); and the library
call timed beside the capped backward, ``softcap_library``'s
flex_attention, computes the capped attention (its forward here, eager:
flex_attention has no backward on the CPU)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

WINDOW = 300


def reordered(q, k, v, **kw):
    return flash_attention_ref(q.float().flip(-1), k.float().flip(-1),
                               v.float(), **kw).to(q.dtype)


def exact_bf16(q, k, v, **kw):
    return chip_smoke.flash_exact(q, k, v, **kw).to(q.dtype)


FAULTS = {
    "window + 1": lambda q, k, v, **kw: reordered(
        q, k, v, **{**kw, "window": kw["window"] + 1}),
    "window - 1": lambda q, k, v, **kw: reordered(
        q, k, v, **{**kw, "window": kw["window"] - 1}),
    "not causal": lambda q, k, v, **kw: reordered(
        q, k, v, **{**kw, "causal": False}),
    "out + 0.05": lambda q, k, v, **kw: (
        reordered(q, k, v, **kw).float() + 0.05).to(q.dtype),
    "out x 1.03": lambda q, k, v, **kw: (
        reordered(q, k, v, **kw).float() * 1.03).to(q.dtype),
    "one row zero": lambda q, k, v, **kw: reordered(
        q, k, v, **kw).index_fill(1, torch.tensor([400]), 0.0),
}


@pytest.fixture(scope="module")
def operands():
    """Scores spread to |s| ~ 1e3 (as C-ref5 spreads recurrentgemma's):
    the plain version in f32 is outside FA_TOL of the exact value."""
    gen = torch.Generator().manual_seed(0)
    q = (torch.randn((1, 512, 4, 256), generator=gen) * 60).bfloat16()
    k = (torch.randn((1, 512, 1, 256), generator=gen) * 60).bfloat16()
    v = (torch.randn((1, 512, 1, 256), generator=gen) * 300).bfloat16()
    return q, k, v


def shadow(monkeypatch, kernel, operands):
    monkeypatch.setattr(transformer, "flash_attention", kernel)
    q, k, v = operands
    with chip_smoke.shadow_kernels() as tally:
        transformer.flash_attention(q, k, v, causal=True, window=WINDOW,
                                    scale=None, logit_cap=None)
    return tally


@pytest.mark.parametrize("kernel", [reordered, exact_bf16],
                         ids=["f32 reordered", "exact to bf16"])
def test_correct_evaluations_pass_on_ill_conditioned_calls(
        monkeypatch, operands, kernel):
    tally = shadow(monkeypatch, kernel, operands)
    t = tally["flash_attention"]
    assert t["ill_conditioned_calls"] == 1
    assert t["ill_plain_f32_outside_exact"] > 0
    # both disagree with the plain version in f32 beyond FA_TOL somewhere
    assert t["ill_kernel_outside_plain_f32"] > 0
    assert t["outside"] == 0
    chip_smoke.check_calls("cpu", tally)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_kernel_faults_fail_on_ill_conditioned_calls(monkeypatch, operands,
                                                     fault):
    tally = shadow(monkeypatch, FAULTS[fault], operands)
    assert tally["flash_attention"]["ill_conditioned_calls"] == 1
    with pytest.raises(AssertionError):
        chip_smoke.check_calls("cpu", tally)


def test_well_conditioned_calls_keep_the_plain_f32_check(monkeypatch):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 64, 4, 64), generator=gen).bfloat16()
    k = torch.randn((1, 64, 2, 64), generator=gen).bfloat16()
    v = torch.randn((1, 64, 2, 64), generator=gen).bfloat16()
    tally = shadow(monkeypatch, lambda q, k, v, **kw: (
        reordered(q, k, v, **kw).float() + 0.05).to(q.dtype), (q, k, v))
    t = tally["flash_attention"]
    assert t["ill_conditioned_calls"] == 0
    assert t["outside"] > 0


@pytest.mark.parametrize("shift,counted,nearer", [
    (-0.3, 0, 1),    # outside FA_TOL of the plain version, nearer exact
    (-0.9, 1, 0),    # outside it, farther from exact than the plain one
    (2.5, 1, 0),     # farther still, outside FA_TOL of the exact value
    (0.8, 0, 0),     # the plain version's own value
])
def test_well_conditioned_rule_follows_the_exact_value(shift, counted,
                                                      nearer):
    """On a well-conditioned call an element of the kernel outside FA_TOL
    of the plain version in f32 is let through only where the kernel is
    nearer the exact value than the plain version, which is within FA_TOL
    of it (the plain version 0.8 of FA_TOL from the exact value here; the
    kernel ``shift`` FA_TOL from it, 1.1 FA_TOL from the plain version
    at -0.3)."""
    rtol, atol = chip_smoke.FA_TOL[torch.bfloat16]
    exact = torch.tensor([[0.19, -0.5, 2.0]], dtype=torch.float64)
    tol = atol + rtol * exact.abs()
    want = (exact + 0.8 * tol * torch.tensor([[1.0, 0.0, 0.0]])).float()
    out = exact.clone()
    out[0, 0] += shift * tol[0, 0]
    got = chip_smoke.well_conditioned_outside(out.float(), want, exact,
                                              rtol, atol)
    assert got == (counted, nearer)


def test_well_conditioned_calls_count_the_rule_apart(monkeypatch):
    """The tally counts the elements the rule lets through apart, and a
    kernel equal to the plain version gives none; it keeps the kernel's
    largest error against the exact value, within FA_TOL there."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 64, 4, 64), generator=gen).bfloat16()
    k = torch.randn((1, 64, 2, 64), generator=gen).bfloat16()
    v = torch.randn((1, 64, 2, 64), generator=gen).bfloat16()
    tally = shadow(monkeypatch, lambda q, k, v, **kw: flash_attention_ref(
        q.float(), k.float(), v.float(), **kw).to(q.dtype), (q, k, v))
    t = tally["flash_attention"]
    assert (t["ill_conditioned_calls"], t["outside"],
            t["kernel_off_plain_nearer_exact"]) == (0, 0, 0)
    assert 0 < t["well_max_err_exact"]
    assert 0 < t["well_max_err_exact_over_tol"] <= 1


def _bwd_operands(b, sq, sk, h, kh, d, q_gain, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=gen).bfloat16()
                     for shape in ((b, sq, h, d), (b, sk, kh, d),
                                   (b, sk, kh, d), (b, sq, h, d)))
    return q * q_gain, k, v, dout


@pytest.mark.parametrize("cap,q_gain,sees", [
    # grok-1's cap at its training row's gain: the scores reach ~45
    (chip_smoke.GROK_CAP, chip_smoke.GROK_Q_GAIN, True),
    # the same cap at a spread of 1 (|s| up to ~5) bends no gradient far
    (chip_smoke.GROK_CAP, 1.0, False),
])
def test_cap_check_needs_the_cap_to_move_the_gradients(cap, q_gain, sees):
    """At D 128 over 48 q heads on 8, the cap moves the plain dq and dk
    beyond BWD_TOL only where the scores reach it (readings at these
    operands, dq and dk: 0.61 and 0.43 at gain 8, 0.025 and 0.011 at
    gain 1)."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    q, k, v, dout = _bwd_operands(1, 256, 256, 48, 8, 128, q_gain)
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    want = flash_attention_bwd_ref(
        qf, kf, vf, flash_attention_ref(qf, kf, vf, logit_cap=cap), df,
        logit_cap=cap)
    if sees:
        moved = chip_smoke.cap_check(q, k, v, dout, want, torch.bfloat16,
                                     "test", logit_cap=cap)
        assert min(moved[:2]) > 10 * chip_smoke.BWD_TOL[torch.bfloat16]
    else:
        with pytest.raises(AssertionError, match="the cap moves"):
            chip_smoke.cap_check(q, k, v, dout, want, torch.bfloat16,
                                 "test", logit_cap=cap)


@pytest.mark.parametrize("sq,sk", [(96, 96), (40, 96)])
def test_softcap_library_computes_the_capped_attention(monkeypatch,
                                                       tmp_path, sq, sk):
    """flex_attention with the tanh score_mod, the causal block mask
    aligned to the last key and GQA 6:2, eager (``torch.compile`` left
    out on the CPU), against the plain capped attention in f32: the same
    function up to f32 rounding."""
    monkeypatch.setattr(torch, "compile", lambda fn, **kw: fn)
    for name in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(name, str(tmp_path))
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, sq, 6, 64), generator=gen) * 6.0
    k, v = (torch.randn((1, sk, 2, 64), generator=gen) for _ in range(2))
    lib = chip_smoke.softcap_library(5.0, sq, sk, device="cpu")
    got = lib(*(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2)
    want = flash_attention_ref(q, k, v, logit_cap=5.0)
    assert float((got - want).abs().max()) <= 1e-5
    # the cap and the mask both bite: without either the result moves
    assert float((flash_attention_ref(q, k, v) - want).abs().max()) > 0.1
    assert float((flash_attention_ref(q, k, v, causal=False,
                                      logit_cap=5.0) - want).abs().max()) > 0.1
