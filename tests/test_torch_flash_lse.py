"""The lse that flash attention's forward hands to its backward, and the
plain versions the backward kernels are held against, on the CPU.

- ``ref.flash_attention_lse_ref`` (what the forward kernels write with
  ``with_lse``) against ``jax.nn.logsumexp`` over the reference's masked,
  scaled and capped scores (``src/repro/models/attention.py``: its
  ``repeat_kv``, ``_mask_bias`` and softcap) on the same numpy-seeded
  values: float32, within 1e-5 relative (1e-6 absolute near 0); a row
  with no valid key is +inf in the port (the reference's is NEG_INF plus
  a log);
- ``ref.flash_attention_bwd_ref`` given that lse against the same
  function computing its own, and against ``jax.grad`` of the
  reference's attention: 1e-5 of the largest gradient, as
  ``tests/test_torch_flash_backward.py``;
- ``ref.flash_attention_bwd_split_ref``, the tensor-core backward's sum
  over runs of query heads in run order, against the unsplit plain
  backward: 1e-6 of the largest gradient in float32 (the two add the same
  terms in another order);
- the plans: the backward's variant and head runs, and the forward's
  prefill kernel for every call that asks for lse;
- ``ops.FlashAttentionFn`` hands the forward's lse to the backward.

Cases: causal and not, Sq < Sk, a window, a softcap, GQA, and queries whose
window masks every key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _mask_bias
from repro.models.attention import attention as jax_attention
from repro.models.attention import repeat_kv as jax_repeat_kv
from repro.models.layers import softcap as jax_softcap
from repro_torch.kernels.flash_attention import backward as fa_backward
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_bwd_split_ref,
    flash_attention_lse_ref, flash_attention_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ops here are small: one intra-op thread, so that the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (b, sq, sk, h, kh, d, options)
CASES = {
    "causal": (2, 9, 9, 4, 2, 16, {}),
    "non_causal": (1, 7, 11, 4, 4, 16, {"causal": False}),
    "sq_lt_sk": (2, 5, 13, 4, 2, 8, {}),
    "window": (1, 12, 12, 4, 1, 16, {"window": 4}),
    "softcap": (1, 10, 10, 6, 2, 16, {"logit_cap": 2.5}),
    "gqa_16_to_1": (1, 11, 11, 16, 1, 8, {"window": 6}),
    "gqa_6_to_1": (1, 8, 8, 6, 1, 8, {"window": 5, "logit_cap": 4.0}),
    "masked_rows": (1, 5, 3, 2, 1, 8, {"causal": False, "window": 1}),
}
REL = 1e-5


def _inputs(b, sq, sk, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in
                 ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d),
                  (b, sq, h, d)))


def _jax_lse(q, k, causal=True, window=None, logit_cap=None):
    """logsumexp over the reference's scores, (B, H, Sq), and the rows
    with no valid key: q * scale against the repeated keys, capped, plus
    the reference's mask bias."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q_pos = jnp.arange(sq, dtype=jnp.int32) + (sk - sq if causal else 0)
    k_pos = jnp.arange(sk, dtype=jnp.int32)
    s = jnp.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, jax_repeat_kv(k, h))
    s = jax_softcap(s, logit_cap)
    bias = jnp.broadcast_to(_mask_bias(q_pos, k_pos, causal=causal,
                                       window=window), (sq, sk))
    lse = jax.nn.logsumexp(s + bias[None, None], axis=-1)
    return np.asarray(lse), np.asarray((bias < 0).all(axis=-1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_lse_equals_jax_logsumexp(case):
    b, sq, sk, h, kh, d, kw = CASES[case]
    q, k, v, _ = _inputs(b, sq, sk, h, kh, d, seed=len(case) + 10)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  **kw).numpy()
    want, no_key = _jax_lse(q, k, **kw)
    assert got.shape == (b, h, sq) and got.dtype == np.float32
    assert np.isposinf(got[:, :, no_key]).all()
    assert np.isfinite(got[:, :, ~no_key]).all()
    assert no_key.any() == (case == "masked_rows")
    np.testing.assert_allclose(got[:, :, ~no_key], want[:, :, ~no_key],
                               rtol=REL, atol=1e-6)
    # the forward's plain version hands back the same lse beside its output
    out, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   with_lse=True, **kw)
    assert torch.equal(lse, torch.from_numpy(got))
    assert out.shape == (b, sq, h, d)


def _close(got, want, rel):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max() + 1e-30, (name, err,
                                                      np.abs(w).max())


def _jax_grads(q, k, v, w, causal=True, window=None, logit_cap=None):
    """jax.grad of sum(attention * w) by the reference's attention."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = jnp.arange(sq, dtype=jnp.int32) + (sk - sq if causal else 0)
    k_pos = jnp.arange(sk, dtype=jnp.int32)

    def loss(q, k, v):
        out = jax_attention(q, k, v, q_positions=q_pos, k_positions=k_pos,
                            causal=causal, window=window,
                            logit_cap=logit_cap)
        return jnp.sum(out * w)

    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_given_the_forward_lse(case):
    """The plain backward on the forward's lse equals itself computing its
    own lse, and jax.grad of the reference (on the rows that see a key:
    C-ref11 makes the reference's gradient NaN elsewhere)."""
    b, sq, sk, h, kh, d, kw = CASES[case]
    q, k, v, w = _inputs(b, sq, sk, h, kh, d, seed=len(case) + 20)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    out, lse = flash_attention_ref(tq, tk, tv, with_lse=True, **kw)
    got = flash_attention_bwd_ref(tq, tk, tv, out, tw, lse, **kw)
    own = flash_attention_bwd_ref(tq, tk, tv, out, tw, **kw)
    _close([g.numpy() for g in got], [g.numpy() for g in own], REL)
    in_rows = flash_attention_bwd_ref(tq, tk, tv, out, tw, lse, rows=3, **kw)
    _close([g.numpy() for g in in_rows], [g.numpy() for g in own], REL)
    got = [g.numpy() for g in got]
    if case == "masked_rows":      # queries 3, 4 see no key (C-ref11)
        assert np.abs(got[0][:, 3:]).max() == 0.0
        q, w, got[0] = q[:, :3], w[:, :3], got[0][:, :3]
    _close(got, _jax_grads(q, k, v, w, **kw), REL)


@pytest.mark.parametrize("case,splits", [
    ("causal", 2), ("softcap", 3), ("gqa_16_to_1", 2), ("gqa_16_to_1", 4),
    ("gqa_16_to_1", 16), ("gqa_6_to_1", 3), ("masked_rows", 2),
    ("window", 4)])
def test_split_ref_equals_the_unsplit_backward(case, splits):
    b, sq, sk, h, kh, d, kw = CASES[case]
    q, k, v, w = (torch.from_numpy(a) for a in
                  _inputs(b, sq, sk, h, kh, d, seed=len(case) + splits))
    out, lse = flash_attention_ref(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd_split_ref(q, k, v, out, w, lse, splits=splits,
                                        **kw)
    want = flash_attention_bwd_ref(q, k, v, out, w, lse, **kw)
    assert torch.equal(got[0], want[0])             # dq has no head runs
    _close([g.numpy() for g in got], [x.numpy() for x in want], 1e-6)


def test_split_ref_refuses_runs_that_do_not_divide_the_group():
    b, sq, sk, h, kh, d, kw = CASES["gqa_6_to_1"]
    q, k, v, w = (torch.from_numpy(a) for a in
                  _inputs(b, sq, sk, h, kh, d, seed=0))
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention_bwd_split_ref(q, k, v, q, w, splits=4, **kw)


@pytest.mark.parametrize("shape,dtype,want", [
    # starcoder2-3b's microbatch: 64 key blocks, 4 runs of 4 heads
    ((2, 2048, 2048, 32, 2, 128), torch.bfloat16, ("wgmma", 4)),
    # qwen3-14b's heads over 1024 tokens: 64 key blocks, 3 runs of 2
    ((1, 1024, 1024, 48, 8, 128), torch.bfloat16, ("wgmma", 3)),
    ((1, 200, 200, 4, 4, 64), torch.bfloat16, ("wgmma", 1)),   # G = 1
    ((1, 130, 200, 10, 2, 128), torch.bfloat16, ("wgmma", 5)),
    ((8, 4096, 4096, 32, 8, 128), torch.bfloat16, ("wgmma", 1)),
    # D 256: 2 key blocks of 64 reach no 132 SMs, so every head is a run
    ((1, 100, 100, 6, 1, 256), torch.bfloat16, ("wgmma", 6)),
    # recurrentgemma-9b's microbatch: 2048 keys are 32 blocks of 64; 4 runs
    # give 128 blocks (< 132 SMs), so 8 runs of 2 heads, 256 blocks
    ((1, 2048, 2048, 16, 1, 256), torch.bfloat16, ("wgmma", 8)),
    ((1, 2048, 2048, 16, 1, 256), torch.float32, ("simt", 1)),
    ((1, 100, 100, 6, 1, 256), torch.float32, ("simt", 1)),
    ((2, 40, 40, 4, 2, 16), torch.bfloat16, ("simt", 1)),
    ((1, 45, 45, 2, 1, 32), torch.bfloat16, ("simt", 1)),
    ((2, 2048, 2048, 32, 2, 128), torch.float32, ("simt", 1)),
])
def test_backward_plan(shape, dtype, want):
    pl = fa_backward.plan(*shape, dtype)
    assert (pl.variant, pl.splits) == want
    g = shape[3] // shape[4]
    assert g % pl.splits == 0


def test_forward_plan_never_decodes_a_call_that_wants_lse():
    """A bf16 call of few rows takes the decode kernel, which writes no
    lse; asked for lse it takes the prefill kernel, so lse comes from the
    launch whose output is differentiated."""
    for shape in ((2, 1, 24, 48, 8, 128), (1, 5, 3, 2, 1, 64),
                  (1, 2, 300, 12, 2, 64)):
        assert fa_kernel.plan(*shape, torch.bfloat16).variant == "decode"
        assert fa_kernel.plan(*shape, torch.bfloat16,
                              with_lse=True).variant == "wgmma"
    assert fa_kernel.plan(2, 1, 24, 4, 2, 16, torch.bfloat16,
                          with_lse=True).variant == "simt"
    assert fa_kernel.plan(2, 1, 24, 48, 8, 128, torch.float32,
                          with_lse=True).variant == "simt"


def test_flash_attention_fn_hands_the_forward_lse_to_the_backward(
        monkeypatch):
    """FlashAttentionFn asks the forward for lse and passes that tensor to
    the backward (the kernels swapped for their plain versions)."""
    seen = {}

    def forward(q, k, v, **kw):
        out, lse = flash_attention_ref(q, k, v, **kw)
        seen["lse"] = lse
        return out, lse

    def backward(q, k, v, out, dout, lse, **kw):
        seen["bwd_lse"] = lse
        return flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", forward)
    monkeypatch.setattr(fa_backward, "flash_attention_bwd_cuda", backward)
    b, sq, sk, h, kh, d, kw = CASES["gqa_6_to_1"]
    xs = [torch.from_numpy(a).requires_grad_()
          for a in _inputs(b, sq, sk, h, kh, d, seed=4)[:3]]
    out = fa_ops.FlashAttentionFn.apply(*xs, True, kw["window"], None,
                                        kw["logit_cap"])
    grads = torch.autograd.grad(out.sum(), xs)
    assert seen["bwd_lse"] is seen["lse"]
    assert torch.equal(seen["lse"], flash_attention_lse_ref(
        xs[0].detach(), xs[1].detach(), **kw))
    want = torch.autograd.grad(flash_attention_ref(*xs, **kw).sum(), xs)
    for g, w in zip(grads, want):
        assert float((g - w).abs().max()) <= REL * float(w.abs().max())
