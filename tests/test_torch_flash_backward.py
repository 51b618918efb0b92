"""The gradient of the port's flash attention against the JAX package's,
on the CPU.

- dq, dk and dv through ``ops.flash_attention`` on CPU tensors (autograd
  of the plain version) against ``jax.grad`` of the reference's attention
  (``src/repro/models/attention.py``) on the same numpy-seeded values:
  float32, max |port - reference| <= 1e-5 * max |reference| per gradient
  (the two sum in another order; the reference's own chunked path over
  Sk > 1024 included);
- ``ref.flash_attention_bwd_ref``, the backward kernel's plain twin (its
  explicit formulas with P recomputed), against torch autograd of
  ``flash_attention_ref``: float32, the same 1e-5 of the largest
  gradient;
- ``torch.autograd.gradcheck`` in float64 of ``ops.FlashAttentionFn``
  with its two device kernels swapped, in this test only, for their plain
  twins evaluated in float64 (the kernels' forward formulas and
  ``flash_attention_bwd_ref``): the backward is the forward's gradient
  (gradcheck's default tolerances, in its fast mode: the Jacobian checked
  along random directions).

Cases: causal and not, Sq < Sk, a window, a softcap, GQA, ragged lengths,
and queries whose window masks every key.  Their output is 0 whatever
the inputs, so their gradient is 0 and they add nothing to dk; the
reference's ``jax.grad`` gives NaN for their dq and for every dk instead
(C-ref11: the backward of ``p / max(l, 1e-30)`` squares 1e-30 to 0 in
f32), so that case is held against the reference on the rows that see a
key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention as jax_attention
from repro_torch.kernels.flash_attention import backward as fa_backward
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ops here are small: one intra-op thread, so that the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REL = 1e-5

# (b, sq, sk, h, kh, d, options)
CASES = {
    "causal": (2, 9, 9, 4, 2, 16, {}),
    "non_causal": (1, 7, 11, 4, 4, 16, {"causal": False}),
    "sq_lt_sk": (2, 5, 13, 4, 2, 8, {}),
    "window": (1, 12, 12, 4, 1, 16, {"window": 4}),
    "softcap": (1, 10, 10, 6, 2, 16, {"logit_cap": 2.5}),
    "gqa_6_to_1": (1, 8, 8, 6, 1, 8, {"window": 5, "logit_cap": 4.0}),
    "masked_rows": (1, 5, 3, 2, 1, 8, {"causal": False, "window": 1}),
    "chunked": (1, 3, 1100, 2, 1, 8, {}),
}


def _inputs(b, sq, sk, h, kh, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype) for s in
                 ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d),
                  (b, sq, h, d)))


def _close(got, want, rel=REL):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= rel * np.abs(w).max() + 1e-30, (name, err,
                                                      np.abs(w).max())


def _port_grads(q, k, v, w, **kw):
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa_ops.flash_attention(*xs, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    return out, grads


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
def test_port_gradient_equals_jax_grad_of_the_reference(case):
    b, sq, sk, h, kh, d, kw = CASES[case]
    q, k, v, w = _inputs(b, sq, sk, h, kh, d, seed=len(case))
    _, got = _port_grads(q, k, v, w, **kw)
    got = [g.numpy() for g in got]
    if case == "masked_rows":      # queries 3, 4 see no key (C-ref11)
        assert np.abs(got[0][:, 3:]).max() == 0.0
        q, w, got[0] = q[:, :3], w[:, :3], got[0][:, :3]
    _close(got, _jax_grads(q, k, v, w, **kw))


def test_c_ref11_reference_gradient_is_nan_on_a_row_with_no_key():
    """A query whose window masks every key: the reference's forward gives
    0 there, but its gradient is NaN for that row's dq and for all of dk;
    the port's is finite, 0 on the row."""
    b, sq, sk, h, kh, d, kw = CASES["masked_rows"]
    q, k, v, w = _inputs(b, sq, sk, h, kh, d, seed=0)
    want = _jax_grads(q, k, v, w, **kw)
    assert np.isnan(want[0][:, 3:]).all() and np.isnan(want[1]).any()
    assert not np.isnan(want[0][:, :3]).any() and not np.isnan(want[2]).any()
    _, got = _port_grads(q, k, v, w, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert float(got[0][:, 3:].abs().max()) == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_twin_equals_torch_autograd(case):
    b, sq, sk, h, kh, d, kw = CASES[case]
    q, k, v, w = _inputs(b, sq, sk, h, kh, d, seed=len(case) + 1)
    out, want = _port_grads(q, k, v, w, **kw)
    got = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  out.detach(), torch.from_numpy(w), **kw)
    _close([g.numpy() for g in got], [x.numpy() for x in want])
    in_rows = flash_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), out.detach(),
        torch.from_numpy(w), rows=2, **kw)
    _close([g.numpy() for g in in_rows], [x.numpy() for x in want])


def _forward_f64(q, k, v, *, causal=True, window=None, scale=None,
                 logit_cap=None, with_lse=False):
    """The kernels' forward formulas (guarded max, a row with no valid key
    0) in float64: the plain twin of the forward for gradcheck; with
    ``with_lse`` also each row's lse (+inf with no valid key), as the
    kernels write it for the backward."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(h // kh, dim=2)
    vv = v.repeat_interleave(h // kh, dim=2)
    raw = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    s = raw if logit_cap is None else logit_cap * torch.tanh(raw / logit_cap)
    q_pos = torch.arange(sq)[:, None] + (sk - sq if causal else 0)
    k_pos = torch.arange(sk)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    masked = torch.where(valid, s, NEG_INF)
    m = torch.clamp(masked.amax(-1, keepdim=True), min=0.1 * NEG_INF)
    p = torch.where(valid, torch.exp(masked - m), 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    if not with_lse:
        return out
    return out, torch.where(l > 0, m + torch.log(l), float("inf"))[..., 0]


@pytest.mark.parametrize("case", ["causal", "sq_lt_sk", "softcap",
                                  "gqa_6_to_1", "masked_rows"])
def test_flash_attention_fn_gradcheck_f64(case, monkeypatch):
    b, sq, sk, h, kh, d, kw = CASES[case]
    b, d = 1, min(d, 8)
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", _forward_f64)
    monkeypatch.setattr(fa_backward, "flash_attention_bwd_cuda",
                        flash_attention_bwd_ref)
    xs = [torch.from_numpy(a).requires_grad_() for a in
          _inputs(b, sq, sk, h, kh, d, seed=3, dtype=np.float64)[:3]]

    def fn(q, k, v):
        return fa_ops.FlashAttentionFn.apply(
            q, k, v, kw.get("causal", True), kw.get("window"), None,
            kw.get("logit_cap"))

    assert torch.autograd.gradcheck(fn, xs, fast_mode=True)
    # the forward twin is the plain version's function
    torch.testing.assert_close(
        fn(*xs).float(), flash_attention_ref(*(x.float() for x in xs), **kw),
        rtol=1e-5, atol=1e-6)
