"""The gradient of the port's chunkwise mLSTM against the JAX package's,
on the CPU.

- ``ref.mlstm_bwd_ref``, the backward kernel's plain twin (the closed form
  on the forward's row stats), against ``jax.vjp`` of the reference's
  ``kernels/mlstm_scan/ref.mlstm_ref`` and against torch autograd of the
  port's ``mlstm_ref``, on the same numpy-seeded values: float32, max
  |port - reference| <= 1e-5 * max |reference| for dq, dk, dv, d log_i
  and d log_f.  Readings (the largest of each case, against jax.vjp):
  up to 1.6e-6 for dq, dk, dv and d log_i and 1.7e-6 for d log_f (the
  reverse cumulative sum of row minus column sums needs no more); against
  torch autograd up to 6.6e-7.  The sizes stay small: at S = 200 both f32
  evaluations lie ~1e-5 from the f64 value and 1.6e-5 from each other
  (the gates' exp spreads the terms), so neither is a reference for the
  other there.  Cases: S ragged against the chunk (the reference pads
  it), S over one chunk, all of S in one chunk, and input gates low
  enough that exp(-m) is every row's normaliser (sg = 0); the stats from
  ``mlstm_ref(with_stats=True)`` and computed by the twin itself.
- the row stats against an f64 evaluation, and, in f64, the closed form
  of dlogw's row sums, ``(1 - sg^2) (dO . o)`` (the backward kernel sums
  the terms instead: with o rounded to bf16 the closed form is off).
- ``torch.autograd.gradcheck`` in float64 of ``ops.MlstmFn`` with its two
  device kernels swapped, in this test only, for f64 twins (a dense
  forward that writes the stats, and ``mlstm_bwd_ref``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan.ref import mlstm_ref as jax_mlstm_ref
from repro_torch.kernels.mlstm_scan import backward as ml_backward
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan.ref import mlstm_bwd_ref, mlstm_ref

REL = 1e-5

# (b, s, h, d, chunk_size, mean of log i)
CASES = {"one_chunk": (2, 9, 2, 8, 1024, 0.0),
         "over_one_chunk": (1, 40, 2, 16, 16, 0.0),
         "ragged": (1, 37, 3, 8, 16, 0.0),
         "exp_neg_m_rows": (1, 64, 2, 16, 1024, -3.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ops here are small: one intra-op thread, so that the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, d, i_shift, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.normal(size=(b, s, h, d)).astype(dtype)
                     for _ in range(4))
    log_i = (rng.normal(size=(b, s, h)) + i_shift).astype(dtype)
    log_f = (-np.abs(rng.normal(size=(b, s, h))) * 0.5).astype(dtype)
    return q, k, v, log_i, log_f, dout


def _dense_f64(q, k, v, log_i, log_f):
    """The mLSTM over every (query, key) pair at once, in the operands'
    dtype: (out, L, sg), the forward's function and its row stats."""
    s, d = q.shape[1], q.shape[3]
    fcum = torch.cumsum(log_f, dim=1)
    pos = torch.arange(s)
    causal = (pos[None, :] <= pos[:, None])[None, :, :, None]
    logw = torch.where(causal, fcum[:, :, None] - fcum[:, None] +
                       log_i[:, None], -1e30)
    m = logw.amax(dim=2)
    w = torch.exp(logw - m[:, :, None])
    a = w * torch.einsum("bthd,bshd->btsh", q / math.sqrt(d), k)
    den = a.sum(dim=2)
    norm = torch.maximum(den.abs(), torch.exp(-m))
    out = torch.einsum("btsh,bshd->bthd", a, v) / norm[..., None]
    sg = torch.where(den.abs() > torch.exp(-m), torch.sign(den),
                     torch.zeros_like(den))
    return out, m + torch.log(norm), sg


@pytest.mark.parametrize("against", ["jax_vjp", "torch_autograd"])
@pytest.mark.parametrize("stats", ["forward", "own"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_the_reference(case, stats, against):
    b, s, h, d, chunk, i_shift = CASES[case]
    q, k, v, log_i, log_f, dout = _inputs(b, s, h, d, i_shift,
                                          seed=sorted(CASES).index(case))
    if against == "jax_vjp":
        _, vjp = jax.vjp(
            lambda *x: jax_mlstm_ref(*x, chunk_size=chunk),
            *map(jnp.asarray, (q, k, v, log_i, log_f)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    else:
        xs = [torch.from_numpy(x).requires_grad_() for x in
              (q, k, v, log_i, log_f)]
        out = mlstm_ref(*xs, chunk_size=chunk)
        want = [g.numpy() for g in torch.autograd.grad(
            (out * torch.from_numpy(dout)).sum(), xs)]
    ts = [torch.from_numpy(x) for x in (q, k, v, log_i, log_f)]
    out, lse, sg = mlstm_ref(*ts, chunk_size=chunk, with_stats=True)
    got = mlstm_bwd_ref(*ts, out, torch.from_numpy(dout),
                        (lse, sg) if stats == "forward" else None, rows=16)
    if case == "exp_neg_m_rows":
        assert bool((sg == 0).all())
    else:
        assert 0 < float((sg == 0).float().mean()) < 1
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= REL * np.abs(w).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_stats_and_the_closed_form_row_sums(case):
    b, s, h, d, chunk, i_shift = CASES[case]
    q, k, v, log_i, log_f, dout = map(torch.from_numpy, _inputs(
        b, s, h, d, i_shift, seed=10 + sorted(CASES).index(case)))
    out, lse, sg = mlstm_ref(q, k, v, log_i, log_f, chunk_size=chunk,
                             with_stats=True)
    ops64 = [x.double() for x in (q, k, v, log_i, log_f)]
    out64, lse64, sg64 = _dense_f64(*ops64)
    assert torch.equal(sg, sg64.float())
    assert float((lse.double() - lse64).abs().max()) <= 1e-5 * max(
        1.0, float(lse64.abs().max()))
    # dF_t = rowsum_t - colsum_t and d log f its reverse cumulative sum, so
    # rowsum_t = (dlf_t - dlf_{t+1}) + dli_t: (1 - sg^2) (dO . o) in closed
    # form (in f64 here)
    _, _, _, dli, dlf = mlstm_bwd_ref(*ops64, out64, dout.double(),
                                      (lse64, sg64))
    nxt = torch.cat([dlf[:, 1:], torch.zeros_like(dlf[:, :1])], dim=1)
    rowsum = (dlf - nxt) + dli
    closed = (1 - sg64 ** 2) * (dout.double() * out64).sum(-1)
    assert float((rowsum - closed).abs().max()) <= 1e-9 * max(
        1.0, float(closed.abs().max()))


@pytest.mark.parametrize("case", ["over_one_chunk", "ragged",
                                  "exp_neg_m_rows"])
def test_mlstm_fn_gradcheck_f64(case, monkeypatch):
    b, s, h, d, _, i_shift = CASES[case]
    b, s, d = 1, min(s, 12), min(d, 8)

    def forward(q, k, v, log_i, log_f, with_stats=False):
        assert with_stats
        return _dense_f64(q, k, v, log_i, log_f)

    def backward(q, k, v, log_i, log_f, out, dout, lse, sg):
        return mlstm_bwd_ref(q, k, v, log_i, log_f, out, dout, (lse, sg))

    monkeypatch.setattr(ml_kernel, "mlstm_cuda", forward)
    monkeypatch.setattr(ml_backward, "mlstm_bwd_cuda", backward)
    xs = [torch.from_numpy(x).requires_grad_() for x in
          _inputs(b, s, h, d, i_shift, seed=3, dtype=np.float64)[:5]]
    assert torch.autograd.gradcheck(ml_ops.MlstmFn.apply, xs,
                                    fast_mode=True)
    # the forward twin is the plain version's function
    torch.testing.assert_close(
        ml_ops.MlstmFn.apply(*xs).float(),
        mlstm_ref(*(x.detach().float() for x in xs)), rtol=1e-5, atol=1e-6)
