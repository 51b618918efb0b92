"""The tensor-core mLSTM backward's arithmetic and plan, on the CPU.

The kernels (``csrc/mlstm_bwd_wgmma.cuh``) run only on the card; their
arithmetic in plain PyTorch, ``ref.mlstm_bwd_split_ref`` (S and dP in
chains of 128 head dims, E in the kernels' exp2 form, P and dS rounded to
bf16 for the products, the dlogw sums stage by stage in f32), is held
here at head dim 512 and small S on numpy-seeded operands rounded to bf16
(q, k, v, dO; the gates f32), with the forward's row stats from
``mlstm_ref(with_stats=True)``:

- against ``mlstm_bwd_ref`` (the plain backward in f32 on the same
  stats) and against ``jax.vjp`` of the JAX package's
  ``kernels/mlstm_scan/ref.mlstm_ref``: max |twin - reference| <= TOL *
  max |reference| for each gradient, TOL = 2e-2 for dq, dk, dv (chip_smoke's
  BWD_TOL for bf16: P and dS go to the tensor cores as one bf16 term) and
  1e-4 for d log i and d log f (their sums take the f32 values).  Readings
  (the largest over the cases, both references): dq, dk, dv 2.9e-3,
  d log i 4.1e-6, d log f 3.4e-6;
- the outputs' dtypes: dq, dk, dv in the operands' dtype, the gate
  gradients f32.

Cases: S ragged against the 64-key blocks and the 16-row stages, S under
one block, two batch rows, and input gates low enough that exp(-m) is the
normaliser of most rows (sg = 0 there, so delta is 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan.ref import mlstm_ref as jax_mlstm_ref
from repro_torch.kernels.mlstm_scan import backward as ml_backward
from repro_torch.kernels.mlstm_scan.ref import (mlstm_bwd_ref,
                                                mlstm_bwd_split_ref,
                                                mlstm_ref)

# dq, dk, dv; d log i, d log f
TOL = (2e-2, 2e-2, 2e-2, 1e-4, 1e-4)
D = 512

# (b, s, h, mean of log i)
CASES = {"ragged": (1, 77, 2, 0.0),
         "under_one_block": (1, 40, 2, 0.0),
         "two_batch_rows": (2, 96, 1, 0.0),
         "sg_zero_rows": (1, 70, 2, -3.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small ops: one intra-op thread, so that the test workers sharing
    the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, i_shift, seed):
    """q, k, v, dO ~ N(0, 1) rounded to bf16 (held as f32), log i ~
    N(i_shift, 1), log f = -|N(0, 1)| / 2, as numpy f32 arrays."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, s, h, D))
                                      .astype(np.float32))
                     .to(torch.bfloat16).float().numpy() for _ in range(4))
    log_i = (rng.normal(size=(b, s, h)) + i_shift).astype(np.float32)
    log_f = (-np.abs(rng.normal(size=(b, s, h))) * 0.5).astype(np.float32)
    return q, k, v, log_i, log_f, dout


@pytest.mark.parametrize("against", ["mlstm_bwd_ref", "jax_vjp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_twin_matches_the_plain_backward(case, against):
    b, s, h, i_shift = CASES[case]
    q, k, v, log_i, log_f, dout = _inputs(b, s, h, i_shift,
                                          seed=sorted(CASES).index(case))
    ts = [torch.from_numpy(x) for x in (q, k, v, log_i, log_f)]
    out, lse, sg = mlstm_ref(*ts, with_stats=True)
    got = mlstm_bwd_split_ref(*ts, out, torch.from_numpy(dout), (lse, sg))
    if against == "jax_vjp":
        _, vjp = jax.vjp(jax_mlstm_ref, *map(jnp.asarray,
                                             (q, k, v, log_i, log_f)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    else:
        want = [g.numpy() for g in mlstm_bwd_ref(
            *ts, out, torch.from_numpy(dout), (lse, sg))]
    share = float((sg == 0).float().mean())
    assert share > 0.5 if i_shift < 0 else 0 < share < 0.5
    for g, w, tol in zip(got, want, TOL):
        assert g.dtype == torch.float32
        g = g.numpy()
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


def test_split_twin_keeps_the_operands_dtype():
    q, k, v, log_i, log_f, dout = _inputs(1, 20, 1, 0.0, seed=7)
    ts = [torch.from_numpy(x) for x in (q, k, v, log_i, log_f)]
    out, lse, sg = mlstm_ref(*ts, with_stats=True)
    bf = [x.to(torch.bfloat16) for x in (ts[0], ts[1], ts[2], out)]
    got = mlstm_bwd_split_ref(*bf[:3], log_i=ts[3], log_f=ts[4], out=bf[3],
                              dout=torch.from_numpy(dout).bfloat16(),
                              stats=(lse, sg))
    assert [x.dtype for x in got] == [torch.bfloat16] * 3 + \
        [torch.float32] * 2
    want = mlstm_bwd_split_ref(*ts, out.bfloat16().float(),
                               torch.from_numpy(dout), (lse, sg))
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("d,dtype,variant", [
    (512, torch.bfloat16, "wgmma"),
    (512, torch.float32, "simt"),
    (64, torch.bfloat16, "simt"),
    (32, torch.bfloat16, "simt"),
    (16, torch.bfloat16, "simt"),
])
def test_backward_plan(d, dtype, variant):
    """bf16 at head dim 512 takes the tensor cores, whatever the shape;
    f32 and the other head dims the CUDA cores."""
    for b, s, h in ((2, 2048, 4), (1, 37, 1), (3, 64, 2)):
        assert ml_backward.plan(b, s, h, d, dtype) == variant
    assert ml_backward.TC_HEAD_DIMS == (512,)
    assert set(ml_backward.VARIANT_CALLS) == set(ml_backward.VARIANTS) == \
        {"wgmma", "simt"}
