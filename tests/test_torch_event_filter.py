"""The port's event filter (plain versions of the two CUDA kernels, and the
matchers around them) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, and their jnp references.

Same numpy inputs through both.  Masks are exactly equal at calib 0 with
no sum cap; with calibration or a cap they may differ only on band events
(see ``test_torch_parity``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.event_filter import ops as ref_ops
from repro.kernels.event_filter.kernel import (event_filter_batch_pallas,
                                               event_filter_pallas)
from repro.kernels.event_filter.ref import (event_filter_batch_ref as
                                            jax_batch_ref,
                                            event_filter_ref as jax_ref)
from repro_torch.kernels.event_filter import kernel as port_kernel
from repro_torch.kernels.event_filter import ops as port_ops
from repro_torch.kernels.event_filter.ref import (event_filter_batch_ref,
                                                  event_filter_ref)
from test_torch_parity import (REF_SCHEMA, SCHEMA, as_jax, as_torch,
                               assert_masks_band_equal, band_events,
                               operands)

# columns: [scalar_thresh; pt_thresh; min_count; sum_cap]
THRESHOLDS = np.array([[40.0, 20.0, 35.0],
                       [15.0, 10.0, 5.0],
                       [2.0, 3.0, 1.0],
                       [800.0, 400.0, 200.0]], np.float32)
VAR_IDX = (0, 1, 2)


def _thresholds(k, cap):
    th = THRESHOLDS[:, :k].copy()
    if not cap:
        th[3] = -1.0
    return th


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("calib_iters", [0, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n,t,v,be,bt", [
    (128, 64, 7, 64, 32),
    (300, 70, 5, 128, 16),   # tail tiles on both axes
    (64, 16, 3, 64, 16),     # single block
])
def test_event_filter_batch_matches_pallas(n, t, v, be, bt, k, calib_iters,
                                           cap):
    rng = np.random.default_rng(1000 * n + 10 * k + calib_iters)
    sc, tr, nt = operands(rng, n, t, v)
    th = _thresholds(k, cap)
    mask_p, var_p = event_filter_batch_pallas(
        *as_jax(sc, tr, nt, th), var_idx=VAR_IDX[:k],
        calib_iters=calib_iters, block_e=be, block_t=bt)
    mask_j, _ = jax_batch_ref(*as_jax(sc, tr, nt, th), var_idx=VAR_IDX[:k],
                              calib_iters=calib_iters)
    mask, var = event_filter_batch_ref(*as_torch(sc, tr, nt, th),
                                       var_idx=VAR_IDX[:k],
                                       calib_iters=calib_iters)
    assert mask.dtype == var.dtype == torch.float32
    band = band_events(tr, nt, th, calib_iters)
    exact = calib_iters == 0 and not cap
    for want in (mask_p, mask_j):
        assert_masks_band_equal(mask.numpy(), np.asarray(want), band,
                                exact=exact, max_band=n // 20)
    np.testing.assert_array_equal(var.numpy(), np.asarray(var_p))
    np.testing.assert_array_equal(var.numpy(), sc[:, 0])


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("calib_iters", [0, 2])
@pytest.mark.parametrize("n,t,v", [(100, 70, 4), (64, 16, 3)])
def test_event_filter_single_matches_pallas(n, t, v, calib_iters, cap):
    rng = np.random.default_rng(7 * n + calib_iters)
    sc, tr, nt = operands(rng, n, t, v)
    th = _thresholds(1, cap)[:, 0]
    a, b, c, d = (float(x) for x in th)
    mask_p, var_p = event_filter_pallas(*as_jax(sc, tr, nt, th), var_idx=2,
                                        calib_iters=calib_iters,
                                        block_e=64, block_t=32)
    mask_j, _ = jax_ref(*as_jax(sc, tr, nt), var_idx=2, scalar_thresh=a,
                        pt_thresh=b, min_count=c, sum_cap=d,
                        calib_iters=calib_iters)
    mask, var = event_filter_ref(*as_torch(sc, tr, nt), var_idx=2,
                                 scalar_thresh=a, pt_thresh=b, min_count=c,
                                 sum_cap=d, calib_iters=calib_iters)
    # the dispatching entry point takes the plain version for CPU tensors
    mask_o, var_o = port_ops.event_filter(
        *as_torch(sc, tr, nt, th), torch.tensor([2], dtype=torch.int32),
        calib_iters=calib_iters)
    assert torch.equal(mask_o, mask) and torch.equal(var_o, var)
    band = band_events(tr, nt, th, calib_iters)
    for want in (mask_p, mask_j):
        assert_masks_band_equal(mask.numpy(), np.asarray(want), band,
                                exact=calib_iters == 0 and not cap,
                                max_band=n // 20)
    np.testing.assert_array_equal(var.numpy(), np.asarray(var_p))


def test_event_filter_batch_dispatch_uses_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    sc, tr, nt = operands(rng, 40, 24, 5)
    th = _thresholds(3, True)
    vi = torch.tensor(VAR_IDX, dtype=torch.int32)
    launches = dict(port_kernel.LAUNCHES)
    mask, var = port_ops.event_filter_batch(*as_torch(sc, tr, nt, th), vi,
                                            calib_iters=1)
    want, _ = event_filter_batch_ref(*as_torch(sc, tr, nt, th),
                                     var_idx=VAR_IDX, calib_iters=1)
    assert torch.equal(mask, want)
    assert port_kernel.LAUNCHES == launches   # no kernel launch counted


# ------------------------- validation ----------------------------------- #
def _both_raise(match, ref_call, port_call):
    with pytest.raises(ValueError, match=match) as ref_err:
        ref_call()
    with pytest.raises(ValueError, match=match) as port_err:
        port_call()
    return str(ref_err.value), str(port_err.value)


def test_zero_sized_and_shape_errors_match_the_reference():
    rng = np.random.default_rng(0)
    sc, tr, nt = operands(rng, 64, 32, 4)
    th1 = np.array([40.0, 15.0, 2.0, -1.0], np.float32)
    thb = th1[:, None].copy()
    vi1 = torch.tensor([0], dtype=torch.int32)
    jsc, jtr, jnt = as_jax(sc, tr, nt)
    tsc, ttr, tnt = as_torch(sc, tr, nt)
    cases = [
        ("zero-width grid",
         lambda: event_filter_pallas(jsc[:0], jtr[:0], jnt[:0],
                                     jnp.asarray(th1), var_idx=0,
                                     calib_iters=0),
         lambda: port_ops.event_filter(tsc[:0], ttr[:0], tnt[:0],
                                       torch.from_numpy(th1), vi1,
                                       calib_iters=0)),
        ("zero-width grid",
         lambda: event_filter_batch_pallas(jsc, jtr[:, :0], jnt,
                                           jnp.asarray(thb), var_idx=(0,),
                                           calib_iters=0),
         lambda: port_ops.event_filter_batch(tsc, ttr[:, :0], tnt,
                                             torch.from_numpy(thb), vi1,
                                             calib_iters=0)),
        ("thresholds",
         lambda: event_filter_batch_pallas(jsc, jtr, jnt,
                                           jnp.asarray(thb[:, :0]),
                                           var_idx=(), calib_iters=0),
         lambda: port_ops.event_filter_batch(
             tsc, ttr, tnt, torch.from_numpy(thb[:, :0].copy()),
             vi1[:0], calib_iters=0)),
        ("event axis",
         lambda: event_filter_pallas(jsc[:32], jtr, jnt, jnp.asarray(th1),
                                     var_idx=0, calib_iters=0),
         lambda: port_ops.event_filter(tsc[:32], ttr, tnt,
                                       torch.from_numpy(th1), vi1,
                                       calib_iters=0)),
        ("thresholds",
         lambda: event_filter_batch_pallas(jsc, jtr, jnt, jnp.asarray(th1),
                                           var_idx=(0,), calib_iters=0),
         lambda: port_ops.event_filter_batch(tsc, ttr, tnt,
                                             torch.from_numpy(th1), vi1,
                                             calib_iters=0)),
    ]
    for match, ref_call, port_call in cases:
        ref_msg, port_msg = _both_raise(match, ref_call, port_call)
        # the same wording, shapes printed as tuples on both sides
        assert ref_msg == port_msg


# ------------------------- matchers ------------------------------------- #
EPILOGUE_EXPRS = [
    "e_total > 40 && count(pt > 15) >= 2 && sum(pt) < 400",
    "count(pt > 15) >= 2",
    "e_t_miss > 25",
    "pt_lead > 60 || n_tracks >= 8",
    "e_total + 2 * e_t_miss > 120",
    "sum(pt) < 0",
    "nope > 3",
    "e_total > 40 && count(pt > 15) >= 2",
    "count(pt > 15) >= 2 && e_t_miss > 25 && sum(pt) < 250.5",
    "e_total > 40 &&",
]


@pytest.mark.parametrize("expr", EPILOGUE_EXPRS)
def test_matchers_give_the_reference_params(expr):
    want = ref_ops.match_epilogue(expr, REF_SCHEMA)
    got = port_ops.match_epilogue(expr, SCHEMA)
    assert got == want
    assert port_ops.match_canonical(expr, SCHEMA) == \
        ref_ops.match_canonical(expr, REF_SCHEMA)


def test_batch_kernel_params_same_layout():
    params = [p for p in (ref_ops.match_epilogue(e, REF_SCHEMA)
                          for e in EPILOGUE_EXPRS) if p is not None]
    want_th, want_vi = ref_ops.batch_kernel_params(params)
    th, vi = port_ops.batch_kernel_params(params, device="cpu")
    assert th.dtype == torch.float32 and tuple(th.shape) == (4, len(params))
    assert vi.dtype == torch.int32 and tuple(vi.shape) == (len(params),)
    np.testing.assert_array_equal(th.numpy(), np.asarray(want_th))
    assert tuple(vi.tolist()) == want_vi


def test_filter_and_summarize_matches_the_reference():
    rng = np.random.default_rng(4)
    sc, tr, nt = operands(rng, 48, SCHEMA.max_tracks, SCHEMA.track_vars)
    jb = dict(zip(("scalars", "tracks", "n_tracks"), as_jax(sc, tr, nt)))
    tb = dict(zip(("scalars", "tracks", "n_tracks"), as_torch(sc, tr, nt)))
    exprs = ["e_total > 40 && count(pt > 15) >= 2",
             "e_t_miss > 25 && count(pt > 10) >= 3",
             "pt_lead > 60 || n_tracks >= 8"]
    for expr in exprs:
        want, want_var = ref_ops.filter_and_summarize(expr, REF_SCHEMA, jb)
        got, got_var = port_ops.filter_and_summarize(expr, SCHEMA, tb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_var.numpy(), np.asarray(want_var))
    for group in (exprs[:2], exprs):   # all canonical / one straggler
        want, _ = ref_ops.filter_and_summarize_batch(group, REF_SCHEMA, jb)
        got, _ = port_ops.filter_and_summarize_batch(group, SCHEMA, tb)
        assert tuple(got.shape) == (len(group), 48)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
