"""The port's AdamW and learning-rate schedule against the JAX package's,
on the CPU, float32, inputs from numpy seeds.

- ``adamw_update`` over five steps from carried state: bit for bit (params,
  both moments, the count) while the gradient norm stays under
  ``grad_clip``, where the clip factor is exactly 1; above it the clip
  factor comes from a norm summed in f64 where the reference sums in f32
  (a few ulps apart): the norm is held to 1e-6 relative, params and
  moments to 1e-5 (a moment whose steps cancel carries the clip's last
  bits to ~2e-6 of its size).
- ``global_norm`` within 1e-6 relative (its squares are summed in f64);
  where the reference's f32 sum of squares overflows to inf (C-ref13) the
  port's norm is the finite f32 value.
- the update over slices of the leading axis equal, bit for bit, to the
  update of the whole leaf.
- ``cosine_schedule`` bit for bit at every phase of the schedule.
- ``opt_state_from_reference`` carries the reference's state exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as jax_reduced
from repro.models import model_zoo as jax_zoo
from repro.optim import adamw as jax_adamw
from repro.optim.schedule import cosine_schedule as jax_cosine
from repro_torch.configs.registry import reduced_config
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_schedule

SHAPES = {"a": {"w": (3, 5, 7), "b": (7,)}, "c": (11, 4)}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {key: _tree(fn, val) for key, val in shapes.items()}
    return fn(shapes)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    return [x.numpy() for x in adamw._leaves(tree)]


def _run(scale, steps=5, seed=0):
    """Both packages' AdamW over ``steps`` from the same params and
    gradients (gradient entries spread over 1e-9..1 times ``scale``)."""
    rng = np.random.default_rng(seed)
    params = _tree(lambda s: rng.normal(size=s).astype(np.float32))
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_adamw.init_opt_state(jp, jax_adamw.AdamW())
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = adamw.init_opt_state(tp, adamw.AdamW())
    norms = []
    for _ in range(steps):
        g = _tree(lambda s: (scale * rng.normal(size=s) *
                             10 ** rng.uniform(-9, 0, size=s))
                  .astype(np.float32))
        jp, js, jm = jax_adamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), js, 3e-4, jax_adamw.AdamW())
        tp, ts, tm = adamw.adamw_update(
            tp, jax.tree.map(torch.from_numpy, g), ts, 3e-4, adamw.AdamW())
        norms.append((float(jm["grad_norm"]), float(tm["grad_norm"])))
    return (jp, js), (tp, ts), norms


def test_adamw_bit_for_bit_under_the_clip():
    (jp, js), (tp, ts), norms = _run(scale=0.05)
    assert all(n[0] < 1.0 for n in norms)       # clip factor exactly 1
    for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for w, g in zip(_np_leaves(want), _port_leaves(got)):
            np.testing.assert_array_equal(g, w)
    assert int(ts["count"]) == int(js["count"]) == 5
    assert ts["count"].dtype == torch.int32


def test_adamw_over_the_clip_within_one_ulp_of_the_norm():
    (jp, js), (tp, ts), norms = _run(scale=20.0, seed=1)
    assert all(n[0] > 1.0 for n in norms)       # every step clips
    for w, g in norms:
        assert g == pytest.approx(w, rel=1e-6)
    for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for w, g in zip(_np_leaves(want), _port_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12)


def test_global_norm():
    rng = np.random.default_rng(2)
    tree = _tree(lambda s: rng.normal(size=s).astype(np.float32) * 3)
    want = float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(adamw.global_norm(jax.tree.map(torch.from_numpy, tree)))
    assert got == pytest.approx(want, rel=1e-6)


def test_c_ref13_the_reference_norm_overflows_where_the_port_does_not():
    """Gradients of ~1e21, as starcoder2-3b's first step at full width has
    (chip_smoke.py's train phase reads a norm of ~1e23): the reference's
    f32 sum of squares is inf, so its clip factor is 0 and the step moves
    by weight decay alone; the port's norm is finite and its clipped step
    is not 0."""
    rng = np.random.default_rng(5)
    tree = _tree(lambda s: (rng.normal(size=s) * 1e21).astype(np.float32))
    want = float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(adamw.global_norm(jax.tree.map(torch.from_numpy, tree)))
    exact = np.sqrt(sum(np.sum(np.square(x.astype(np.float64)))
                        for x in jax.tree.leaves(tree)))
    assert want == float("inf")
    assert got == pytest.approx(exact, rel=1e-6)
    p = _tree(lambda s: np.ones(s, np.float32))
    tp = jax.tree.map(torch.from_numpy, p)
    tp, _, met = adamw.adamw_update(tp, jax.tree.map(torch.from_numpy, tree),
                                    adamw.init_opt_state(tp, adamw.AdamW()),
                                    1e-3, adamw.AdamW())
    moved = [float((x - 1).abs().max()) for x in adamw._leaves(tp)]
    assert np.isfinite(float(met["grad_norm"])) and min(moved) > 1e-4


def test_sliced_update_equals_the_whole_leaf(monkeypatch):
    """Flat slices of 5 elements (across and within the rows of w and of
    c) against one slice a leaf.  The gradients stay under the clip: the
    norm's sum order follows the slices, so above it the clip factor may
    move by an ulp."""
    rng = np.random.default_rng(3)
    base = _tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = [_tree(lambda s: 0.01 * rng.normal(size=s).astype(np.float32))
             for _ in range(3)]
    out = []
    for elements in (1 << 26, 5):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", elements)
        p = jax.tree.map(lambda a: torch.from_numpy(a.copy()), base)
        st = adamw.init_opt_state(p, adamw.AdamW())
        for g in grads:
            p, st, met = adamw.adamw_update(
                p, jax.tree.map(torch.from_numpy, g), st, 1e-3, adamw.AdamW())
        out.append((p, st, met))
        if elements == 5:
            assert len(list(adamw._flat_slices(torch.empty(44)))) == 9   # c
    whole, sliced = ({"p": p, "s": st} for p, st, _ in out)
    for a, b in zip(adamw._leaves(whole), adamw._leaves(sliced)):
        assert torch.equal(a, b)
    assert float(out[1][2]["grad_norm"]) < 1.0
    assert float(out[0][2]["grad_norm"]) == pytest.approx(
        float(out[1][2]["grad_norm"]), rel=1e-6)


@pytest.mark.parametrize("what", ["grad", "moment", "leaves"])
def test_update_raises_on_a_mismatched_state(what):
    """A gradient or a moment of another size than its parameter, or a
    tree with another number of leaves, raises: the flat slices would
    otherwise pair elements of different leaves or stop early."""
    p = {"w": torch.zeros(4, 3)}
    st = adamw.init_opt_state(p, adamw.AdamW())
    g = {"w": torch.ones(4, 3)}
    if what == "grad":
        g = {"w": torch.ones(4, 2)}
    elif what == "moment":
        st["m"] = {"w": torch.zeros(3, 3)}
    else:
        g = {"w": torch.ones(4, 3), "x": torch.ones(1)}
    with pytest.raises(ValueError):
        adamw.adamw_update(p, g, st, 1e-3, adamw.AdamW())


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_cosine_schedule_bit_for_bit(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    want = np.asarray(jax_cosine(jnp.int32(step), **kw))
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    assert got.numpy() == want
    assert cosine_schedule(step, **kw).numpy() == want


def test_opt_state_from_reference_carries_the_state():
    jcfg = jax_reduced("qwen3-14b")
    cfg = reduced_config("qwen3-14b")
    params = jax_zoo.build_model(jcfg).table.init(jax.random.key(0))
    state = jax_adamw.init_opt_state(params, jax_adamw.AdamW())
    rng = np.random.default_rng(4)
    state = {"m": jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
                 np.float32), state["m"]),
             "v": jax.tree.map(lambda x: rng.uniform(size=x.shape).astype(
                 np.float32), state["v"]),
             "count": np.int32(7)}
    got = adamw.opt_state_from_reference(cfg, state, device="cpu")
    assert int(got["count"]) == 7 and got["count"].dtype == torch.int32
    for key in ("m", "v"):
        for w, g in zip(_np_leaves(state[key]), _port_leaves(got[key])):
            np.testing.assert_array_equal(g, w)
    bad = dict(state, m={**state["m"], "extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        adamw.opt_state_from_reference(cfg, bad, device="cpu")
