"""The training state that only grok-1 and qwen3-32b use, on the CPU,
against the JAX package: bf16 moments and a bf16 gradient sum (grok-1's
``opt_moment_dtype`` and ``grad_accum_dtype``), and two-level remat
(``remat_segments``, ``transformer.run_layers``).

- ``adamw_update`` on bf16 params with bf16 (and f32) moments over five
  steps from the same gradients under the clip: params, both moments and
  the count bit for bit (each moment rounded once, as the reference's
  ``m_new.astype(m.dtype)``); its f32 temporaries a flat slice at a time,
  within a layer too (one grok-1 layer's expert leaf is 1.61 B elements).
- ``make_grads_fn``'s bf16 sum over 2 microbatches: bit for bit the
  reference's ``(0 + g_1) + g_2`` in bf16, then ``/ 2``, evaluated in JAX
  on the port's own microbatch gradients, the f32 router's cast to bf16
  before each add.
- One ``make_train_step`` of reduced grok-1 in bf16 with 2 microbatches
  from the reference's weights on the same batch: loss, total loss and
  grad norm against the reference's step within ``GROK_BF16_TOL`` (about
  three times the reading beside it); the moments bit for bit, and the
  params but for a share of elements one bf16 ulp apart, against the
  reference's AdamW on the port's own gradient sum.
- Reduced qwen3-32b and grok-1 with 2 remat segments of 2 layers: the
  gradients bit for bit those with no segment (one intra-op thread: the
  embedding's backward adds in a thread-dependent order with more), and
  qwen3-32b's step within ``tests/test_torch_train_archs.py``'s
  tolerances of the reference's step, which runs its own two-level
  remat."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as jax_reduced
from repro.launch.mesh import make_mesh_of
from repro.models import model_zoo as jax_zoo
from repro.optim import adamw as jax_adamw
from repro.train import steps as jax_steps
from repro_torch.configs.registry import reduced_config
from repro_torch.models import model_zoo
from repro_torch.models.params import _flatten, params_from_reference
from repro_torch.optim import adamw
from repro_torch.train import steps
from test_torch_train_archs import TOL as ARCH_TOL

GROK = "grok-1-314b"
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16", microbatches=2)
# Reduced grok-1 in bf16: (loss and total loss, grad norm: relative to
# the reference's step; the share of param elements that differ from the
# reference's update of the same weights by the port's gradients), about
# three times the reading on the CPU in the comment.  The two packages'
# bf16 forwards round their activations in other orders (XLA fuses, the
# port runs op by op), and at the reference's initialisation (C-ref5) a
# rounding flips expert choices and near-hard softmaxes: the reference's
# own gradients move by 0.19-1.2 of each leaf's largest value, and its
# grad norm by 6.0 % (34.03 to 36.08), when 1 % of its embedding entries
# move by one bf16 ulp.  So the loss is held tight, the grad norm only to
# its size, and the update is held on the port's own gradients: moments
# bit for bit, params but the elements that the clip factor's last bit
# (the norm's squares summed in f64, C-ref13) moves by one ulp.
# Readings: 8.8e-5, 5.5e-2, 7.4e-6 (25 of 3,379,328 elements)
GROK_BF16_TOL = (3e-4, 0.17, 2.2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
def test_adamw_on_bf16_params_bit_for_bit(moment_dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (3, 5, 7), "b": (7,)}, "c": (11, 4)}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) for k, v in s.items()} if isinstance(s, dict) \
            else fn(s)

    params = tree(lambda s: rng.normal(size=s).astype(np.float32))
    opt_j = jax_adamw.AdamW(moment_dtype=moment_dtype)
    opt_t = adamw.AdamW(moment_dtype=moment_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    js = jax_adamw.init_opt_state(jp, opt_j)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                      params)
    ts = adamw.init_opt_state(tp, opt_t)
    for _ in range(5):
        g = tree(lambda s: (0.05 * rng.normal(size=s) *
                            10 ** rng.uniform(-6, 0, size=s))
                 .astype(np.float32))
        jp, js, jm = jax_adamw.adamw_update(
            jp, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g), js,
            3e-4, opt_j)
        tp, ts, tm = adamw.adamw_update(
            tp, jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                             g), ts, 3e-4, opt_t)
        assert float(jm["grad_norm"]) < 1.0     # the clip factor is 1
    for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for w, t in zip(jax.tree.leaves(want), adamw._leaves(got)):
            assert str(t.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_f32(t), _f32(w))
    assert int(ts["count"]) == int(js["count"]) == 5


def test_adamw_temporaries_stay_within_a_slice_of_one_layer():
    """One grok-1 layer's expert leaf is (1, 8, 6144, 32768): 1.61 B
    elements on a layer axis of 1.  The update's f32 temporaries come a
    flat slice of ``SLICE_ELEMENTS`` at a time, within a layer too (the
    dry run's temp bytes on ``meta``, a leaf of 3 x 2^26 elements in one
    row): slicing the layer axis alone took six f32 temporaries of the
    whole row, 6.44 GB each for grok-1."""
    from repro_torch.launch.dryrun import OpTrace
    shape = (1, 3, 1 << 26)
    p = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    opt = adamw.AdamW(moment_dtype="bfloat16")
    st = adamw.init_opt_state({"w": p}, opt)
    g = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    trace = OpTrace()
    trace.arguments(({"w": p}, {"w": g}, st))
    with trace.recording():
        adamw.adamw_update({"w": p}, {"w": g}, st, 3e-4, opt)
    # about eight f32 temporaries of one slice live at once (the parent's
    # 8 of the whole row: 6.4 GB here)
    assert p.numel() == 3 * adamw.SLICE_ELEMENTS
    assert trace.memory()["temp_size_in_bytes"] <= \
        9 * 4 * adamw.SLICE_ELEMENTS


def test_bf16_sum_over_microbatches_in_the_reference_order():
    cfg = reduced_config(GROK, **BF16)
    assert (cfg.grad_accum_dtype, cfg.opt_moment_dtype) == ("bfloat16",
                                                            "bfloat16")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    batch = _port_batch(_batch(cfg))
    got, _, _ = steps.make_grads_fn(cfg, model)(params, batch)
    one = steps.make_grads_fn(dataclasses.replace(cfg, microbatches=1),
                              model)
    parts = [one(params, {k: x[i * 2:(i + 1) * 2] for k, x in batch.items()})
             [0] for i in range(2)]
    got, parts = _flatten(got), [_flatten(p) for p in parts]
    dtypes = {path: t.dtype for path, t in _flatten(params).items()}
    assert set(dtypes.values()) == {torch.bfloat16, torch.float32}
    for path, g in got.items():
        assert g.dtype == torch.bfloat16, path
        acc = jnp.zeros(g.shape, jnp.bfloat16)
        for p in parts:
            # one microbatch's gradient in its param's dtype (the f32 sum
            # of one microbatch holds it exactly), cast to the bf16 sum's
            # dtype before the add: the reference's a + b.astype(acc_dt)
            assert torch.equal(p[path], p[path].to(dtypes[path]).float())
            acc = acc + jnp.asarray(_f32(p[path])).astype(jnp.bfloat16)
        np.testing.assert_array_equal(_f32(g), _f32(acc / 2), err_msg=path)


def test_grok1_bf16_train_step_matches_the_reference():
    """One ``make_train_step`` of reduced grok-1 in bf16 (2 microbatches,
    bf16 moments and sum) from the reference's weights on the same batch.
    The loss and total loss against the reference's step, the grad norm
    too (GROK_BF16_TOL); params and moments against the reference's
    ``adamw_update`` on the port's own gradient sum (those of the whole
    steps part by the gradients' chaos, GROK_BF16_TOL's comment)."""
    jcfg, cfg = jax_reduced(GROK, **BF16), reduced_config(GROK, **BF16)
    jmodel, model = jax_zoo.build_model(jcfg), model_zoo.build_model(cfg)
    jp = jmodel.table.init(jax.random.key(0))
    opt = jax_adamw.AdamW(moment_dtype=jcfg.opt_moment_dtype)
    js = jax_adamw.init_opt_state(jp, opt)
    assert {str(x.dtype) for x in jax.tree.leaves(js["m"])} == {"bfloat16"}
    jstep, _ = jax_steps.make_train_step(
        jcfg, jmodel, make_mesh_of((1, 1), ("data", "model")), lr=3e-4)
    p = params_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    st = adamw.init_opt_state(p, adamw.AdamW(
        moment_dtype=cfg.opt_moment_dtype))
    batch = _batch(cfg)
    _, _, want = jax.jit(jstep)(jp, js, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    grads, _, _ = steps.make_grads_fn(cfg, model)(p, _port_batch(batch))
    p, st, got = steps.make_train_step(cfg, model, lr=3e-4)(
        p, st, _port_batch(batch))
    loss_tol, norm_tol, flip_tol = GROK_BF16_TOL
    for key, tol in (("loss", loss_tol), ("total_loss", loss_tol),
                     ("grad_norm", norm_tol)):
        assert abs(float(got[key]) - float(want[key])) <= \
            tol * abs(float(want[key])), key
    # the reference's update of the same weights by the port's gradients
    jg = jax.tree.map(lambda g, w: jnp.asarray(_f32(g), w.dtype), grads, jp)
    jp, js, jm = jax_adamw.adamw_update(jp, jg, js, 3e-4, opt)
    assert float(jm["grad_norm"]) > 1.0          # the step clips
    assert float(got["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                    rel=1e-6)
    for want_tree, got_tree in ((js["m"], st["m"]), (js["v"], st["v"])):
        for w, g in zip(jax.tree.leaves(want_tree), adamw._leaves(got_tree)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_f32(g), _f32(w))
    # the clip factor's relative gap moves a step of ~lr by lr times it
    norm_gap = abs(float(got["grad_norm"]) / float(jm["grad_norm"]) - 1)
    shift = 2 * 3e-4 * max(norm_gap, 2.0 ** -24)
    flips = total = 0
    for w, g in zip(jax.tree.leaves(jp), adamw._leaves(p)):
        dtype = str(w.dtype)
        assert str(g.dtype).split(".")[-1] == dtype
        w, g = _f32(w), _f32(g)
        total += w.size
        apart = g != w
        flips += int(apart.sum())
        # one unit in the last place of the larger of the two values, and
        # the clip's shift (an f32 leaf's ulp can be smaller)
        bits = {"bfloat16": 7, "float32": 23}[dtype]
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.abs(w[apart]), np.abs(g[apart])))) - bits)
        assert (np.abs(g - w)[apart] <= ulp + shift).all(), dtype
    assert flips <= flip_tol * total


@pytest.mark.parametrize("arch", ["qwen3-32b", GROK])
def test_two_level_remat_gives_the_gradients_of_no_segment(arch):
    cfg = reduced_config(arch, microbatches=2)
    assert (cfg.num_layers, cfg.remat_segments, cfg.remat_policy) == \
        (4, 2, "full")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    batch = _port_batch(_batch(cfg))
    runs = []
    for g in (2, 0):
        c = dataclasses.replace(cfg, remat_segments=g)
        runs.append(steps.make_grads_fn(c, model_zoo.build_model(c))(
            params, batch))
    (seg, seg_total, seg_met), (flat, flat_total, flat_met) = runs
    assert torch.equal(seg_total, flat_total)
    assert all(torch.equal(seg_met[k], flat_met[k]) for k in seg_met)
    for path, g in _flatten(seg).items():
        assert torch.equal(g, _flatten(flat)[path]), path


def test_two_level_remat_step_matches_the_reference():
    """Reduced qwen3-32b in f32, 2 microbatches, 2 remat segments in both
    packages: one step's loss and grad norm (relative) and params
    (absolute) within qwen3-32b's tolerances in
    ``tests/test_torch_train_archs.py``."""
    arch = "qwen3-32b"
    jcfg = jax_reduced(arch, microbatches=2)
    cfg = reduced_config(arch, microbatches=2)
    assert jcfg.remat_segments == cfg.remat_segments == 2
    jmodel, model = jax_zoo.build_model(jcfg), model_zoo.build_model(cfg)
    jp = jmodel.table.init(jax.random.key(0))
    js = jax_adamw.init_opt_state(jp, jax_adamw.AdamW())
    jstep, _ = jax_steps.make_train_step(
        jcfg, jmodel, make_mesh_of((1, 1), ("data", "model")), lr=3e-4)
    p = params_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    st = adamw.init_opt_state(p, adamw.AdamW())
    batch = _batch(cfg)
    jp, js, want = jax.jit(jstep)(jp, js, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    p, st, got = steps.make_train_step(cfg, model, lr=3e-4)(
        p, st, _port_batch(batch))
    loss_tol, norm_tol, _, param_tol = ARCH_TOL[arch]
    for key, tol in (("loss", loss_tol), ("total_loss", loss_tol),
                     ("grad_norm", norm_tol)):
        assert abs(float(got[key]) - float(want[key])) <= \
            tol * abs(float(want[key])), key
    gap = max(float(np.abs(_f32(g) - _f32(w)).max())
              for w, g in zip(jax.tree.leaves(jp), adamw._leaves(p)))
    assert gap <= param_tol
