"""The port's training stack against the JAX package's, on the CPU.

- ``make_train_step``: reduced qwen3-14b and reduced starcoder2-3b in f32,
  one and two microbatches, three steps from the reference's weights and
  optimizer state (``params_from_reference``, ``opt_state_from_reference``)
  on the same numpy-seeded batches: loss, grad norm and params against the
  reference's ``make_train_step``.  qwen3-14b (qk-norm) is held tight:
  loss and grad norm within 1e-6 relative, params within 2e-5 (AdamW's
  first steps move an element by about lr * g / |g|, so an element with a
  near-zero gradient turns a last-bit difference of g into a visible
  one; lr is 3e-4).  starcoder2-3b has no qk-norm: the reference's
  initialisation (C-ref5) gives it nearly hard softmaxes and a grad norm
  of ~500, where sums in another order already differ by 2e-4 at the
  first step and the difference grows; loss within 2e-5 relative, grad
  norm within 3e-2, params within 1.1e-3 (three AdamW steps of lr).
- remat ("full", "dots", segments) gives the gradients of the plain loop
  bit for bit, and serving (grad mode off) runs no checkpoint.
- the ``Trainer`` in the scenarios of the reference's
  ``tests/test_trainer.py``: it learns and checkpoints; a restart resumes
  (and ends with the bits of the uninterrupted run); a data node dying
  mid-run keeps the batches flowing (and the losses of a calm run).
- ``launch/train.py --reduced --device cpu`` trains; ``--production-mesh``
  raises.  The other eight architectures' train steps are held in
  ``tests/test_torch_train_archs.py``."""
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
from repro_torch.launch import train as train_launch
from repro_torch.models import model_zoo
from repro_torch.models.params import params_from_reference
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ops here are small: one intra-op thread, so that the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = {"qwen3-14b": dict(loss=1e-6, grad_norm=1e-6, params=2e-5),
       "starcoder2-3b": dict(loss=2e-5, grad_norm=3e-2, params=1.1e-3)}


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("arch", sorted(TOL))
def test_train_step_matches_the_reference(arch, m):
    tol = TOL[arch]
    jcfg, cfg = jax_reduced(arch, microbatches=m), \
        reduced_config(arch, microbatches=m)
    jmodel, model = jax_zoo.build_model(jcfg), model_zoo.build_model(cfg)
    jp = jmodel.table.init(jax.random.key(0))
    js = jax_adamw.init_opt_state(jp, jax_adamw.AdamW())
    jstep, _ = jax_steps.make_train_step(
        jcfg, jmodel, make_mesh_of((1, 1), ("data", "model")),
        jax_adamw.AdamW(), lr=3e-4)
    jstep = jax.jit(jstep)
    p = params_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    st = adamw.opt_state_from_reference(cfg, jax.tree.map(np.asarray, js),
                                        "cpu")
    step = steps.make_train_step(cfg, model, adamw.AdamW(), lr=3e-4)
    rng = np.random.default_rng(1)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        jp, js, want = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(toks)})
        t = torch.from_numpy(toks).long()
        p, st, got = step(p, st, {"tokens": t, "labels": t})
        for key in ("loss", "grad_norm"):
            assert float(got[key]) == pytest.approx(
                float(want[key]), rel=tol[key]), (i, key)
        assert float(got["total_loss"]) == pytest.approx(
            float(want["total_loss"]), rel=tol["loss"])
    assert int(st["count"]) == 3
    for w, g in zip(jax.tree.leaves(jp), adamw._leaves(p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol["params"])


def test_cross_entropy_masks_the_padded_vocab():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 256)).astype(np.float32)
    labels = rng.integers(0, 200, (2, 5)).astype(np.int32)
    want = float(jax_steps.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), 200))
    got = float(steps.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels).long(), 200))
    assert got == pytest.approx(want, rel=1e-6)


def test_prefill_and_decode_steps_match_the_reference():
    """The serve steps are thin wrappers over the ported model: the last
    position's logits of a prefill, then one decode step's, against the
    reference's ``make_prefill_step`` / ``make_decode_step`` (f32, qk-norm:
    1e-4 as tests/test_torch_lm.py)."""
    jcfg, cfg = jax_reduced("qwen3-14b"), reduced_config("qwen3-14b")
    jmodel, model = jax_zoo.build_model(jcfg), model_zoo.build_model(cfg)
    jp = jmodel.table.init(jax.random.key(0))
    p = params_from_reference(cfg, jax.tree.map(np.asarray, jp), "cpu")
    mesh = make_mesh_of((1, 1), ("data", "model"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jprefill, shd = jax_steps.make_prefill_step(jcfg, jmodel, mesh)
    want = jprefill(jp, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg, model)(
        p, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    jdecode, _ = jax_steps.make_decode_step(jcfg, jmodel, mesh)
    want, _ = jdecode(jp, jmodel.init_cache(shd, 2, 8),
                      {"tokens": jnp.asarray(toks[:, :1])})
    got, cache = steps.make_decode_step(cfg, model)(
        p, model.init_cache(2, 8, "cpu"),
        {"tokens": torch.from_numpy(toks[:, :1]).long()})
    assert cache["t"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _grads(cfg, params, toks):
    g, total, _ = steps.make_grads_fn(cfg, model_zoo.build_model(cfg))(
        params, {"tokens": toks, "labels": toks})
    return adamw._leaves(g), total


@pytest.mark.parametrize("arch,over,checkpoints", [
    ("qwen3-14b", dict(remat_policy="full"), 4),
    ("qwen3-14b", dict(remat_policy="dots"), 4),
    # 2 segments around the 4 layers, whose checkpoints run again when the
    # backward recomputes each segment
    ("qwen3-32b", dict(remat_policy="full", remat_segments=2), 2 + 4 + 4),
])
def test_remat_gives_the_plain_loops_gradients(arch, over, checkpoints,
                                               monkeypatch):
    from torch.utils import checkpoint as ckpt
    cfg = reduced_config(arch, **over)
    params = model_zoo.build_model(cfg).table.init(
        torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, total = _grads(cfg, params, toks)
    assert cfg.num_layers == 4 and len(calls) == checkpoints
    want, want_total = _grads(dataclasses.replace(cfg, remat_policy="none",
                                                  remat_segments=0),
                              params, toks)
    assert torch.equal(total, want_total)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    calls.clear()
    with torch.no_grad():      # serving: no checkpoint
        model_zoo.build_model(cfg).forward(params, {"tokens": toks})
    assert not calls


# --------------------------- the trainer --------------------------------- #
def _trainer(tmp_path, total_steps=12, failure_hook=None, name="ckpt"):
    """The reference's test_trainer.py set-up, on the CPU."""
    cfg = reduced_config("qwen3-14b", microbatches=1)
    tcfg = TrainerConfig(total_steps=total_steps, ckpt_every=5,
                         ckpt_dir=str(tmp_path / name), global_batch=4,
                         seq_len=32, log_every=2, async_ckpt=False)
    return Trainer(cfg, tcfg, device="cpu", failure_hook=failure_hook)


def _state_leaves(trainer):
    params, opt_state = trainer.state
    return adamw._leaves({"p": params, "s": opt_state})


def test_trainer_runs_and_checkpoints(tmp_path):
    from repro_torch.checkpoint.ckpt import latest_step
    tr = _trainer(tmp_path)
    out = tr.train()
    assert out["steps"] == 12
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0]   # learns the synthetic stream a bit
    assert latest_step(tmp_path / "ckpt") == 12


def test_trainer_restart_resumes_with_the_uninterrupted_bits(tmp_path):
    tr = _trainer(tmp_path, total_steps=6)
    tr.train()
    tr2 = _trainer(tmp_path, total_steps=10)
    out = tr2.train()
    assert out["steps"] == 4     # resumed from step 6, ran 4 more
    whole = _trainer(tmp_path, total_steps=10, name="whole")
    whole.train()
    for a, b in zip(_state_leaves(tr2), _state_leaves(whole)):
        assert torch.equal(a, b)


def test_trainer_survives_data_node_failure(tmp_path):
    kills = {4: 1}
    tr = _trainer(tmp_path, failure_hook=lambda step: kills.pop(step, None))
    out = tr.train()
    assert out["steps"] == 12    # no crash, batches kept flowing
    assert 1 in tr.catalog.dead_nodes()
    calm = _trainer(tmp_path, name="calm")
    calm.train()
    assert tr.history == calm.history


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = train_launch.main(["--arch", "qwen3-14b", "--reduced", "--device",
                             "cpu", "--steps", "3", "--ckpt-every", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    assert "done (cpu)" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000003"]


def test_production_mesh_raises():
    with pytest.raises(RuntimeError, match="256 devices"):
        train_launch.main(["--arch", "qwen3-14b", "--reduced",
                           "--production-mesh", "--device", "cpu"])


def test_train_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--arch", "qwen3-14b", "--reduced", "--steps",
                           "1"])
