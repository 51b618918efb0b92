"""The last two configurations' train cells, on the CPU: qwen3-14b (40 q
heads padded to 48) and chatglm3-6b (rotary on half the head dim), as
``chip_smoke.py`` trains them on the card.

- The padded heads against the reference: reduced qwen3-14b keeps
  ``pad_heads_to=16`` (4 heads padded to 16, G = 8) and trains 2 steps
  in both packages from the reference's weights; the padded slices of
  wq, wo and both moments stay exact zeros in both (C-ref4: the padded
  heads' weights get the reference's gradient, zero), and the real
  slices agree within ``tests/test_torch_train.py``'s qwen3-14b
  tolerance.  The card cell's ``train_config`` at one layer holds 1.9 B
  params at full width, 30 GB of f32 state on the CPU: the card checks
  it (``chip_smoke.padded_nonzero`` after every step).
- The reference's "dots" remat through ``FlashAttentionFn``, whose
  forward fills an ``empty`` through a launch the dispatcher does not
  see: its kernels swapped for plain twins that write their outputs
  through numpy, the step-1 gradients of "dots" and "full" bit-equal to
  "none", the forward run twice a layer (B3's forward is no product
  "dots" keeps).
- Each card cell dry-run on ``meta`` (``dryrun.predict``): a predicted
  peak of at most 70 GB (a memory regression fails here before a card
  run), and its B3 calls those ``chip_smoke.train_launches`` counts."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro.configs.registry import reduced_config as jax_reduced  # noqa: E402
from repro.launch.mesh import make_mesh_of  # noqa: E402
from repro.models import model_zoo as jax_zoo  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import backward as fa_backward  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_bwd_ref  # noqa: E402
from repro_torch.models import model_zoo, transformer  # noqa: E402
from repro_torch.models.params import _flatten, params_from_reference  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

# tests/test_torch_train.py's qwen3-14b tolerance (relative for loss and
# grad norm, absolute for the params)
TOL = dict(loss=1e-6, grad_norm=1e-6, params=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_torch(tree):
    """A JAX tree as f32 torch tensors on the CPU (bf16 widens exactly)."""
    return jax.tree.map(
        lambda x: torch.from_numpy(np.array(x, dtype=np.float32)), tree)


def test_padded_heads_stay_zero_against_the_reference():
    cfg = reduced_config("qwen3-14b", microbatches=2)
    jcfg = jax_reduced("qwen3-14b", microbatches=2)
    assert (cfg.num_heads, cfg.num_heads_padded, cfg.num_kv_heads) == \
        (4, 16, 2)
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
    padded = {path: d.zero_pad for path, d in model.table.defs.items()
              if d.zero_pad is not None}
    assert sorted(padded) == ["layers/attn/wo", "layers/attn/wq"]
    rng = np.random.default_rng(5)
    for i in range(2):
        toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        jp, js, want = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(toks)})
        t = torch.from_numpy(toks).long()
        p, st, got = step(p, st, {"tokens": t, "labels": t})
        for key in ("loss", "grad_norm"):
            assert float(got[key]) == pytest.approx(
                float(want[key]), rel=TOL[key]), (i, key)
        for name, trees in (("port", {"params": p, "m": st["m"],
                                      "v": st["v"]}),
                            ("reference", {"params": _as_torch(jp),
                                           "m": _as_torch(js["m"]),
                                           "v": _as_torch(js["v"])})):
            nz = chip_smoke.padded_nonzero(model.table, trees)
            assert len(nz) == 6 and not any(nz.values()), (i, name, nz)
        # the real heads moved: their moments are not zero
        for path, (axis, real) in padded.items():
            for key in ("m", "v"):
                x = _flatten(st[key])[path].narrow(axis, 0, real)
                assert bool(x.abs().min() > 0), (i, key, path)
    # every leaf, the real heads' slices among them
    flat_j, flat_p = _flatten(_as_torch(jp)), _flatten(p)
    for path, want in flat_j.items():
        np.testing.assert_allclose(flat_p[path].numpy(), want.numpy(),
                                   rtol=0, atol=TOL["params"])


def test_padded_nonzero_counts_what_is_not_exactly_zero():
    """A NaN and a value in a padded slot count; -0 does not; the real
    heads are not read."""
    cfg = reduced_config("qwen3-14b", num_layers=1)
    table = model_zoo.build_model(cfg).table
    p = table.init(torch.Generator().manual_seed(0), "cpu")
    assert chip_smoke.padded_nonzero(table, {"p": p}) == \
        {"p/layers/attn/wq": 0, "p/layers/attn/wo": 0}
    p["layers"]["attn"]["wq"][0, 0, cfg.num_heads, 0] = -0.0
    p["layers"]["attn"]["wq"][0, 1, cfg.num_heads + 1, 2] = float("nan")
    p["layers"]["attn"]["wo"][0, -1, 0, 0] = 1e-30
    p["layers"]["attn"]["wo"][0, 0, 0, 0] = 0.0     # a real head
    assert chip_smoke.padded_nonzero(table, {"p": p}) == \
        {"p/layers/attn/wq": 1, "p/layers/attn/wo": 1}


def _np_forward(q, k, v, *, causal=True, window=None, scale=None,
                logit_cap=None, with_lse=False):
    """The forward kernel's plain twin as the CUDA wrapper runs: outputs
    from ``torch.empty``, written outside the dispatcher (through numpy,
    where the kernel writes through a pointer); f64 inside, rows with a
    valid key only (self-attention)."""
    _np_forward.calls += 1
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qn, kn, vn = (x.detach().numpy().astype(np.float64) for x in (q, k, v))
    kn, vn = np.repeat(kn, h // kh, axis=2), np.repeat(vn, h // kh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", qn, kn) * (scale or d ** -0.5)
    if logit_cap is not None:
        s = logit_cap * np.tanh(s / logit_cap)
    q_pos = np.arange(sq)[:, None] + (sk - sq if causal else 0)
    k_pos = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), dtype=bool)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    s = np.where(valid, s, -np.inf)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    l = e.sum(-1, keepdims=True)
    out = torch.empty((b, sq, h, d), dtype=q.dtype)
    out.numpy()[...] = np.einsum("bhqk,bkhd->bqhd", e / l, vn)
    if not with_lse:
        return out
    lse = torch.empty((b, h, sq), dtype=torch.float32)
    lse.numpy()[...] = (m + np.log(l))[..., 0]
    return out, lse


def _through_flash_fn(q, k, v, *, causal=True, window=None, scale=None,
                      logit_cap=None):
    """Every training attention call through ``FlashAttentionFn``, as on
    the card."""
    assert torch.is_grad_enabled()
    return fa_ops.FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                         logit_cap)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_through_flash_attention_fn_gives_none_s_gradients(
        policy, monkeypatch):
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", _np_forward)
    monkeypatch.setattr(fa_backward, "flash_attention_bwd_cuda",
                        flash_attention_bwd_ref)
    cfg = reduced_config("qwen3-14b", num_layers=2)
    params = model_zoo.build_model(cfg).table.init(
        torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks}

    def grads(policy):
        c = dataclasses.replace(cfg, remat_policy=policy)
        _np_forward.calls = 0
        g, total, _ = steps.make_grads_fn(c, model_zoo.build_model(c))(
            params, batch)
        return _flatten(g), total, _np_forward.calls

    plain, plain_total, _ = grads("none")   # the CPU's plain attention
    monkeypatch.setattr(transformer, "flash_attention", _through_flash_fn)
    want, want_total, calls = grads("none")
    assert calls == cfg.num_layers
    assert float(want_total) == pytest.approx(float(plain_total), rel=1e-6)
    got, total, calls = grads(policy)
    assert calls == 2 * cfg.num_layers == chip_smoke.train_launches(
        dataclasses.replace(cfg, remat_policy=policy), 1)["flash_attention"]
    assert torch.equal(total, want_total)
    for path, g in got.items():
        assert torch.equal(g, want[path]), path
        scale = float(plain[path].abs().max())
        assert float((g - plain[path]).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("arch,layers,microbatches", [
    ("qwen3-14b", 8, 8), ("chatglm3-6b", 18, 4)])
def test_card_cells_dry_run_within_the_card(arch, layers, microbatches):
    """The cells' dry run on ``meta`` (``chip_smoke``'s
    ``dryrun_predict``): 67.57 and 67.36 GB on this CPU's torch, a layer
    more 72.8 and 74.0; the card's torch read within a few GB of the
    CPU's on earlier cells."""
    from repro_torch.launch import dryrun
    cfg = chip_smoke.train_config(arch)
    spec = chip_smoke.TRAIN_ARCHS[arch]
    assert (cfg.num_layers, cfg.microbatches, cfg.remat_segments,
            cfg.remat_policy) == (layers, microbatches, 0, "full")
    assert (spec["batch"], spec["steps"]) == (8, 2)
    record, _ = dryrun.predict(cfg, dryrun.cell(
        "train", spec.get("seq", chip_smoke.TRAIN_SEQ), spec["batch"]))
    assert record["predicted_peak_bytes"] <= 70e9
    # the gate's largest peak after step 1 stays under its cap
    assert record["predicted_peak_bytes"] * chip_smoke.PEAK_RATIO[1] <= \
        chip_smoke.PEAK_MAX_GB * 1e9
    want = chip_smoke.train_launches(cfg, 1)
    assert record["kernel_launches"] == {
        "flash_attention.wgmma": want["flash_attention.wgmma"],
        "flash_attention_bwd.wgmma": want["flash_attention_bwd.wgmma"]}
