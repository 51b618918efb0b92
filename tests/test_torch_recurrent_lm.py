"""The port's recurrent LM families against the JAX package's, on the CPU:
the hybrid recurrentgemma-9b (RG-LRU + local attention) and xlstm-350m
(mLSTM + sLSTM).

The JAX parameters are carried across with ``params_from_reference``; the
same numpy-seeded tokens then go through both packages' ``forward``,
teacher-forced ``decode_step`` (past the end of recurrentgemma's ring of
16 slots, the reduced attention window, so it wraps) and ``generate``, in
float32, for the reduced configs: recurrentgemma with 4 layers (one
(rec, rec, attn) super-block and a rec tail), xlstm with (mlstm, slstm) x
2.

Logit tolerance by the dense tests' rule (``tests/test_torch_lm.py``):
recurrentgemma has no qk-norm, so the reference's initialisation (C-ref5:
``wq`` drawn at 1/sqrt(Hp)) makes its local attention nearly hard and a
one-ulp difference in a dot grows through the layers: 2e-3 absolute on
logits of magnitude ~5.  xlstm has no attention; its float32 sums differ
only in order between XLA and PyTorch: 1e-4.  Generated tokens must be
equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_mesh_of
from repro.models import hybrid as jax_hybrid
from repro.models import model_zoo as jax_zoo
from repro.models import xlstm as jax_xlstm
from repro.parallel.sharding import Sharder
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import hybrid, model_zoo, xlstm
from repro_torch.models import params as params_lib
from repro_torch.models.params import params_from_reference

ARCHS = ("recurrentgemma-9b", "xlstm-350m")
TABLES = {"recurrentgemma-9b": (hybrid.param_table, jax_hybrid.param_table),
          "xlstm-350m": (xlstm.param_table, jax_xlstm.param_table)}
ATOL = {"recurrentgemma-9b": 2e-3, "xlstm-350m": 1e-4}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(port cfg, port model, port params, JAX cfg, model, params, shd)."""
    arch = request.param
    jcfg = jax_reduced(arch)
    jmodel = jax_zoo.build_model(jcfg)
    jparams = jmodel.table.init(jax.random.key(0))
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    cfg = reduced_config(arch)
    model = model_zoo.build_model(cfg)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return cfg, model, params, jcfg, jmodel, jparams, shd


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_reduced_configs_keep_both_block_kinds():
    rg = reduced_config("recurrentgemma-9b")
    assert hybrid._pattern(rg) == (("rec", "rec", "attn"), 1, ("rec",))
    assert rg.attention_window == 16
    xl = reduced_config("xlstm-350m")
    assert xlstm._pattern(xl) == (("mlstm", "slstm"), 2)


def test_forward_logits(pair):
    """24 tokens: past recurrentgemma's reduced window of 16."""
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 24, 1)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, shd)
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, 24, cfg.vocab_padded)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL[cfg.name])


def test_decode_logits_teacher_forced_past_the_ring(pair):
    """20 steps; recurrentgemma's cache has min(32, 16) = 16 ring slots, so
    the ring wraps and the port's filled-prefix call meets the reference's
    full-ring call with overwritten slots.  The recurrent states must
    agree too."""
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 20, 2)
    jcache = jmodel.init_cache(shd, 2, 32)
    cache = model.init_cache(2, 32, "cpu")
    assert set(cache) == set(jcache)
    for key in cache:
        if key != "t":
            assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
    for s in range(toks.shape[1]):
        tok = toks[:, s:s + 1]
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          shd)
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL[cfg.name], err_msg=f"step {s}")
    assert cache["t"] == int(jcache["t"]) == 20
    for key in cache:
        if key == "t":
            continue
        if key == "kpos":
            np.testing.assert_array_equal(cache[key].numpy(),
                                          np.asarray(jcache[key]))
        else:
            np.testing.assert_allclose(
                cache[key].numpy(), np.asarray(jcache[key]), rtol=1e-3,
                atol=ATOL[cfg.name] * 10, err_msg=key)


def test_generate_tokens(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    prompt = _tokens(cfg, 2, 5, 3)
    want = jax_serve.generate(jcfg, jmodel, jparams, shd,
                              jnp.asarray(prompt), max_new_tokens=6)
    got = serve.generate(cfg, model, params,
                         torch.from_numpy(prompt).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_equals_teacher_forced_decode(pair):
    """Inside the port: the full-sequence forward (scan, chunkwise mLSTM,
    windowed attention) against decode token by token (step, recurrent
    mLSTM, ring)."""
    cfg, model, params, *_ = pair
    toks = torch.from_numpy(_tokens(cfg, 2, 20, 4)).long()
    logits, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 32, "cpu")
    for s in range(toks.shape[1]):
        step, cache = model.decode_step(params, cache, toks[:, s:s + 1])
        torch.testing.assert_close(step[:, 0], logits[:, s], rtol=0,
                                   atol=ATOL[cfg.name] * 10)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_matches_the_reference_at_full_width(arch):
    """Every path with its shape, roles, init rule, scale and dtype, at the
    published widths."""
    ours_fn, ref_fn = TABLES[arch]
    ours = ours_fn(get_config(arch))
    ref = ref_fn(jax_get_config(arch))
    assert {p: dataclasses.astuple(d) for p, d in ours.defs.items()} == \
        {p: dataclasses.astuple(d) for p, d in ref.defs.items()}
    assert ours.bytes() == ref.bytes()


@pytest.mark.parametrize("arch,count", [("recurrentgemma-9b", 8_578_519_040),
                                        ("xlstm-350m", 330_420_392)])
def test_full_width_parameter_counts(arch, count):
    table = model_zoo.build_model(get_config(arch)).table
    assert table.num_params() == count
    assert table.bytes() == 2 * count       # bf16


def test_lru_a_draws_inside_the_reference_range():
    """``lam = log(exp(-8 log u) - 1)`` with ``u ~ U(0.9, 0.999)``, as the
    reference draws it; the range and the mean agree with its draws."""
    cfg = reduced_config("recurrentgemma-9b", lru_width=4096)
    table = hybrid.param_table(cfg)
    params = table.init(torch.Generator().manual_seed(0), "cpu")
    lam = params["blocks"]["u0"]["rec"]["lam"].double()
    lo = np.log(np.exp(-8 * np.log(0.999)) - 1)
    hi = np.log(np.exp(-8 * np.log(0.9)) - 1)
    assert float(lam.min()) >= lo - 1e-5 and float(lam.max()) <= hi + 1e-5
    ref = np.asarray(jax_zoo.build_model(jax_reduced(
        "recurrentgemma-9b", lru_width=4096)).table.init(jax.random.key(0))[
        "blocks"]["u0"]["rec"]["lam"], dtype=np.float64)
    assert abs(float(lam.mean()) - ref.mean()) < 0.05
    assert abs(float(lam.min()) - ref.min()) < 0.1
    assert abs(float(lam.max()) - ref.max()) < 0.1
    # softplus(lam) = -8 log u, and the gate multiplies by 8 again: the
    # decay at r = 1 is a = exp(-8 softplus(lam)) = u^64 (C-ref6)
    a = torch.exp(-8 * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 ** 64 * (1 - 1e-4)
    assert float(a.max()) <= 0.999 ** 64 * (1 + 1e-4)


def test_init_keeps_the_reference_scale_quirks():
    """C-ref6: ``fan_in`` ignores ``scale`` (sLSTM ``r_*`` at 1/sqrt(hd),
    not 0.01) and ``ones`` ignores it (mLSTM ``b_f`` is 1, not 3)."""
    cfg = reduced_config("xlstm-350m", d_model=256)
    params = xlstm.param_table(cfg).init(torch.Generator().manual_seed(0),
                                         "cpu")
    _, _, _, _, hd = xlstm._dims(cfg)
    r_z = params["blocks"]["u1"]["r_z"]
    assert abs(float(r_z.std()) * hd ** 0.5 - 1) < 0.05
    assert torch.equal(params["blocks"]["u0"]["b_f"],
                       torch.ones_like(params["blocks"]["u0"]["b_f"]))
    assert torch.equal(params["blocks"]["u1"]["b_f"],
                       torch.ones_like(params["blocks"]["u1"]["b_f"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_language_model_module_serves_the_family(arch):
    cfg = reduced_config(arch)
    model = model_zoo.build_model(cfg)
    lm = model_zoo.LanguageModel(
        model, model.table.init(torch.Generator().manual_seed(0), "cpu"))
    assert {n for n, _ in lm.named_parameters()} == \
        {f"weights.{p}" for p in model.table.defs}
    assert set(params_lib._flatten(lm.tree())) == set(model.table.defs)
    assert not any(p.requires_grad for p in lm.parameters())
    toks = torch.from_numpy(_tokens(cfg, 1, 6, 5)).long()
    logits, _ = lm(toks)
    want, _ = model.forward(lm.tree(), {"tokens": toks})
    assert torch.equal(logits, want)
    cache = lm.init_cache(1, 8)
    for s in range(6):
        step, cache = lm.decode_step(cache, toks[:, s:s + 1])
    torch.testing.assert_close(step[:, 0], logits[:, -1], rtol=0,
                               atol=ATOL[arch] * 10)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_launcher_on_the_cpu(arch, capsys):
    tokens = serve.main(["--mode", "lm", "--arch", arch, "--reduced",
                         "--device", "cpu", "--batch", "1",
                         "--prompt-len", "3", "--new-tokens", "4"])
    assert tuple(tokens.shape) == (1, 4)
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "tok/s" in out
