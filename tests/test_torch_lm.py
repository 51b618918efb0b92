"""The port's dense LM against the JAX package's, on the CPU.

The JAX parameters are carried across with ``params_from_reference``;
the same numpy-seeded tokens then go through both packages' ``forward``,
teacher-forced ``decode_step`` (past the end of the ring, so it wraps) and
``generate``, in float32, for the reduced config of every dense config
without experts and for one config with qwen3-14b's full head geometry.

Tolerance: float32, 1e-4 absolute on logits of magnitude ~5 where the
config has qk-norm.  Without qk-norm (starcoder2, chatglm3) the reference's
initialisation (C-ref5: ``wq`` drawn at 1/sqrt(Hp)) gives attention scores
of ~1e2, so each softmax is nearly hard and a one-ulp difference in a dot
(XLA's and PyTorch's CPU sums run in another order) grows through the
layers: 2e-3 there.  Generated tokens must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as jax_reduced
from repro.launch import serve as jax_serve
from repro.launch.mesh import make_mesh_of
from repro.models import model_zoo as jax_zoo
from repro.models import transformer as jax_transformer
from repro.parallel.sharding import Sharder
from repro_torch.configs.registry import get_config, list_archs, \
    reduced_config
from repro_torch.launch import serve
from repro_torch.models import model_zoo, transformer
from repro_torch.models import params as params_lib
from repro_torch.models.params import params_from_reference

# (arch, overrides): every dense config without experts, reduced, and
# qwen3-14b's full head geometry (40 -> 48 padded q heads over 8 of 128)
CASES = {
    "qwen3-14b": ("qwen3-14b", {}),
    "qwen3-32b": ("qwen3-32b", {}),
    "starcoder2-3b": ("starcoder2-3b", {}),
    "chatglm3-6b": ("chatglm3-6b", {}),
    "qwen3-14b-heads": ("qwen3-14b", dict(num_heads=40, num_kv_heads=8,
                                          head_dim=128, num_layers=2,
                                          d_model=256, d_ff=512)),
}
DENSE = [a for a in list_archs() if get_config(a).family == "dense"
         and not get_config(a).num_experts]


def _atol(cfg):
    return 1e-4 if cfg.qk_norm else 2e-3


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(port cfg, port model, port params, JAX cfg, model, params, shd)."""
    arch, over = CASES[request.param]
    jcfg = jax_reduced(arch, **over)
    jmodel = jax_zoo.build_model(jcfg)
    jparams = jmodel.table.init(jax.random.key(0))
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    cfg = reduced_config(arch, **over)
    model = model_zoo.build_model(cfg)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return cfg, model, params, jcfg, jmodel, jparams, shd


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 16, 1)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, shd)
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, 16, cfg.vocab_padded)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_atol(cfg))


def test_decode_logits_teacher_forced_past_the_ring(pair):
    """12 steps over a ring of 8 slots (a windowed config: min(8, window)
    slots), so the ring wraps and the port's filled-prefix call meets the
    reference's full-ring call with empty and overwritten slots."""
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 12, 2)
    jcache = jmodel.init_cache(shd, 2, 8)
    cache = model.init_cache(2, 8, "cpu")
    assert cache["k"].shape == tuple(jcache["k"].shape)
    for s in range(toks.shape[1]):
        tok = toks[:, s:s + 1]
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          shd)
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=_atol(cfg), err_msg=f"step {s}")
    assert cache["t"] == int(jcache["t"]) == 12
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=_atol(cfg) * 10)


def test_generate_tokens(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    prompt = _tokens(cfg, 2, 5, 3)
    want = jax_serve.generate(jcfg, jmodel, jparams, shd,
                              jnp.asarray(prompt), max_new_tokens=6)
    got = serve.generate(cfg, model, params,
                         torch.from_numpy(prompt).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE)
def test_param_table_matches_the_reference_at_full_width(arch):
    """Every path of ``transformer.param_table`` with its shape, roles,
    init rule and head padding, at the published widths."""
    from repro.configs.registry import get_config as jax_get_config
    ours = transformer.param_table(get_config(arch))
    ref = jax_transformer.param_table(jax_get_config(arch))
    assert {p: dataclasses.astuple(d) for p, d in ours.defs.items()} == \
        {p: dataclasses.astuple(d) for p, d in ref.defs.items()}
    assert ours.num_params() == ref.num_params()
    assert ours.bytes() == ref.bytes()


def test_qwen3_14b_size():
    table = transformer.param_table(get_config("qwen3-14b"))
    assert table.num_params() == 15_189_048_320   # 30.38 GB in bf16
    assert table.bytes() == 2 * table.num_params()


def test_init_zero_pads_heads_and_draws_fan_in_at_reference_scale():
    cfg = reduced_config("qwen3-14b", **CASES["qwen3-14b-heads"][1])
    table = transformer.param_table(cfg)
    gen = torch.Generator().manual_seed(0)
    params = table.init(gen, "cpu")
    flat = params_lib._flatten(params)
    assert set(flat) == set(table.defs)
    for path, d in table.defs.items():
        assert tuple(flat[path].shape) == d.shape, path
        assert flat[path].dtype == table.dtype(d), path

    attn = params["layers"]["attn"]
    wq, wo = attn["wq"], attn["wo"]         # (L, d, 48, 128), (L, 48, 128, d)
    assert not bool(wq[:, :, 40:].any()) and not bool(wo[:, 40:].any())
    assert bool(wq[:, :, :40].all()) and bool(wo[:, :40].all())
    # C-ref5: fan_in reads shape[-2]: Hp = 48 for wq, hd = 128 for wo
    jparams = jax_zoo.build_model(jax_reduced(
        "qwen3-14b", **CASES["qwen3-14b-heads"][1])).table.init(
        jax.random.key(0))
    for name, real, scale in (("wq", wq[:, :, :40], 48 ** -0.5),
                              ("wo", wo[:, :40], 128 ** -0.5),
                              ("wk", attn["wk"], 8 ** -0.5)):
        ref = np.asarray(jparams["layers"]["attn"][name])
        ref = ref[:, :, :40] if name == "wq" else (
            ref[:, :40] if name == "wo" else ref)
        assert abs(float(real.std()) / scale - 1) < 0.02, name
        assert abs(float(real.std()) / float(ref.std()) - 1) < 0.02, name
    for name in ("q_norm", "k_norm"):
        assert not bool(attn[name].any())
    # the same generator seed draws the same parameters
    again = table.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


def test_params_from_reference_rejects_a_wrong_tree():
    cfg = reduced_config("qwen3-14b")
    tree = jax.tree.map(np.asarray, jax_zoo.build_model(
        jax_reduced("qwen3-14b")).table.init(jax.random.key(0)))
    tree["embed"]["table"] = tree["embed"]["table"][:, :-1]
    with pytest.raises(ValueError, match="embed/table"):
        params_from_reference(cfg, tree, device="cpu")
    del tree["embed"]
    with pytest.raises(ValueError, match="missing"):
        params_from_reference(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ["grok-1-314b", "phi3.5-moe-42b-a6.6b",
                                  "pixtral-12b", "whisper-medium"])
def test_other_families_are_not_ported_yet(arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        model_zoo.build_model(reduced_config(arch))


def test_decode_refuses_a_cache_longer_than_the_window():
    cfg = reduced_config("starcoder2-3b")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    cache = transformer.init_cache(cfg, 1, 8, "cpu")
    cache["k"] = cache["v"] = torch.zeros(
        (cfg.num_layers, 1, cfg.sliding_window + 1, cfg.num_kv_heads,
         cfg.head_dim))
    with pytest.raises(ValueError, match="longer than the window"):
        model.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.long))


def test_lm_launcher_on_the_cpu(capsys):
    tokens = serve.main(["--mode", "lm", "--arch", "qwen3-14b", "--reduced",
                         "--device", "cpu", "--batch", "1",
                         "--prompt-len", "3", "--new-tokens", "4"])
    assert tuple(tokens.shape) == (1, 4)
    out = capsys.readouterr().out
    assert "tok/s" in out and "sample:" in out


def test_transformer_lm_module_holds_the_reference_paths():
    cfg = reduced_config("qwen3-14b")
    table = transformer.param_table(cfg)
    lm = transformer.TransformerLM(
        cfg, table.init(torch.Generator().manual_seed(0), "cpu"))
    names = {n for n, _ in lm.named_parameters()}
    assert names == {f"weights.{p}" for p in table.defs}
    assert not any(p.requires_grad for p in lm.parameters())
    toks = torch.from_numpy(_tokens(cfg, 1, 5, 4)).long()
    logits, _ = lm(toks)
    want, _ = transformer.forward(cfg, lm.tree(), toks)
    assert torch.equal(logits, want)
    cache = lm.init_cache(1, 8)
    for s in range(5):
        step, cache = lm.decode_step(cache, toks[:, s:s + 1])
    torch.testing.assert_close(step[:, 0], logits[:, -1], rtol=0, atol=1e-4)
