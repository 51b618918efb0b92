"""The port's Mixture-of-Experts against the JAX package's, on the CPU:
``moe_block`` (routing, capacity, dispatch) and the two MoE configs,
phi3.5-moe and grok-1, reduced (4 experts, top-2, routing groups of 64).

``moe_block`` runs eagerly in the reference when called outside ``jit``,
so the tests read its routing where it is decided: ``jax.lax.top_k``
(the chosen experts) and the last ``jax.nn.one_hot`` (each choice's place
in its expert's queue) are wrapped to record their values.  The port must
choose the same experts and drop the same (token, choice) pairs; the
block's output and aux loss agree within 1e-5 (f32, sums in another
order).  Whole models: forward (with its aux loss), teacher-forced decode
past the end of the ring and generate, as for the VLM
(``tests/test_torch_vlm.py``): 2e-3 absolute on logits, since neither
config has qk-norm (C-ref5); generated tokens equal."""
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
from repro.models import model_zoo as jax_zoo
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.parallel.sharding import Sharder
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import model_zoo, moe, transformer
from repro_torch.models.params import params_from_reference

ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
ATOL = 2e-3
BLOCK_ATOL = 1e-5


def _pair(arch, **over):
    jcfg = jax_reduced(arch, **over)
    jmodel = jax_zoo.build_model(jcfg)
    jparams = jmodel.table.init(jax.random.key(0))
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    cfg = reduced_config(arch, **over)
    model = model_zoo.build_model(cfg)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return cfg, model, params, jcfg, jmodel, jparams, shd


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(port cfg, port model, port params, JAX cfg, model, params, shd)."""
    return _pair(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _reference_block(monkeypatch, jcfg, jp, x, shd):
    """The reference's moe_block on x, with the routing it decided: (out,
    aux, expert indices (G,Sg,k), each choice's place in its queue
    (G,Sg,k))."""
    seen = {}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(operand, k):
        vals, idx = top_k(operand, k)
        seen["expert_idx"] = np.asarray(idx)
        return vals, idx

    def rec_one_hot(x, num_classes, **kw):
        seen["last_one_hot"] = np.asarray(x)
        return one_hot(x, num_classes, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    out, aux = jax_moe.moe_block(jcfg, jp, jnp.asarray(x), shd)
    monkeypatch.undo()
    return np.asarray(out), float(aux), seen["expert_idx"], \
        seen["last_one_hot"]


def _block_case(pair, seed, s=64):
    cfg, _, params, jcfg, _, jparams, shd = pair
    x = np.random.default_rng(seed).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"]["moe"])
    p = {k: v[1] for k, v in params["layers"]["moe"].items()}
    return cfg, jcfg, shd, x, p, jp


def _port_routing(cfg, p, x):
    b, s, d = x.shape
    sg = min(cfg.moe_group_size, s)
    xg = torch.from_numpy(x).reshape(b * (s // sg), sg, d)
    _, _, idx = moe.route(cfg, p["router"], xg)
    onehot = moe._one_hot(idx, cfg.num_experts)
    _, cap_idx = moe.assign_capacity(onehot, moe.moe_capacity(cfg, sg))
    return idx.numpy(), cap_idx.numpy()


def test_moe_block_matches_the_reference(pair, monkeypatch):
    cfg, jcfg, shd, x, p, jp = _block_case(pair, seed=1)
    want, jaux, jidx, jplace = _reference_block(monkeypatch, jcfg, jp, x,
                                                shd)
    got, aux = moe.moe_block(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BLOCK_ATOL)
    assert abs(float(aux) - jaux) <= BLOCK_ATOL
    idx, place = _port_routing(cfg, p, x)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(place, jplace)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_the_reference(arch, monkeypatch):
    """moe_capacity_factor 0.25: capacity 8 places an expert for 64 tokens
    x 2 choices, so most choices are dropped; the same ones in both."""
    pair = _pair(arch, moe_capacity_factor=0.25)
    cfg, jcfg, shd, x, p, jp = _block_case(pair, seed=2)
    cap = moe.moe_capacity(cfg, 64)
    assert cap == jax_moe.moe_capacity(jcfg, 64) == 8
    want, jaux, jidx, jplace = _reference_block(monkeypatch, jcfg, jp, x,
                                                shd)
    idx, place = _port_routing(cfg, p, x)
    np.testing.assert_array_equal(idx, jidx)
    dropped = place >= cap
    np.testing.assert_array_equal(dropped, jplace >= cap)
    assert 0.5 < dropped.mean() < 1.0
    got, aux = moe.moe_block(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BLOCK_ATOL)
    assert abs(float(aux) - jaux) <= BLOCK_ATOL


def test_top_k_breaks_ties_to_the_lower_index(pair, monkeypatch):
    """A zero router gives every expert the same probability: both
    packages choose experts 0 and 1, in that order, for every token."""
    cfg, jcfg, shd, x, p, jp = _block_case(pair, seed=3, s=16)
    p = dict(p, router=torch.zeros_like(p["router"]))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    _, _, jidx, _ = _reference_block(monkeypatch, jcfg, jp, x, shd)
    idx, _ = _port_routing(cfg, p, x)
    np.testing.assert_array_equal(idx, jidx)
    assert (idx == np.arange(cfg.num_experts_per_tok)).all()
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.5, 0.2, 0.2, 0.1]])
    vals, got = moe.top_k(probs, 2)
    assert got.tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, probs.gather(-1, got))


def test_forward_logits_and_aux_loss(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 16, 1)
    want, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, shd)
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, 16, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the Switch loss summed over the layers: about 1 a layer when balanced
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(aux) > 0.5 * cfg.num_layers


def test_decode_logits_teacher_forced_past_the_ring(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 12, 2)
    jcache = jmodel.init_cache(shd, 2, 8)
    cache = model.init_cache(2, 8, "cpu")
    for s in range(toks.shape[1]):
        tok = toks[:, s:s + 1]
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          shd)
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"step {s}")
    assert cache["t"] == int(jcache["t"]) == 12


def test_generate_tokens(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    prompt = _tokens(cfg, 2, 5, 3)
    want = jax_serve.generate(jcfg, jmodel, jparams, shd,
                              jnp.asarray(prompt), max_new_tokens=6)
    got = serve.generate(cfg, model, params,
                         torch.from_numpy(prompt).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_matches_the_reference_at_full_width(arch):
    ours = transformer.param_table(get_config(arch))
    ref = jax_transformer.param_table(jax_get_config(arch))
    assert {p: dataclasses.astuple(d) for p, d in ours.defs.items()} == \
        {p: dataclasses.astuple(d) for p, d in ref.defs.items()}
    assert ours.num_params() == ref.num_params()


def test_phi35_moe_does_not_fit_one_card_at_full_depth():
    """41.9 B parameters, 83.7 GB in bf16; 16 of its 32 layers at full
    width are ~42 GB, the depth chip_smoke.py serves."""
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    table = transformer.param_table(cfg)
    assert table.num_params() == pytest.approx(41.87e9, rel=1e-3)
    half = transformer.param_table(dataclasses.replace(cfg, num_layers=16))
    assert 41e9 < half.bytes() < 43e9


def test_moe_block_refuses_tokens_that_do_not_split_into_groups():
    cfg = reduced_config("phi3.5-moe-42b-a6.6b", moe_group_size=6)
    p = {k: v[0] for k, v in model_zoo.build_model(cfg).table.init(
        torch.Generator().manual_seed(0), "cpu")["layers"]["moe"].items()}
    with pytest.raises(ValueError, match="routing groups"):
        moe.moe_block(cfg, p, torch.zeros((1, 8, cfg.d_model)))


def test_lm_launcher_serves_both_moe_configs(capsys):
    for arch in ARCHS:
        tokens = serve.main(["--mode", "lm", "--arch", arch, "--reduced",
                             "--device", "cpu", "--batch", "1",
                             "--prompt-len", "3", "--new-tokens", "4"])
        assert tuple(tokens.shape) == (1, 4)
        assert f"arch={arch} (cpu)" in capsys.readouterr().out
