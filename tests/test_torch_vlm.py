"""The port's VLM (pixtral-12b: the decoder with the stubbed patch front
end) against the JAX package's, on the CPU.

The JAX parameters are carried across with ``params_from_reference``; the
same numpy-seeded tokens and patch embeddings (4 patches, the reduced
config's) go through both packages' ``forward``, then tokens alone
through a teacher-forced ``decode_step`` past the end of the ring and
through ``generate`` (the prompt with no patches, as the reference's
launcher serves it), in float32.

Tolerance: 2e-3 absolute on logits of magnitude ~5.  pixtral has no
qk-norm, so the reference's initialisation (C-ref5: ``wq`` drawn at
1/sqrt(Hp)) makes each softmax nearly hard and a one-ulp difference in a
dot (XLA's and PyTorch's CPU sums run in another order) grows through the
layers, as for the dense configs without qk-norm
(``tests/test_torch_lm.py``).  Generated tokens must be equal."""
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
from repro.models import transformer as jax_transformer
from repro.parallel.sharding import Sharder
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import model_zoo, transformer
from repro_torch.models.params import params_from_reference

ARCH = "pixtral-12b"
ATOL = 2e-3


@pytest.fixture(scope="module")
def pair():
    """(port cfg, port model, port params, JAX cfg, model, params, shd)."""
    jcfg = jax_reduced(ARCH)
    jmodel = jax_zoo.build_model(jcfg)
    jparams = jmodel.table.init(jax.random.key(0))
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    cfg = reduced_config(ARCH)
    model = model_zoo.build_model(cfg)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return cfg, model, params, jcfg, jmodel, jparams, shd


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _patches(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)


def test_reduced_config_keeps_the_patch_front_end(pair):
    cfg = pair[0]
    assert cfg.family == "vlm" and cfg.num_patches == 4
    assert "vlm/patch_proj" in pair[1].table.defs


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_logits(pair, with_patches):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks = _tokens(cfg, 2, 16, 1)
    batch, jbatch = {"tokens": torch.from_numpy(toks)}, \
        {"tokens": jnp.asarray(toks)}
    if with_patches:
        pe = _patches(cfg, 2, 5)
        batch["patch_embeds"] = torch.from_numpy(pe)
        jbatch["patch_embeds"] = jnp.asarray(pe)
    want, jaux = jmodel.forward(jparams, jbatch, shd)
    got, aux = model.forward(params, batch)
    assert tuple(got.shape) == (2, 16, cfg.vocab_padded)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_patch_embeddings_replace_the_first_positions(pair):
    """The projected patches take the first P positions: those embeddings
    change with the patches, the rest are the token embeddings."""
    cfg, _, params, *_ = pair
    toks = torch.from_numpy(_tokens(cfg, 2, 16, 1)).long()
    pe = torch.from_numpy(_patches(cfg, 2, 5))
    plain = transformer.embed_tokens(cfg, params, toks)
    x = transformer.embed_tokens(cfg, params, toks, pe)
    p = cfg.num_patches
    assert torch.equal(x[:, p:], plain[:, p:])
    torch.testing.assert_close(
        x[:, :p], torch.einsum("bpd,de->bpe", pe,
                               params["vlm"]["patch_proj"]))
    assert not torch.allclose(x[:, :p], plain[:, :p])


def test_language_model_forward_takes_patch_embeds(pair):
    cfg, model, params, *_ = pair
    lm = model_zoo.LanguageModel(model, params)
    toks = torch.from_numpy(_tokens(cfg, 2, 16, 1)).long()
    pe = torch.from_numpy(_patches(cfg, 2, 5))
    got, _ = lm(toks, patch_embeds=pe)
    want, _ = model.forward(params, {"tokens": toks, "patch_embeds": pe})
    assert torch.equal(got, want)


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
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))


def test_generate_tokens(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    prompt = _tokens(cfg, 2, 5, 3)
    want = jax_serve.generate(jcfg, jmodel, jparams, shd,
                              jnp.asarray(prompt), max_new_tokens=6)
    got = serve.generate(cfg, model, params,
                         torch.from_numpy(prompt).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_param_table_matches_the_reference_at_full_width():
    ours = transformer.param_table(get_config(ARCH))
    ref = jax_transformer.param_table(jax_get_config(ARCH))
    assert {p: dataclasses.astuple(d) for p, d in ours.defs.items()} == \
        {p: dataclasses.astuple(d) for p, d in ref.defs.items()}
    assert ours.bytes() == ref.bytes()
    # 40 layers at d_model 5120: ~24.5 GB in bf16, what one card holds
    assert 24e9 < ours.bytes() < 25e9


def test_lm_launcher_on_the_cpu(capsys):
    tokens = serve.main(["--mode", "lm", "--arch", ARCH, "--reduced",
                         "--device", "cpu", "--batch", "1",
                         "--prompt-len", "3", "--new-tokens", "4"])
    assert tuple(tokens.shape) == (1, 4)
    assert "arch=pixtral-12b (cpu)" in capsys.readouterr().out
