"""The port's encoder-decoder (whisper-medium) against the JAX package's,
on the CPU.

Reduced config: 2 encoder + 2 decoder layers, ``encoder_seq_len`` 32,
float32.  The JAX parameters are carried across with
``params_from_reference``; the same numpy-seeded frames and tokens go
through both packages' ``encode``, ``forward`` and
``prefill_cross_cache``, then a teacher-forced ``decode_step`` past the
end of an 8-slot ring on the filled cross cache, and greedy generation
on it.  The reference is driven through ``prefill_cross_cache`` and
``decode_step`` directly: its launcher generates on a fresh zero cache
(C-ref8), which the last test shows.

Tolerance: 2e-3 absolute on logits, as for the VLM
(``tests/test_torch_vlm.py``): whisper has no qk-norm, so the reference's
initialisation (C-ref5) makes attention nearly hard and one-ulp
differences grow through the layers.  Generated tokens must be equal."""
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
from repro.models import encdec as jax_encdec
from repro.models import model_zoo as jax_zoo
from repro.parallel.sharding import Sharder
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import encdec, model_zoo
from repro_torch.models.params import params_from_reference

ARCH = "whisper-medium"
ATOL = 2e-3
# 2 decoder layers (the reduced config keeps 4) beside its 2 encoder layers
OVER = {"num_layers": 2}


@pytest.fixture(scope="module")
def pair():
    """(port cfg, port model, port params, JAX cfg, model, params, shd)."""
    jcfg = jax_reduced(ARCH, **OVER)
    jmodel = jax_zoo.build_model(jcfg)
    jparams = jmodel.table.init(jax.random.key(0))
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    cfg = reduced_config(ARCH, **OVER)
    model = model_zoo.build_model(cfg)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return cfg, model, params, jcfg, jmodel, jparams, shd


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _caches(pair, b, ring, seed):
    """Both packages' decode state with the cross K/V of the same
    frames."""
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    fr = _frames(cfg, b, seed)
    jcache = jax_encdec.prefill_cross_cache(
        jcfg, jparams, jnp.asarray(fr), shd, jmodel.init_cache(shd, b, ring))
    cache = encdec.prefill_cross_cache(cfg, params, torch.from_numpy(fr),
                                       model.init_cache(b, ring, "cpu"))
    return cache, jcache


def test_reduced_config_shape(pair):
    cfg = pair[0]
    assert (cfg.num_encoder_layers, cfg.num_layers, cfg.encoder_seq_len) \
        == (2, 2, 32)
    assert cfg.num_heads == cfg.num_kv_heads      # full MHA, as whisper


def test_encode(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    fr = _frames(cfg, 2, 1)
    want = jax_encdec.encode(jcfg, jparams, jnp.asarray(fr), shd)
    got = encdec.encode(cfg, params, torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_sinusoid_positions():
    """whisper's 1500 encoder positions at d_model 1024.  The angles reach
    1500 rad, where float32's spacing is 1.2e-4: one ulp of the angle (or
    of the inverse frequency times the position) moves sin and cos by up
    to that, so the two packages' exp, sin and cos may differ by two."""
    want = jax_encdec.sinusoid_positions(1500, 1024, jnp.float32)
    got = encdec.sinusoid_positions(1500, 1024, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2.5e-4)
    np.testing.assert_allclose(got[:64].numpy(), np.asarray(want)[:64],
                               rtol=0, atol=1e-5)


def test_forward_logits(pair):
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    toks, fr = _tokens(cfg, 2, 16, 1), _frames(cfg, 2, 2)
    want, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(fr)}, shd)
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(fr)})
    assert tuple(got.shape) == (2, 16, cfg.vocab_padded)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    lm = model_zoo.LanguageModel(model, params)
    again, _ = lm(torch.from_numpy(toks), frames=torch.from_numpy(fr))
    assert torch.equal(again, got)


def test_prefill_cross_cache(pair):
    cache, jcache = _caches(pair, 2, 8, seed=3)
    for key in ("xk", "xv"):
        assert tuple(cache[key].shape) == tuple(jcache[key].shape)
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=0,
                                   atol=ATOL)
        assert float(cache[key].abs().max()) > 0.1
    assert cache["t"] == 0 and not bool(cache["k"].any())


def test_decode_logits_teacher_forced_past_the_ring(pair):
    """12 steps over a ring of 8 slots on the filled cross cache: the ring
    wraps and the port's filled-prefix call meets the reference's
    full-ring call with empty and overwritten slots."""
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    cache, jcache = _caches(pair, 2, 8, seed=4)
    toks = _tokens(cfg, 2, 12, 5)
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
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=ATOL)


def _reference_generate(pair, jcache, prompt, n_new):
    """The reference's greedy loop (``launch/serve.py:generate``) on a
    given cache, through its ``decode_step``."""
    cfg, _, _, jcfg, jmodel, jparams, shd = pair
    for i in range(prompt.shape[1]):
        logits, jcache = jmodel.decode_step(
            jparams, jcache, jnp.asarray(prompt[:, i:i + 1]), shd)
    out = []
    tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], axis=-1)[:, None]
    for _ in range(n_new):
        out.append(tok)
        logits, jcache = jmodel.decode_step(jparams, jcache,
                                            tok.astype(jnp.int32), shd)
        tok = jnp.argmax(logits[:, -1, :cfg.vocab_size],
                         axis=-1).reshape(-1, 1)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_generate_tokens_on_the_filled_cross_cache(pair):
    cfg, model, params, *_ = pair
    cache, jcache = _caches(pair, 2, 256, seed=6)
    prompt = _tokens(cfg, 2, 5, 7)
    want = _reference_generate(pair, jcache, prompt, 6)
    got = serve.generate(cfg, model, params,
                         torch.from_numpy(prompt).long(), max_new_tokens=6,
                         cache=cache)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_without_a_cache_starts_from_zero_cross_kv(pair):
    """``generate(cache=None)`` starts from a fresh cache, as the
    reference's ``generate`` does: the same tokens."""
    cfg, model, params, jcfg, jmodel, jparams, shd = pair
    prompt = _tokens(cfg, 2, 5, 8)
    want = jax_serve.generate(jcfg, jmodel, jparams, shd,
                              jnp.asarray(prompt), max_new_tokens=6)
    got = serve.generate(cfg, model, params,
                         torch.from_numpy(prompt).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _first_concrete_xk(module, monkeypatch, run):
    """Run ``run()`` with ``module.decode_step`` wrapped; the cross K of
    its first call outside a trace, and whether that call came."""
    seen = []
    inner = module.decode_step

    def rec(cfg, params, cache, tokens, *a, **kw):
        xk = cache["xk"]
        if not seen and not isinstance(xk, jax.core.Tracer):
            seen.append(np.array(np.asarray(xk), dtype=np.float32)
                        if not isinstance(xk, torch.Tensor)
                        else xk.float().numpy().copy())
        return inner(cfg, params, cache, tokens, *a, **kw)

    monkeypatch.setattr(module, "decode_step", rec)
    run()
    monkeypatch.undo()
    return seen[0]


def test_c_ref8_the_reference_launcher_decodes_on_zero_cross_kv(
        monkeypatch, capsys):
    """C-ref8: the reference's ``--mode lm`` fills a cross cache from the
    stub frames, then ``generate`` makes a fresh one, so its first decode
    step sees xk = 0.  The port's launcher decodes on the filled cache."""
    argv = ["--mode", "lm", "--arch", ARCH, "--reduced", "--batch", "1",
            "--prompt-len", "3", "--new-tokens", "2"]
    filled = []
    prefill = jax_encdec.prefill_cross_cache
    monkeypatch.setattr(jax_encdec, "prefill_cross_cache",
                        lambda *a: filled.append(prefill(*a)) or filled[-1])
    ref_xk = _first_concrete_xk(jax_encdec, monkeypatch,
                                lambda: jax_serve.main(argv))
    assert float(np.abs(np.asarray(filled[0]["xk"])).max()) > 0.1
    assert not ref_xk.any()

    port_xk = _first_concrete_xk(
        encdec, monkeypatch, lambda: serve.main(argv + ["--device", "cpu"]))
    assert float(np.abs(port_xk).max()) > 0.1
    # the cross K of the launcher's own seeded frames
    cfg = reduced_config(ARCH)
    model = model_zoo.build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.table.init(gen, "cpu")
    gen.manual_seed(1)
    cache, frames = serve.encoder_cache(cfg, model, params, 1, gen)
    assert tuple(frames.shape) == (1, cfg.encoder_seq_len, cfg.d_model)
    np.testing.assert_array_equal(port_xk, cache["xk"].numpy())
    assert "arch=whisper-medium (cpu)" in capsys.readouterr().out


def test_decode_refuses_brick_attention(pair):
    """``use_brick=True`` (the grid-brick cache, tested against the ring in
    ``tests/test_torch_brick_attention.py``) is refused without a Sharder
    and on a mesh whose model axis does not cut the cache into bricks."""
    from repro_torch.launch.mesh import make_mesh_of as port_mesh_of
    from repro_torch.parallel.sharding import Sharder as PortSharder
    cfg, model, params, *_ = pair
    tok = torch.zeros((1, 1), dtype=torch.long)
    three = PortSharder(cfg, port_mesh_of((1, 3), ("data", "model"),
                                          device="cpu", emulate=True))
    for shd, match in ((None, "needs the Sharder"),
                       (three, "8 slots does not cut into 3 bricks")):
        cache = model.init_cache(1, 8, "cpu")
        with pytest.raises(ValueError, match=match):
            encdec.decode_step(cfg, params, cache, tok, shd, use_brick=True)


def test_param_table_matches_the_reference_at_full_width():
    ours = encdec.param_table(get_config(ARCH))
    ref = jax_encdec.param_table(jax_get_config(ARCH))
    assert {p: dataclasses.astuple(d) for p, d in ours.defs.items()} == \
        {p: dataclasses.astuple(d) for p, d in ref.defs.items()}
    # 24 + 24 layers at d_model 1024 and the 32k learned positions
    assert 1.5e9 < ours.bytes() < 1.8e9
