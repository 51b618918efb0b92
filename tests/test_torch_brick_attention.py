"""The port's grid-brick KV-cache attention (``core/brick_attention.py``)
against the JAX package's, on the CPU.

The reference's brick path runs under ``shard_map`` over a mesh whose
``model`` axis cuts the cache into bricks, so it runs in a subprocess
with 8 fake CPU devices (as ``tests/test_multidevice.py`` runs it; the
parent keeps its one-device JAX), and hands its numbers over in a file.

- Reduced qwen3-32b (f32, qk-norm), batch 4, a cache of W = 8192 slots on
  a (2, 4) mesh (``brick_active`` holds), 3 decode steps: the port's
  decode on an emulated (2, 4) mesh against the reference's brick decode
  on the same weights (carried across by ``params_from_reference``), and
  against the port's own (1, 1) decode (the ring's filled prefix).
  Tolerance 1e-5 absolute on logits of magnitude ~4, about seven times
  the readings (1.4e-6 against the reference, 1.2e-6 against the ring
  path: XLA's and PyTorch's CPU sums, and the bricks' merge, run in
  another order).
  The brick path writes each new token once: the first layer's k/v
  cache (whose inputs both port paths share) is bit-equal to the ring
  path's, and ``kpos`` too.
- ``decode_attention`` itself on random operands (GQA 2:1, a softcap of
  30, empty slots, a slot in the third brick) against the reference's:
  the output within 1e-5, the caches bit for bit (the new token in the
  owning brick, every other slot untouched).
- whisper's decoder (``use_brick=True``) on an emulated (1, 4) mesh over
  an 8-slot ring, past its end, against the ring path: 1e-5 as above."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.core import brick_attention
from repro_torch.launch.mesh import make_mesh_of
from repro_torch.models import encdec, model_zoo
from repro_torch.models.params import params_from_reference
from repro_torch.parallel.sharding import Sharder
from repro_torch.train import steps

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen3-32b"
W, BATCH, STEPS = 8192, 4, 3
ATOL = 1e-5
FN_TOL = 1e-5
SOFTCAP = 30.0


def _reference_run(out_path):
    """The reference's brick decode and ``decode_attention`` in a fresh
    interpreter with 8 fake CPU devices; results into ``out_path``."""
    body = f"""
        import dataclasses
        from repro.configs.registry import reduced_config
        from repro.core import brick_attention as brick
        from repro.launch.mesh import make_mesh_of
        from repro.models import model_zoo
        from repro.parallel.sharding import Sharder
        from repro.train import steps as steps_lib

        out = {{}}
        cfg = reduced_config({ARCH!r})
        mesh = make_mesh_of((2, 4), ("data", "model"))
        shd = Sharder(cfg, mesh)
        assert brick.brick_active(cfg, shd, {W})
        model = model_zoo.build_model(cfg)
        params = model.table.init(jax.random.key(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out["param:" + "/".join(k.key for k in path)] = np.asarray(leaf)
        dec, _ = steps_lib.make_decode_step(cfg, model, mesh)
        dec = jax.jit(dec)
        c = model.init_cache(shd, {BATCH}, {W})
        tok = jnp.ones(({BATCH}, 1), jnp.int32)
        for i in range({STEPS}):
            lg, c = dec(params, c, {{"tokens": tok + i}})
            out[f"logits{{i}}"] = np.asarray(lg, np.float32)
        for key in ("k", "v", "kpos"):
            out["cache:" + key] = np.asarray(c[key])

        # decode_attention on random operands, a softcap, empty slots
        fcfg = dataclasses.replace(cfg, attn_logit_softcap={SOFTCAP})
        rng = np.random.default_rng(7)
        b, w, kh, hd, hp = 4, 64, 2, 16, 4
        ops = dict(q=rng.normal(size=(b, 1, hp, hd)),
                   k=rng.normal(size=(b, w, kh, hd)),
                   v=rng.normal(size=(b, w, kh, hd)),
                   new_k=rng.normal(size=(b, 1, kh, hd)),
                   new_v=rng.normal(size=(b, 1, kh, hd)))
        ops = {{n: (x * 3).astype(np.float32) for n, x in ops.items()}}
        kpos = rng.permutation(w).astype(np.int32) + 40
        kpos[rng.random(w) < 0.3] = -1
        slot, t = 37, 150
        kpos[slot] = t
        o, k2, v2 = jax.jit(lambda *a: brick.decode_attention(fcfg, shd, *a))(
            ops["q"], ops["k"], ops["v"], kpos, ops["new_k"], ops["new_v"],
            jnp.int32(slot), jnp.int32(t))
        out.update({{"fn:" + n: x for n, x in ops.items()}})
        out.update({{"fn:kpos": kpos, "fn:out": np.asarray(o),
                    "fn:k2": np.asarray(k2), "fn:v2": np.asarray(v2),
                    "fn:slot_t": np.array([slot, t])}})
        np.savez({str(out_path)!r}, **out)
        print("OK")
    """
    src = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp
        import numpy as np
    """) + textwrap.dedent(body)
    proc = subprocess.run(
        [sys.executable, "-c", src],
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(REPO), "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("brick") / "ref.npz"
    _reference_run(path)
    return dict(np.load(path))


def _unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def _port_decode(ref, mesh_shape):
    """The port's STEPS decode steps from the reference's weights on a
    mesh of ``mesh_shape`` (emulated when larger than one device):
    (logits (STEPS, B, 1, Vp), the final cache)."""
    cfg = reduced_config(ARCH)
    model = model_zoo.build_model(cfg)
    params = params_from_reference(cfg, _unflatten(
        {k[6:]: v for k, v in ref.items() if k.startswith("param:")}), "cpu")
    mesh = make_mesh_of(mesh_shape, ("data", "model"), device="cpu",
                        emulate=mesh_shape != (1, 1))
    dec = steps.make_decode_step(cfg, model, mesh=mesh)
    cache = model.init_cache(BATCH, W, "cpu")
    tok = torch.ones((BATCH, 1), dtype=torch.long)
    out = []
    with torch.inference_mode():
        for i in range(STEPS):
            lg, cache = dec(params, cache, {"tokens": tok + i})
            out.append(lg)
    return torch.stack(out), cache


def test_brick_decode_matches_the_reference_and_the_one_device_decode(ref):
    cfg = reduced_config(ARCH)
    shd = Sharder(cfg, make_mesh_of((2, 4), ("data", "model"),
                                    device="cpu", emulate=True))
    assert brick_attention.brick_active(cfg, shd, W)
    got, cache = _port_decode(ref, (2, 4))
    want = np.stack([ref[f"logits{i}"] for i in range(STEPS)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    one, cache1 = _port_decode(ref, (1, 1))
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=ATOL)
    # each new token written once, into the owning brick
    assert cache["t"] == cache1["t"] == STEPS
    np.testing.assert_array_equal(cache["kpos"].numpy(), ref["cache:kpos"])
    assert torch.equal(cache["kpos"], cache1["kpos"])
    for key in ("k", "v"):
        assert torch.equal(cache[key][0], cache1[key][0])
        assert not cache[key][:, :, STEPS:].any()
        np.testing.assert_allclose(cache[key].numpy(), ref["cache:" + key],
                                   rtol=0, atol=ATOL)


def test_decode_attention_matches_the_reference(ref):
    import dataclasses
    cfg = dataclasses.replace(reduced_config(ARCH),
                              attn_logit_softcap=SOFTCAP)
    shd = Sharder(cfg, make_mesh_of((2, 4), ("data", "model"),
                                    device="cpu", emulate=True))
    op = {n[3:]: torch.from_numpy(v.copy()) for n, v in ref.items()
          if n.startswith("fn:")}
    slot, t = (int(x) for x in op["slot_t"])
    k0, v0 = op["k"].clone(), op["v"].clone()
    out = brick_attention.decode_attention(
        cfg, shd, op["q"], op["k"], op["v"], op["kpos"], op["new_k"],
        op["new_v"], slot, t)
    np.testing.assert_allclose(out.numpy(), op["out"].numpy(), rtol=0,
                               atol=FN_TOL * float(op["out"].abs().max()))
    assert torch.equal(op["k"], op["k2"]) and torch.equal(op["v"], op["v2"])
    others = torch.arange(op["k"].shape[1]) != slot
    assert torch.equal(op["k"][:, others], k0[:, others])
    assert torch.equal(op["v"][:, others], v0[:, others])


def test_whisper_brick_decode_matches_the_ring():
    """whisper's decoder through the brick cache (``use_brick=True``: its
    8-slot ring is far below ``brick_active``'s 4096) on a (1, 4) mesh,
    11 steps past the ring's end, against the ring path on the same
    cross cache."""
    cfg = reduced_config("whisper-medium", num_layers=2)
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    frames = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    shd = Sharder(cfg, make_mesh_of((1, 4), ("data", "model"),
                                    device="cpu", emulate=True))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 11)))
    runs = []
    with torch.inference_mode():
        for use_brick in (False, True):
            cache = encdec.prefill_cross_cache(
                cfg, params, frames, model.init_cache(2, 8, "cpu"))
            out = []
            for i in range(toks.shape[1]):
                lg, cache = encdec.decode_step(
                    cfg, params, cache, toks[:, i:i + 1], shd,
                    use_brick=use_brick)
                out.append(lg)
            runs.append(torch.stack(out))
    assert runs[0].abs().max() > 0.1
    np.testing.assert_allclose(runs[1].numpy(), runs[0].numpy(), rtol=0,
                               atol=ATOL)
