"""The port's mesh layer against the JAX package's, on the CPU:
``launch/mesh.py``, ``parallel/sharding.py``, ``parallel/collectives.py``,
the parameter and optimizer specs, and the serving launcher's mesh.

- Sharder specs: every parameter leaf of all ten architectures, on the
  meshes (1, 1), (2, 4), (16, 16) and (2, 16, 16), with ``fsdp_params``
  and ``moe_sharding`` both ways, equal entry for entry to the
  reference's ``tuple(PartitionSpec)``.  The reference Sharder reads only
  ``axis_names`` and ``devices.shape``, so it takes a stand-in mesh.
- ``brick_active`` agrees with the reference on a grid of configs, model
  axis sizes and cache lengths.
- The int8 collectives are bit-equal to the reference's.  The reductions
  over an emulated axis are held against the reference under
  ``shard_map`` on 8 fake CPU devices, in a subprocess (the parent keeps
  its one-device JAX): the int32 sums exact, the new errors within 2
  ulp of ``grad + error`` (XLA fuses the reference's multiply-subtract
  under jit; eager, the two are bit-equal), the f32 means and sums within
  2 ulp (``ULPS``: the reference's all-reduce may add the shards in
  another order).
- The serving launcher decodes on a (1, 1) mesh of its device however
  many CUDA devices the host reports (``torch.cuda.device_count``
  replaced), and ``--production-mesh`` raises with that count."""
import dataclasses
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import brick_attention as jax_brick
from repro.launch.mesh import make_mesh_of as jax_mesh_of
from repro.models import model_zoo as jax_zoo
from repro.optim import adamw as jax_adamw
from repro.parallel import collectives as jax_coll
from repro.parallel.sharding import Sharder as JaxSharder
from repro_torch.configs.registry import get_config, list_archs, \
    reduced_config
from repro_torch.core import brick_attention
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import serve as port_serve
from repro_torch.models import model_zoo
from repro_torch.optim import adamw
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import Sharder

REPO = Path(__file__).resolve().parents[1]
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# f32 means and sums of the emulated-axis reductions against the
# reference's all-reduce: at most this many units in the last place
ULPS = 2


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _port_mesh(shape, axes):
    return port_mesh.make_mesh_of(shape, axes, device="cpu",
                                  emulate=int(np.prod(shape)) > 1)


def _variants(cfg):
    for fsdp in (True, False):
        for moe in ("tp", "ep"):
            yield dict(fsdp_params=fsdp, moe_sharding=moe)


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch):
    for over in _variants(get_config(arch)):
        cfg = dataclasses.replace(get_config(arch), **over)
        jcfg = dataclasses.replace(jax_get_config(arch), **over)
        table = model_zoo.build_model(cfg).table
        jtable = jax_zoo.build_model(jcfg).table
        for shape, axes in MESHES:
            shd = Sharder(cfg, _port_mesh(shape, axes))
            jshd = JaxSharder(jcfg, _stand_in(shape, axes))
            for path, d in table.defs.items():
                jd = jtable.defs[path]
                assert shd.spec(d.roles, d.shape) == \
                    tuple(jshd.spec(jd.roles, jd.shape)), (path, shape, over)
            for shp in ((8, 2048), (3, 5, 7), (256, 1)):
                assert shd.batch_spec(shp) == tuple(jshd.batch_spec(shp))
            assert (shd.batch_axes, shd.batch_size_total, shd.fsdp_axis,
                    shd.tensor_axis, shd.tensor_size, shd.fsdp_size) == \
                (jshd.batch_axes, jshd.batch_size_total, jshd.fsdp_axis,
                 jshd.tensor_axis, jshd.tensor_size, jshd.fsdp_size)


def _flat(tree, prefix=""):
    """A nested dict's leaves by "/"-joined path (either package's)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def test_specs_trees_and_abstract_state_match_the_reference():
    """``specs``, ``shardings`` and ``abstract_sharded`` of the table, and
    the optimizer's ``abstract_opt_state`` and ``opt_specs``, against the
    reference's on a (1, 1) mesh (the one JAX device here) and, for the
    specs, a (2, 16, 16) stand-in (reduced phi3.5-moe: experts, ep)."""
    from repro.configs.registry import reduced_config as jax_reduced
    arch = "phi3.5-moe-42b-a6.6b"
    cfg, jcfg = reduced_config(arch), jax_reduced(arch)
    table = model_zoo.build_model(cfg).table
    jtable = jax_zoo.build_model(jcfg).table
    shd = Sharder(cfg, _port_mesh((1, 1), ("data", "model")))
    jshd = JaxSharder(jcfg, jax_mesh_of((1, 1), ("data", "model")))
    assert {p: v for p, v in _flat(table.specs(shd)).items()} == \
        {p: tuple(v) for p, v in _flat(jtable.specs(jshd)).items()}
    named = _flat(table.shardings(shd))
    abstract = _flat(table.abstract_sharded(shd))
    jabstract = jtable.abstract_sharded(jshd)
    jflat = _flat(jabstract)
    assert set(abstract) == set(jflat) == set(named)
    for path, leaf in abstract.items():
        want = jflat[path]
        assert leaf.value.device.type == "meta"
        assert tuple(leaf.value.shape) == tuple(want.shape)
        assert str(leaf.value.dtype).split(".")[-1] == str(want.dtype)
        assert leaf.spec == tuple(want.sharding.spec) == named[path].spec
        assert named[path].mesh is shd.mesh
    state = adamw.abstract_opt_state(table.abstract_sharded(shd),
                                     adamw.AdamW())
    jstate = jax_adamw.abstract_opt_state(jabstract, jax_adamw.AdamW())
    for key in ("m", "v"):
        got, want = _flat(state[key]), _flat(jstate[key])
        assert set(got) == set(want)
        for path, v in want.items():
            assert tuple(got[path].value.shape) == tuple(v.shape)
            assert got[path].value.dtype == torch.float32
            assert str(v.dtype) == "float32"
            assert got[path].spec == tuple(v.sharding.spec)
    assert state["count"].dtype == torch.int32
    assert state["count"].device.type == "meta"
    mesh = ((2, 16, 16), ("pod", "data", "model"))
    got = adamw.opt_specs(table.specs(Sharder(cfg, _stand_in(*mesh))))
    want = jax_adamw.opt_specs(jtable.specs(JaxSharder(jcfg,
                                                       _stand_in(*mesh))))
    assert got["count"] == tuple(want["count"])
    for key in ("m", "v"):
        assert _flat(got[key]) == {p: tuple(v) for p, v in
                                   _flat(want[key]).items()}


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-9b",
                                  "starcoder2-3b", "whisper-medium"])
def test_brick_active_matches_the_reference(arch):
    for seq_shard in (True, False):
        cfg = dataclasses.replace(get_config(arch),
                                  decode_cache_seq_shard=seq_shard)
        jcfg = dataclasses.replace(jax_get_config(arch),
                                   decode_cache_seq_shard=seq_shard)
        for model in (1, 2, 3, 4, 16):
            shape, axes = (2, model), ("data", "model")
            shd = Sharder(cfg, _stand_in(shape, axes))
            jshd = JaxSharder(jcfg, _stand_in(shape, axes))
            for w in (2048, 4096, 4097, 4100, 6000, 8192, 12288, 32768):
                assert brick_attention.brick_active(cfg, shd, w) == \
                    jax_brick.brick_active(jcfg, jshd, w), (model, w)
    # the one-card (1, 1) mesh never takes the brick path
    shd = Sharder(get_config(arch), _port_mesh((1, 1), ("data", "model")))
    assert not brick_attention.brick_active(get_config(arch), shd, 8192)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_quantization_is_bit_equal_to_the_reference(dtype):
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 37.5):
        x = (rng.normal(size=(33, 17)) * scale).astype(np.float32)
        err = (rng.normal(size=(33, 17)) * scale * 1e-2).astype(np.float32)
        if dtype == "bfloat16":
            xt = torch.from_numpy(x).bfloat16()
            xj = jax.numpy.asarray(xt.float().numpy()).astype(
                jax.numpy.bfloat16)
        else:
            xt, xj = torch.from_numpy(x), jax.numpy.asarray(x)
        q, s = collectives.quantize_int8(xt)
        jq, js = jax_coll.quantize_int8(xj)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            collectives.dequantize_int8(q, s).numpy(),
            np.asarray(jax_coll.dequantize_int8(jq, js)))
        got = collectives.compress_with_feedback(xt, torch.from_numpy(err))
        want = jax_coll.compress_with_feedback(xj, jax.numpy.asarray(err))
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # all zeros: the scale's floor, q all zero
    q, s = collectives.quantize_int8(torch.zeros(4))
    jq, js = jax_coll.quantize_int8(jax.numpy.zeros(4))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert not q.any()


def _ulps(got, want):
    a = np.asarray(got, np.float32)
    b = np.asarray(want, np.float32)
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(a),
                                                         np.abs(b)))).max())


def test_emulated_axis_collectives_match_the_reference_shard_map(tmp_path):
    rng = np.random.default_rng(3)
    grad = (rng.normal(size=(4, 6, 5)) * [[[1.0]], [[3.0]], [[0.1]],
                                           [[2.0]]]).astype(np.float32)
    error = (rng.normal(size=(4, 6, 5)) * 1e-2).astype(np.float32)
    x = rng.normal(size=(2, 4, 3, 7)).astype(np.float32)
    np.savez(tmp_path / "in.npz", grad=grad, error=error, x=x)
    body = f"""
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import make_mesh_of
        from repro.parallel import collectives as C
        inp = np.load({str(tmp_path / "in.npz")!r})
        pod = make_mesh_of((4,), ("pod",))

        def mean(g, e):
            m, ne = C.compressed_cross_pod_mean(g[0], e[0], "pod")
            return m, ne[None]

        def int_sum(g, e):
            q, _, _ = C.compress_with_feedback(g[0], e[0])
            return jax.lax.psum(q.astype(jnp.int32), "pod")

        sm = dict(mesh=pod, in_specs=(P("pod"), P("pod")))
        m, ne = jax.jit(jax.shard_map(mean, out_specs=(P(), P("pod")),
                                      check_vma=False, **sm))(
            inp["grad"], inp["error"])
        isum = jax.jit(jax.shard_map(int_sum, out_specs=P(),
                                     check_vma=False, **sm))(
            inp["grad"], inp["error"])
        two = make_mesh_of((2, 4), ("pod", "data"))

        def hier(x):
            return C.hierarchical_psum(x[0, 0], inner="data", outer="pod")

        def inner_only(x):
            return C.hierarchical_psum(x[0, 0], inner="data", outer=None)

        hp = jax.jit(jax.shard_map(hier, mesh=two,
                                   in_specs=P("pod", "data"),
                                   out_specs=P(), check_vma=False))(inp["x"])
        io = jax.jit(jax.shard_map(inner_only, mesh=two,
                                   in_specs=P("pod", "data"),
                                   out_specs=P("pod"), check_vma=False))(
            inp["x"])
        np.savez({str(tmp_path / "out.npz")!r}, mean=np.asarray(m),
                 new_error=np.asarray(ne), int_sum=np.asarray(isum),
                 hier=np.asarray(hp), inner=np.asarray(io))
        print("OK")
    """
    run_with_devices(body)
    out = np.load(tmp_path / "out.npz")
    mean, new_error = collectives.compressed_cross_pod_mean(
        torch.from_numpy(grad), torch.from_numpy(error))
    qs = [collectives.compress_with_feedback(torch.from_numpy(g),
                                             torch.from_numpy(e))[0]
          for g, e in zip(grad, error)]
    isum = collectives._sum_shards(torch.stack([q.to(torch.int32)
                                                for q in qs]))
    np.testing.assert_array_equal(isum.numpy(), out["int_sum"])
    # under jit XLA fuses target - q * scale, which then rounds
    # otherwise: within ULPS units in the last place of the target
    target = grad + error
    assert (np.abs(new_error.numpy() - out["new_error"]) <=
            ULPS * np.spacing(np.abs(target))).all()
    assert _ulps(mean.numpy(), out["mean"]) <= ULPS
    hier = collectives.hierarchical_psum(torch.from_numpy(x))
    assert _ulps(hier.numpy(), out["hier"]) <= ULPS
    # the inner sum of each pod, stacked over the pods
    inner = torch.stack([collectives.hierarchical_psum(
        torch.from_numpy(x[i]), outer=None) for i in range(2)])
    assert _ulps(inner.numpy().reshape(out["inner"].shape),
                 out["inner"]) <= ULPS


def run_with_devices(body: str, n: int = 8) -> str:
    """``body`` in a fresh interpreter with ``n`` fake CPU devices for
    JAX (as ``tests/test_multidevice.py`` runs it)."""
    src = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
        import jax, jax.numpy as jnp
        import numpy as np
    """) + textwrap.dedent(body)
    out = subprocess.run(
        [sys.executable, "-c", src],
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(REPO), "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


def test_make_mesh_of_emulates_only_when_asked():
    one = port_mesh.make_mesh_of((1, 1), ("data", "model"), device="cpu")
    assert one.devices.shape == (1, 1) and not one.emulated
    assert one.devices[0, 0] == torch.device("cpu")
    with pytest.raises(RuntimeError, match="need 8 devices for mesh"):
        port_mesh.make_mesh_of((2, 4), ("data", "model"), device="cpu")
    em = port_mesh.make_mesh_of((2, 4), ("data", "model"), device="cpu",
                                emulate=True)
    assert em.emulated and em.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in em.devices.flat)
    assert port_mesh.make_host_mesh(device="cpu").devices.shape == (1, 1)
    with pytest.raises(ValueError, match="differ in length"):
        port_mesh.make_mesh_of((2, 4), ("data",), device="cpu",
                               emulate=True)


def test_production_mesh_raises_the_device_count():
    want = torch.cuda.device_count()
    for multi, n, shape in ((False, 256, (16, 16)), (True, 512, (2, 16, 16))):
        with pytest.raises(RuntimeError) as err:
            port_mesh.make_production_mesh(multi_pod=multi)
        assert str(err.value).startswith(
            f"need {n} devices for mesh {shape}, have {want} CUDA device")


@pytest.mark.parametrize("count,device", [(1, "cuda"), (2, "cuda"),
                                          (8, "cuda:1"), (2, "cpu")])
def test_serve_launcher_mesh_is_one_device_on_a_host_of_several(
        monkeypatch, count, device):
    """``--mode lm`` decodes on a (1, 1) mesh of its resolved device
    however many CUDA devices the host has (the reference's ``(n, 1)``
    default would be a real mesh of several cards, which the port
    refuses), and its Sharder leaves the brick path off."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    mesh = port_serve.lm_mesh(torch.device(device))
    assert mesh.devices.shape == (1, 1) and not mesh.emulated
    want = torch.device(device)
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", 0)
    assert mesh.devices[0, 0] == want
    shd = Sharder(get_config("qwen3-14b"), mesh)
    assert shd.tensor_size == 1
    assert not brick_attention.brick_active(get_config("qwen3-14b"), shd, 8192)
    if count < 256:
        with pytest.raises(RuntimeError, match=f"have {count} CUDA device"):
            port_serve.lm_mesh(torch.device(device), production=True)
