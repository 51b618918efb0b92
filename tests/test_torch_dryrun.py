"""The port's dry run (``launch/dryrun.py``) on the ``meta`` device,
against the JAX package, on the CPU.

- ``cell_is_applicable`` equals the reference's for all ten
  architectures and four shape cells.  The reference's dry-run module
  sets ``XLA_FLAGS`` for 512 fake devices when imported, which would
  reach every later JAX process of this worker, so its function is read
  out of the source and run on its own.
- ``model_zoo.input_specs`` and each family's ``init_cache_abstract``
  give the reference's shapes, dtypes and specs, on a (1, 1) mesh and a
  (16, 16) stand-in (the reference's Sharder names its specs on an
  ``AbstractMesh``; its model code reads nothing else of the mesh).
- A reduced qwen3 and a reduced phi3.5-moe: the flops of the port's
  prefill step outside its kernels equal ``hlo_parse.analyze`` of the
  reference's compiled prefill step on a one-device mesh, once the
  reference's attention dots are taken out in closed form (its plain
  attention contracts every (query, key) pair of every padded head, the
  keys padded to whole 1024-key chunks).  A reduced qwen3 train step
  likewise, the attention taken out four times (the forward, remat's
  recompute, the backward's four products): equal on the reading, so
  held exactly.
- Each family's kernel entries follow its layer pattern, and the
  argument bytes equal the sum of the reference's abstract leaves.
- qwen3-14b ``decode_32k`` at full width (~30 GB of weights, ~690 GB of
  cache) on ``meta``: 40 decode-kernel entries, no memory taken.
- ``run_cell`` writes the record and the op trace, ``analyze_cell``
  reads them back; ``--multi-pod`` and ``--both-meshes`` raise the
  device-count error; the recorder sees storages that only autograd
  holds."""
import ast
import dataclasses
import json
import math
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh, NamedSharding

from repro.analysis import hlo_parse as ref_hlo
from repro.configs import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.models import model_zoo as jax_zoo
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import abstract_opt_state as jax_opt_state
from repro.parallel.sharding import Sharder as JaxSharder
from repro.train import steps as jax_steps
from repro_torch.analysis import roofline
from repro_torch.configs import (SHAPES, ShapeConfig, get_config,
                                 list_archs, reduced_config)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_of
from repro_torch.models import model_zoo
from repro_torch.models.params import AbstractParam
from repro_torch.parallel.sharding import Sharder

REPO = Path(__file__).resolve().parents[1]
MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model"))]
# small cells for the reduced configs (the sLSTM loops over S)
SMALL = {"train": ShapeConfig("train_small", 64, 2, "train"),
         "prefill": ShapeConfig("prefill_small", 64, 2, "prefill"),
         "decode": ShapeConfig("decode_small", 64, 2, "decode")}
# one architecture of each family
FAMILIES = ["qwen3-14b", "phi3.5-moe-42b-a6.6b", "pixtral-12b",
            "whisper-medium", "recurrentgemma-9b", "xlstm-350m"]


def _reference_cell_is_applicable():
    """The reference's ``cell_is_applicable``, compiled from its source
    without importing ``repro.launch.dryrun``."""
    path = REPO / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "cell_is_applicable")
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["cell_is_applicable"]


class _AbstractSharder(JaxSharder):
    """The reference's Sharder on a stand-in mesh: its specs named on an
    ``AbstractMesh`` of the same axes."""

    def named(self, roles, shape):
        mesh = AbstractMesh(tuple(self.mesh.devices.shape),
                            tuple(self.mesh.axis_names))
        return NamedSharding(mesh, self.spec(roles, shape))


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _port_sharder(cfg, shape, axes):
    return Sharder(cfg, make_mesh_of(shape, axes, device="cpu",
                                     emulate=int(np.prod(shape)) > 1))


def _ref_leaves(tree):
    return jax.tree.leaves(tree)


def _same_abstract(port: dict, ref: dict, what):
    assert set(port) == set(ref), what
    for key, sds in ref.items():
        leaf = port[key]
        assert isinstance(leaf, AbstractParam), (what, key)
        assert leaf.value.device.type == "meta"
        assert tuple(leaf.value.shape) == tuple(sds.shape), (what, key)
        assert str(leaf.value.dtype).removeprefix("torch.") == \
            str(sds.dtype), (what, key)
        assert leaf.spec == tuple(sds.sharding.spec), (what, key)


def test_cell_is_applicable_equals_the_reference():
    ref = _reference_cell_is_applicable()
    skipped = 0
    for arch in list_archs():
        for name in SHAPES:
            got = dryrun.cell_is_applicable(get_config(arch), SHAPES[name])
            assert got == ref(jax_get_config(arch), REF_SHAPES[name])
            skipped += not got[0]
    assert 0 < skipped < len(list_archs())


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_and_abstract_cache_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = model_zoo.build_model(cfg), jax_zoo.build_model(jcfg)
    for mesh_shape, axes in MESHES:
        shd = _port_sharder(cfg, mesh_shape, axes)
        jshd = _AbstractSharder(jcfg, _stand_in(mesh_shape, axes))
        for name, shape in SHAPES.items():
            what = (arch, mesh_shape, name)
            _same_abstract(model_zoo.input_specs(model, shape, shd),
                           jax_zoo.input_specs(jmodel, REF_SHAPES[name],
                                               jshd), what)
            cache = model.init_cache_abstract(shd, shape.global_batch,
                                              shape.seq_len)
            ref = jmodel.init_cache_abstract(jshd, shape.global_batch,
                                             shape.seq_len)
            # the reference's ``t`` is a traced scalar; the port's a host
            # int: the step that writes the cache's last position
            assert cache.pop("t") == shape.seq_len - 1
            ref = {key: v for key, v in ref.items() if key != "t"}
            _same_abstract(cache, ref, what)


def _one_device_sharder(jcfg):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    return mesh, JaxSharder(jcfg, mesh)


def _reference_flops(arch, shape):
    """``hlo_parse.analyze`` flops of the reference's compiled step on a
    one-device mesh (reduced config)."""
    jcfg = jax_reduced(arch)
    mesh, shd = _one_device_sharder(jcfg)
    jmodel = jax_zoo.build_model(jcfg)
    params = jmodel.table.abstract_sharded(shd)
    rshape = RefShape(shape.name, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, kind=shape.kind)
    batch = jax_zoo.input_specs(jmodel, rshape, shd)
    if shape.kind == "prefill":
        step, _ = jax_steps.make_prefill_step(jcfg, jmodel, mesh)
        lowered = jax.jit(step).lower(params, batch)
    else:
        opt = JaxAdamW(moment_dtype=jcfg.opt_moment_dtype)
        step, _ = jax_steps.make_train_step(jcfg, jmodel, mesh, opt)
        lowered = jax.jit(step).lower(params,
                                      jax_opt_state(params, opt, shd), batch)
    return ref_hlo.analyze(lowered.compile().as_text()).flops


def _reference_attention_flops(cfg, shape):
    """The reference's plain attention, forward: two products of every
    (query, key) pair of every padded head, the keys padded to whole
    1024-key chunks past one chunk."""
    s = shape.seq_len
    keys = s if s <= 1024 else math.ceil(s / 1024) * 1024
    return (4 * shape.global_batch * s * cfg.num_heads_padded * keys *
            cfg.head_dim * cfg.num_layers)


@pytest.mark.parametrize("arch", ["qwen3-14b", "phi3.5-moe-42b-a6.6b"])
def test_prefill_flops_outside_kernels_equal_the_reference(arch):
    cfg = reduced_config(arch)
    shape = ShapeConfig("prefill_1536", 1536, 2, "prefill")   # 2 chunks
    _, trace = dryrun.lower(cfg, shape)
    port = sum(op[3] for op in trace.ops)
    want = _reference_flops(arch, shape) - \
        _reference_attention_flops(cfg, shape)
    assert port == want > 0


def test_train_flops_outside_kernels_equal_the_reference():
    cfg = reduced_config("qwen3-14b")
    assert cfg.remat_policy == "full"
    shape = ShapeConfig("train_256", 256, 2, "train")
    _, trace = dryrun.lower(cfg, shape)
    port = sum(op[3] for op in trace.ops)
    want = _reference_flops("qwen3-14b", shape) - \
        4 * _reference_attention_flops(cfg, shape)
    assert port == want > 0


def _expected_launches(cfg, kind):
    """Kernel calls by kernel that one step of ``kind`` makes, from the
    family's layer pattern: per microbatch each attention, RG-LRU and
    mLSTM layer calls its kernel once in the forward and once more in
    remat's recompute where a checkpointed layer or super-block holds it
    (not whisper's, not the hybrid tail), its backward once."""
    from repro_torch.models import hybrid, xlstm
    m = max(1, cfg.microbatches) if kind == "train" else 1
    again = 2 if kind == "train" and cfg.remat_policy != "none" else 1
    if cfg.family == "hybrid":
        unit, n_super, tail = hybrid._pattern(cfg)
        attn = n_super * unit.count("attn")
        rec, rec_tail = n_super * unit.count("rec"), tail.count("rec")
        if kind == "decode":     # the recurrence steps without the scan
            return {"flash_attention": attn}
        if kind == "prefill":
            return {"flash_attention": attn, "rglru_scan": rec + rec_tail}
        return {"flash_attention": again * attn * m,
                "flash_attention_bwd": attn * m,
                "rglru_scan": (again * rec + rec_tail) * m,
                "rglru_scan_bwd": (rec + rec_tail) * m}
    if cfg.family == "ssm":
        unit, n_super = xlstm._pattern(cfg)
        ml = n_super * unit.count("mlstm")
        if kind == "decode":     # the recurrent form, no kernel
            return {}
        if kind == "prefill":
            return {"mlstm": ml}
        return {"mlstm": again * ml * m, "mlstm_bwd": ml * m}
    if cfg.family == "audio":
        if kind == "decode":     # self- and cross-attention a layer
            return {"flash_attention": 2 * cfg.num_layers}
        calls = cfg.num_encoder_layers + 2 * cfg.num_layers
        if kind == "prefill":
            return {"flash_attention": calls}
        return {"flash_attention": calls * m,
                "flash_attention_bwd": calls * m}
    if kind in ("decode", "prefill"):
        return {"flash_attention": cfg.num_layers}
    return {"flash_attention": again * cfg.num_layers * m,
            "flash_attention_bwd": cfg.num_layers * m}


def _reference_argument_bytes(arch, shape):
    """Bytes of the reference's abstract inputs of the cell's step (the
    decode cache's ``t``, a host int in the port, left out)."""
    jcfg = jax_reduced(arch)
    jmodel = jax_zoo.build_model(jcfg)
    _, shd = _one_device_sharder(jcfg)
    params = jmodel.table.abstract_sharded(shd)
    rshape = RefShape(shape.name, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, kind=shape.kind)
    leaves = _ref_leaves(params) + _ref_leaves(
        jax_zoo.input_specs(jmodel, rshape, shd))
    if shape.kind == "train":
        leaves += _ref_leaves(jax_opt_state(
            params, JaxAdamW(moment_dtype=jcfg.opt_moment_dtype), shd))
    if shape.kind == "decode":
        cache = jmodel.init_cache_abstract(shd, shape.global_batch,
                                           shape.seq_len)
        leaves += _ref_leaves({k: v for k, v in cache.items() if k != "t"})
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in leaves)


@pytest.mark.parametrize("arch", FAMILIES)
def test_kernel_entries_follow_the_layer_pattern(arch):
    cfg = dataclasses.replace(reduced_config(arch), microbatches=2) \
        if arch == "qwen3-14b" else reduced_config(arch)
    for kind, shape in SMALL.items():
        record, trace = dryrun.lower(cfg, shape)
        by_kernel = {}
        for e in trace.kernels.values():
            by_kernel[e["kernel"]] = by_kernel.get(e["kernel"], 0) + \
                e["count"]
        assert by_kernel == _expected_launches(cfg, kind), (arch, kind)
        assert sum(record["kernel_launches"].values()) == \
            sum(by_kernel.values())
        assert record["memory"]["argument_size_in_bytes"] == \
            _reference_argument_bytes(arch, shape), (arch, kind)
        # each entry's work is its kernel's own count on its shape
        for e in trace.kernels.values():
            work = roofline.kernel_work(e["kernel"], e["shape"])
            assert (e["flops"], e["bytes"]) == (work.flops, work.bytes)
        if kind == "train":      # params and moments update in place
            mem = record["memory"]
            batch = model_zoo.input_specs(model_zoo.build_model(cfg), shape,
                                          dryrun.Sharder(
                                              cfg, dryrun.one_card_mesh()))
            assert mem["alias_size_in_bytes"] == \
                mem["argument_size_in_bytes"] - sum(
                    x.value.numel() * x.value.element_size()
                    for x in batch.values())
            assert mem["temp_size_in_bytes"] > 0


def test_qwen3_decode_32k_at_full_width_on_meta():
    """qwen3-14b's decode step at 128 x 32,768 on ``meta``: 40 layers,
    each one call of B3's split-K decode kernel over every slot; ~30 GB of
    weights and ~690 GB of cache, none of it allocated."""
    cfg = get_config("qwen3-14b")
    shape = SHAPES["decode_32k"]
    record, trace = dryrun.lower(cfg, shape)
    assert record["kernel_launches"] == {"flash_attention.decode": 40}
    (entry,) = trace.kernels.values()
    assert entry["shape"] == dict(
        b=128, sq=1, sk=32768, h=cfg.num_heads_padded, kh=8, d=128,
        dtype="bfloat16", window=None, causal=True, with_lse=False)
    model = model_zoo.build_model(cfg)
    cache = 2 * 40 * 128 * 32768 * 8 * 128 * 2 + 32768 * 4
    assert record["memory"]["argument_size_in_bytes"] == \
        model.table.bytes() + cache + 128 * 4
    assert 29e9 < model.table.bytes() < 31e9 and 680e9 < cache < 700e9
    assert record["chips"] == 1 and record["mesh"] == "1x1"
    rl = roofline.analyze_cell("qwen3-14b", "decode_32k", record=record,
                               trace=trace.as_dict())
    assert rl.dominant == "memory" and rl.t_memory > 0.2


@pytest.mark.parametrize("arch", list_archs())
def test_run_cell_writes_what_analyze_cell_reads(arch, tmp_path,
                                                 monkeypatch):
    """Every applicable cell of the reduced config, the shapes cut to a
    few tokens (the names kept): a record and an op trace under the
    artifact directory, read back by ``analyze_cell``."""
    cut = {name: dataclasses.replace(s, seq_len=min(s.seq_len, 64),
                                     global_batch=min(s.global_batch, 2))
           for name, s in SHAPES.items()}
    monkeypatch.setattr(dryrun, "SHAPES", cut)
    monkeypatch.setattr(roofline, "SHAPES", cut)
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", tmp_path)
    cfg = reduced_config(arch)
    for name in cut:
        record = dryrun.run_cell(arch, name, multi_pod=False,
                                 verbose=False, cfg_override=cfg)
        if "skipped" in record:
            assert name == "long_500k"
            continue
        stem = f"{arch}__{name}__1x1"
        assert (tmp_path / f"{stem}.json").exists()
        assert Path(record["trace_path"]) == tmp_path / f"{stem}.trace.json"
        rl = roofline.analyze_cell(arch, name, cfg=cfg)
        assert rl.flops_per_chip == record["flops"] > 0
        assert rl.bytes_per_chip == record["bytes_accessed"] > 0
        assert rl.collective_per_chip == 0 and rl.t_collective == 0
        assert 0 < rl.useful_ratio


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_multi_pod_raises_the_device_count_error(flag, monkeypatch):
    called = []
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: called.append(a))
    with pytest.raises(RuntimeError, match="need 512 devices"):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k", flag])
    assert called == []


def test_meta_kernel_calls_record_and_launch_nothing():
    """On ``meta`` the wrappers plan as on an H100, return outputs of the
    kernel's shapes (lse and row stats included), go through the autograd
    Functions, record one entry a call while a trace records, and count
    no launch."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    meta = dict(device="meta")
    before = (dict(fa_kernel.LAUNCHES), dict(ml_kernel.LAUNCHES))
    q = torch.empty(2, 128, 8, 128, dtype=torch.bfloat16, **meta)
    kv = torch.empty(2, 128, 2, 128, dtype=torch.bfloat16, **meta)
    out, lse = fa_kernel.flash_attention_cuda(q, kv, kv, with_lse=True)
    assert (out.shape, lse.shape, lse.dtype) == \
        (q.shape, (2, 8, 128), torch.float32)
    a = torch.empty(1, 64, 256, **meta)
    mq = torch.empty(1, 64, 4, 512, dtype=torch.bfloat16, **meta)
    gates = torch.empty(1, 64, 4, **meta)
    trace = dryrun.OpTrace()
    with trace.recording(), torch.enable_grad():
        leaves = [x.requires_grad_() for x in (q.clone(), kv.clone(),
                                               kv.clone())]
        o = fa_ops.flash_attention(*leaves)
        torch.autograd.grad(o.sum(), leaves)
        h, _ = rg_ops.rglru_scan(a.requires_grad_(), a.clone())
        torch.autograd.grad(h.sum(), [a])
        y = ml_ops.mlstm(mq.requires_grad_(), mq, mq, gates, gates)
        torch.autograd.grad(y.float().sum(), [mq])
    assert trace.kernel_launches() == {
        "flash_attention.wgmma": 1, "flash_attention_bwd.wgmma": 1,
        "mlstm.wgmma": 1, "mlstm_bwd.wgmma": 1, "rglru_scan.bulk": 1,
        "rglru_scan_bwd.bulk": 1}
    assert (dict(fa_kernel.LAUNCHES), dict(ml_kernel.LAUNCHES)) == before


def test_temp_memory_sees_what_only_autograd_holds():
    """Storages that only autograd's saved tensors hold stay live in the
    count; a freed one leaves it; a view adds nothing."""
    n = 1 << 20
    x = torch.empty(n, device="meta", requires_grad=True)
    trace = dryrun.OpTrace()
    trace.arguments([x])
    with trace.recording(), torch.enable_grad():
        y = torch.sin(x)         # sin saves x, an argument
        z = torch.exp(y)         # exp saves its output z
        del y                    # freed: nothing saved it
        w = (z * 2).view(-1)     # a new storage, its view free
        del z                    # still saved by exp
        v = w * w                # saves w
        del w
        loss = v.sum()
    trace.set_outputs(loss)
    mem = trace.memory()
    assert mem["argument_size_in_bytes"] == 4 * n
    assert 12 * n <= mem["temp_size_in_bytes"] <= 12 * n + 64
    assert mem["output_size_in_bytes"] == 4 and \
        mem["alias_size_in_bytes"] == 0


def test_trace_mismatch_names_the_first_difference():
    a = {"ops": [["aten.mm.default", [[[2, 3], "float32"]], [], 0, 0]],
         "kernels": []}
    b = {"ops": [["aten.mm.default", [[[2, 4], "float32"]], [], 0, 0]],
         "kernels": []}
    assert dryrun.trace_mismatch(a, a) is None
    assert dryrun.trace_mismatch(a, b).startswith("ops differ from 0 to 1")
    c = {**a, "ops": a["ops"] + [["aten.add.Tensor", [], [], 0, 0]] * 2}
    assert "in the second {'aten.add.Tensor': 2}" in \
        dryrun.trace_mismatch(a, c)
    k = {"kernel": "mlstm", "variant": "wgmma", "shape": {}, "count": 1,
         "flops": 1, "bytes": 1, "dtype": "bfloat16"}
    d = {**a, "kernels": [k]}
    assert "kernel entries differ" in dryrun.trace_mismatch(a, d)


@pytest.mark.parametrize("arch,layers,kind,seq,batch,micro", [
    ("qwen3-14b", 1, "train", 64, 4, 2),
    ("qwen3-14b", 1, "prefill", 64, 1, None),
    ("qwen3-14b", 1, "decode", 24, 2, None),
    # 4 layers do not split into its 8 remat segments: served, not trained
    ("grok-1-314b", 4, "prefill", 64, 1, None),
])
def test_cli_predicts_a_cell_outside_the_shapes(arch, layers, kind, seq,
                                               batch, micro, capsys):
    """``--seq-len`` lowers a cell outside SHAPES at a cut depth and
    microbatch count (the cells chip_smoke.py predicts) and prints one
    JSON line: the predicted peak is the arguments and temps of
    :func:`dryrun.predict`'s record for the same cell."""
    argv = ["--arch", arch, "--layers", str(layers), "--kind", kind,
            "--seq-len", str(seq), "--batch", str(batch)]
    dryrun.main(argv + (["--microbatches", str(micro)] if micro else []))
    got = json.loads(capsys.readouterr().out)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if micro:
        cfg = dataclasses.replace(cfg, microbatches=micro)
    record, _ = dryrun.predict(cfg, dryrun.cell(kind, seq, batch))
    mem = record["memory"]
    assert got["cell"] == f"{kind}_{batch}x{seq}" and \
        got["layers"] == layers
    assert got["microbatches"] == cfg.microbatches
    assert record["predicted_peak_bytes"] == \
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert got["predicted_peak_gb"] == record["predicted_peak_bytes"] / 1e9
    assert got["kernel_launches"] == record["kernel_launches"]


def test_cli_cell_needs_its_kind_and_batch():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-14b", "--seq-len", "64"])
