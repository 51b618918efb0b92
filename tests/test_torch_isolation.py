"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; every entry point runs
on ``cuda`` unless told otherwise and raises when there is no card; and a
kernel wrapper raises, never falls back, on a tensor it cannot serve."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.geps_events import reduced
from repro_torch.core import events as ev
from repro_torch.core.backend import SimulatedBackend, SpmdBackend
from repro_torch.core.brick import create_store, store_from_reference
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.core.jse import spmd_query_batch_step, spmd_query_step
from repro_torch.kernels import resolve_device
from repro_torch.kernels.event_filter import kernel as ef_kernel
from repro_torch.kernels.event_filter import ops as ef_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.rglru_scan import kernel as rg_kernel
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.configs.registry import reduced_config as reduced_config_lm
from repro_torch.models.params import params_from_reference
from repro_torch.service import QueryService
from test_torch_parity import operands, ref_store, stores

REPO = Path(__file__).resolve().parents[1]
SCHEMA = ev.EventSchema.from_config(reduced())
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_no_port_file_imports_jax_or_the_reference():
    assert len(PORT_FILES) > 20
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(REPO)} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.service\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.kernels.flash_attention import ops as fa_ops\n"
        "from repro_torch.models import model_zoo, transformer\n"
        "for arch in ('qwen3-14b', 'recurrentgemma-9b', 'xlstm-350m'):\n"
        "    repro_torch.launch.serve.main(['--mode', 'lm', '--arch', arch, "
        "'--reduced', '--device', 'cpu', '--new-tokens', '2'])\n"
        "from repro_torch.kernels.rglru_scan import ops as rg_ops, kernel\n"
        "from repro_torch.kernels.mlstm_scan import ops as ml_ops, kernel\n"
        "from repro_torch.models import hybrid, rglru, xlstm\n"
        "from repro_torch.kernels.event_filter import ops, kernel\n"
        "from repro_torch.configs.geps_events import reduced\n"
        "from repro_torch.core import events as ev\n"
        "from repro_torch.core.brick import create_store\n"
        "s = create_store(ev.EventSchema.from_config(reduced()), n_events=32,"
        " n_nodes=2, events_per_brick=16, device='cpu')\n"
        "svc = repro_torch.service.QueryService(s, backend='spmd', "
        "backend_kwargs={'use_pallas': True}, device='cpu')\n"
        "svc.submit('e_total > 40 && count(pt > 15) >= 2'); svc.drain()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("\nok")


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="'cuda'"):
        create_store(SCHEMA, n_events=16, n_nodes=2, events_per_brick=16)
    with pytest.raises(RuntimeError, match="'cuda'"):
        store_from_reference(ref_store(n_events=16))
    _, store = stores(n_events=32)
    cat = MetadataCatalog(store.n_nodes)
    for build in (lambda: SpmdBackend(cat, store),
                  lambda: SimulatedBackend(cat, store),
                  lambda: QueryService(store),
                  lambda: spmd_query_step("e_total > 40", SCHEMA),
                  lambda: spmd_query_batch_step(["e_total > 40"], SCHEMA),
                  lambda: ev.synthetic_events(torch.Generator(), SCHEMA, 4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    with pytest.raises(RuntimeError, match="'cuda'"):
        params_from_reference(reduced_config_lm("qwen3-14b"), {})
    with pytest.raises(RuntimeError, match="'cuda:1'"):
        resolve_device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_launcher_defaults_to_cuda():
    _require_no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--queries", "4", "--n-events", "32"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mode", "lm", "--arch", "qwen3-14b", "--reduced"])


def test_kernel_wrappers_refuse_tensors_they_cannot_serve():
    import numpy as np
    sc, tr, nt = (torch.from_numpy(a) for a in
                  operands(np.random.default_rng(0), 8, 16, 3))
    th = torch.tensor([[40.0], [15.0], [2.0], [-1.0]])
    vi = torch.tensor([0], dtype=torch.int32)
    launches = dict(ef_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ef_kernel.event_filter_batch_cuda(sc, tr, nt, th, vi, calib_iters=0)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ef_kernel.event_filter_cuda(sc, tr, nt, th[:, 0].contiguous(), vi,
                                    calib_iters=0)
    meta = [x.to("meta") for x in (sc, tr, nt, th, vi)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ef_ops.event_filter_batch(*meta, calib_iters=0)
    with pytest.raises(ValueError, match="different devices"):
        ef_ops.event_filter_batch(sc, tr, nt, th, vi.to("meta"),
                                  calib_iters=0)
    assert ef_kernel.LAUNCHES == launches


def test_flash_wrapper_refuses_tensors_it_cannot_serve():
    q = torch.zeros((1, 2, 4, 16))
    k = v = torch.zeros((1, 2, 2, 16))
    launches = dict(fa_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa_kernel.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa_ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        fa_ops.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="do not group"):
        fa_ops.flash_attention(q[:, :, :3], k, v)
    assert fa_kernel.LAUNCHES == launches


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_recurrent_families_default_to_cuda_and_raise_without_it(arch):
    _require_no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--mode", "lm", "--arch", arch, "--reduced"])
    with pytest.raises(RuntimeError, match="'cuda'"):
        params_from_reference(reduced_config_lm(arch), {})


def test_rglru_scan_wrapper_refuses_tensors_it_cannot_serve():
    a = torch.rand((2, 6, 8))
    b = torch.rand((2, 6, 8))
    h0 = torch.rand((2, 8))
    launches = dict(rg_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rg_kernel.rglru_scan_cuda(a, b, h0)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rg_kernel.rglru_scan_cuda(a, b)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rg_ops.rglru_scan(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        rg_ops.rglru_scan(a, b.to("meta"), h0)
    with pytest.raises(ValueError, match="zero-sized"):
        rg_kernel.rglru_scan_cuda(a[:, :0], b[:, :0])
    with pytest.raises(ValueError, match="one shape"):
        rg_kernel.rglru_scan_cuda(a, b[..., :4])
    with pytest.raises(ValueError, match="h0"):
        rg_kernel.rglru_scan_cuda(a, b, h0[:1])
    assert rg_kernel.LAUNCHES == launches


def test_mlstm_wrapper_refuses_tensors_it_cannot_serve():
    q = k = v = torch.zeros((1, 8, 2, 16))
    li = lf = torch.zeros((1, 8, 2))
    launches = dict(ml_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ml_kernel.mlstm_cuda(q, k, v, li, lf)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ml_ops.mlstm(*(x.to("meta") for x in (q, k, v, li, lf)))
    with pytest.raises(ValueError, match="different devices"):
        ml_ops.mlstm(q, k, v, li.to("meta"), lf)
    with pytest.raises(ValueError, match="zero-sized"):
        ml_kernel.mlstm_cuda(*(x[:, :0] for x in (q, k, v, li, lf)))
    with pytest.raises(ValueError, match="one shape"):
        ml_kernel.mlstm_cuda(q, k[:, :4], v, li, lf)
    with pytest.raises(ValueError, match=r"\(B,S,H\)"):
        ml_kernel.mlstm_cuda(q, k, v, li[..., :1], lf)
    assert ml_kernel.LAUNCHES == launches


def test_kernel_build_reports_a_missing_nvcc(monkeypatch, tmp_path):
    from repro_torch import kernels
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels, "CUDA_HOME_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_cuda_library(ef_kernel.SOURCE)
    assert not list(tmp_path.iterdir())


def test_kernel_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    from repro_torch import kernels
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    build = tmp_path / "build"
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no sm_90a here"):
        kernels.build_cuda_library(ef_kernel.SOURCE)
    assert list(build.iterdir()) == []   # no half-written library left
