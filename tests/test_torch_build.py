"""The port's kernel build key, on the CPU (no nvcc needed).

A built library is named by a hash of the flags and of every file a
build of the source can read: the ``.cu`` itself, the other files of its
``csrc/`` directory and the shared header directory (``INCLUDE_DIRS``).
Editing only a header must therefore give another library path, or the
card would keep running a stale library."""
import sys
from pathlib import Path

import pytest

from repro_torch import kernels


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    common = tmp_path / "common"
    csrc.mkdir()
    common.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n#include "h.cuh"\n')
    (csrc / "k.cuh").write_text("// local header\n")
    (common / "h.cuh").write_text("// shared header\n")
    monkeypatch.setattr(kernels, "INCLUDE_DIRS", (common,))
    return csrc / "k.cu", csrc / "k.cuh", common / "h.cuh"


def test_library_path_is_stable(sources):
    source, _, _ = sources
    assert kernels._library_path(source) == kernels._library_path(source)
    assert kernels._library_path(source).name.startswith("k_")


@pytest.mark.parametrize("edited", [0, 1, 2],
                         ids=["source", "csrc header", "shared header"])
def test_editing_any_input_changes_the_library_path(sources, edited):
    before = kernels._library_path(sources[0])
    path = sources[edited]
    path.write_text(path.read_text() + "// edited\n")
    assert kernels._library_path(sources[0]) != before


def test_a_new_header_changes_the_library_path(sources):
    source, header, _ = sources
    before = kernels._library_path(source)
    (header.parent / "extra.cuh").write_text("// new\n")
    assert kernels._library_path(source) != before


def test_flags_are_part_of_the_key(sources, monkeypatch):
    source = sources[0]
    before = kernels._library_path(source)
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels._library_path(source) != before


def test_the_shared_header_directory_is_the_packages():
    (common,) = kernels.INCLUDE_DIRS
    assert common == Path(kernels.__file__).resolve().parent / "common"
    assert (common / "hopper.cuh").is_file()


@pytest.mark.parametrize("mangled,name", [
    ("_ZN11mlstm_wgmma18mlstm_wgmma_kernelILi512EEEv14CUtensorMap_stS1_S1_"
     "NS_6ParamsE", "mlstm_wgmma_kernel<512>"),
    ("_ZN11mlstm_wgmma18mlstm_gates_kernelEPKfS1_xxiiiifPfPii",
     "mlstm_gates_kernel"),
    ("_ZN46_GLOBAL__N__cdd7eb3f_13_mlstm_scan_cu_71d1d95612mlstm_kernelI13"
     "__nv_bfloat16Li64EEEvNS_6ParamsE", "mlstm_kernel<bf16,64>"),
    ("_ZN46_GLOBAL__N__cdd7eb3f_13_mlstm_scan_cu_71d1d95612mlstm_kernelIfLi64"
     "EEEvNS_6ParamsE", "mlstm_kernel<f32,64>"),
    ("_ZN8fa_wgmma18flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_6"
     "ParamsE", "flash_wgmma_kernel<128>"),
    ("_ZN12_GLOBAL__N_125event_filter_batch_kernelEPKfS1_PKiS1_S3_PfS4_"
     "lllii", "event_filter_batch_kernel"),
    ("_ZN46_GLOBAL__N__3f0a9c21_13_rglru_scan_cu_5e1b2c7a20rglru_chunked_"
     "kernelENS_6ParamsE", "rglru_chunked_kernel"),
    ("_ZN55_GLOBAL__N__62bea9e3_22_flash_attention_bwd_cu_04843d3018fa_bwd_"
     "dkdv_kernelIfLi32EEEvNS_6ParamsE", "fa_bwd_dkdv_kernel<f32,32>"),
    ("_ZN55_GLOBAL__N__62bea9e3_22_flash_attention_bwd_cu_04843d3016fa_bwd_"
     "dq_kernelI13__nv_bfloat16Li128EEEvNS_6ParamsE",
     "fa_bwd_dq_kernel<bf16,128>"),
    ("_ZN12fa_bwd_wgmma24fa_bwd_dkdv_wgmma_kernelILi128EEEv14CUtensorMap_"
     "stS1_S1_S1_NS_6ParamsE", "fa_bwd_dkdv_wgmma_kernel<128>"),
    ("_ZN12fa_bwd_wgmma17fa_bwd_sum_kernelEPKfP13__nv_bfloat16S3_xi",
     "fa_bwd_sum_kernel"),
    ("_ZN55_GLOBAL__N__62bea9e3_22_flash_attention_bwd_cu_63886b0a19fa_bwd_"
     "delta_kernelI13__nv_bfloat16Li128EEEvPKvS3_PKfPfS6_llllllllll",
     "fa_bwd_delta_kernel<bf16,128>"),
    # the tensor-core backward at head dim 256: two kernels of no template
    # argument, and the delta pre-pass's instance
    ("_ZN12fa_bwd_wgmma24fa_bwd_dkdv_roles_kernelE14CUtensorMap_stS0_S0_S0_"
     "NS_6ParamsE", "fa_bwd_dkdv_roles_kernel"),
    ("_ZN12fa_bwd_wgmma22fa_bwd_dq_roles_kernelE14CUtensorMap_stS0_S0_S0_NS_"
     "6ParamsE", "fa_bwd_dq_roles_kernel"),
    ("_ZN55_GLOBAL__N__62bea9e3_22_flash_attention_bwd_cu_63886b0a19fa_bwd_"
     "delta_kernelI13__nv_bfloat16Li256EEEvPKvS3_PKfPfS6_llllllllll",
     "fa_bwd_delta_kernel<bf16,256>"),
    # the mLSTM backward's tensor-core variant: its planes pass and the
    # dK/dV and dQ kernels, none with a template argument
    ("_ZN50_GLOBAL__N__1a2b3c4d_17_mlstm_scan_bwd_cu_5e6f7a8b23mlstm_bwd_"
     "planes_kernelENS_6ParamsEPfif",
     "mlstm_bwd_planes_kernel"),
    ("_ZN15mlstm_bwd_wgmma27mlstm_bwd_dkdv_wgmma_kernelE14CUtensorMap_stS0_"
     "S0_S0_NS_6ParamsE", "mlstm_bwd_dkdv_wgmma_kernel"),
    ("_ZN15mlstm_bwd_wgmma25mlstm_bwd_dq_wgmma_kernelE14CUtensorMap_stS0_S0_"
     "S0_NS_6ParamsE", "mlstm_bwd_dq_wgmma_kernel"),
])
def test_ptxas_report_names_each_kernel_instance(mangled, name):
    """chip_smoke.py reads registers and spills per kernel instance from
    ptxas's report and fails a run whose flash, mlstm or rglru_scan
    instances spill: the instance must be named by its template
    arguments."""
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    assert chip_smoke.kernel_name(mangled) == name


def test_mlstm_backward_ablation_switches_are_the_kernels_own():
    """scripts/mlstm_bwd_ablation.py times the mLSTM tensor-core backward
    with #defines set before its source: each switch it sets must be one
    that mlstm_bwd_wgmma.cuh reads and defaults to 0."""
    import importlib.util
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "mlstm_bwd_ablation", root / "scripts" / "mlstm_bwd_ablation.py")
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    header = (root / "src" / ablation.SOURCE).with_name(
        "mlstm_bwd_wgmma.cuh").read_text()
    switches = {s for names in ablation.SWITCHES.values() for s in names}
    assert ablation.SWITCHES["full"] == ()
    assert switches
    for switch in switches:
        assert f"#ifndef {switch}\n#define {switch} 0\n#endif" in header
        assert f"{switch} != 0" in header
