"""The yardstick's arithmetic (``work.py``) against the port's own
analysis, which it copies with the published heads."""
import dataclasses

import pytest

from portbench import harness, work


def numbers(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_model_flops_is_the_port_s_less_its_padded_heads():
    """qwen3-14b at 8 layers, 8 x 1 x 2048 (the port's train cell):
    analysis/flops.py counts 48 heads and a vocabulary padded to 152,064,
    3.446e14 a step; the copy counts the 40 published heads and the
    151,936 published entries, so it reads the padded heads' wq and wo
    and the padded rows of the output head less."""
    from repro_torch.analysis.flops import model_flops
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config("qwen3-14b"), num_layers=8)
    tokens = 8 * 2048
    port = model_flops(cfg, dryrun.cell("train", 2048, 8))
    assert port == pytest.approx(3.446e14, rel=1e-3)
    padded = cfg.num_layers * 2 * cfg.d_model * \
        (cfg.num_heads_padded - cfg.num_heads) * cfg.head_dim
    assert (cfg.vocab_padded, cfg.vocab_size) == (152064, 151936)
    vocab = cfg.d_model * (cfg.vocab_padded - cfg.vocab_size)
    assert work.model_flops(numbers(cfg), "train", tokens, 8) == \
        pytest.approx(port - 6.0 * (padded + vocab) * tokens, rel=1e-12)


def test_model_flops_equal_the_port_s_without_padding():
    from repro_torch.analysis.flops import model_flops
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config("chatglm3-6b"), num_layers=18)
    assert cfg.vocab_padded == cfg.vocab_size
    assert work.model_flops(numbers(cfg), "train", 4 * 4096, 4) == \
        pytest.approx(model_flops(cfg, dryrun.cell("train", 4096, 4)),
                      rel=1e-12)


def test_a_prefill_counts_the_unembedding_at_the_served_position():
    """A prefill serves the last position's logits: the layers' 2 N a
    token over every position, the unembedding's 2 d V once a prompt.
    The port's analysis counts the unembedding at every position (and,
    for qwen3-14b, the padded heads and vocabulary): whole qwen3-14b at
    32,768 tokens, 5.6 % of its count is the unembedding of positions
    that are not served."""
    from repro_torch.analysis.flops import model_flops
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    cfg = get_config("qwen3-14b")
    m, length = numbers(cfg), 32768
    layers = 2.0 * work.active_params(m)
    unembed = 2.0 * m["d_model"] * m["vocab_size"]
    assert work.model_flops(m, "prefill", length, 1) == \
        layers * length + unembed
    assert work.model_flops(m, "prefill", 3 * length, 3) == \
        pytest.approx(3 * work.model_flops(m, "prefill", length, 1))
    port = model_flops(cfg, dryrun.cell("prefill", length, 1))
    padded = cfg.num_layers * 2 * cfg.d_model * \
        (cfg.num_heads_padded - cfg.num_heads) * cfg.head_dim
    unserved = 2.0 * cfg.d_model * cfg.vocab_padded * length - unembed
    assert work.model_flops(m, "prefill", length, 1) == pytest.approx(
        port - 2.0 * padded * length - unserved, rel=1e-12)
    assert unserved / port == pytest.approx(0.056, abs=0.002)


@pytest.mark.parametrize("fn", ["flash_attention_work",
                                "flash_attention_bwd_work"])
def test_attention_work_is_the_port_s(fn):
    from repro_torch.analysis import roofline
    for args, kw in (((1, 4096, 4096, 40, 8, 128), {}),
                     ((2, 300, 1000, 8, 2, 64), {"window": 128}),
                     ((1, 64, 64, 4, 4, 32), {"causal": False})):
        mine, port = getattr(work, fn)(*args, **kw), \
            getattr(roofline, fn)(*args, **kw)
        assert (mine.flops, mine.bytes, mine.dtype) == \
            (port.flops, port.bytes, port.dtype)
        b_ms, _ = roofline.bound_ms(port)
        assert work.bound_s(mine) == pytest.approx(
            max(b_ms, port.flops / roofline.PEAK_FLOPS * 1e3) / 1e3)


def test_idle_share_is_the_union_of_intervals():
    """Two kernels that overlap and together cover half of a window:
    busy 50 %, where the sum of their lengths would say 75 %."""
    window = (0.0, 1.0)
    kernels = [(0.0, 0.375), (0.125, 0.5)]
    assert work.union_s(kernels, *window) == pytest.approx(0.5)
    assert sum(t - s for s, t in kernels) == pytest.approx(0.75)
    from portbench.trace import Trace
    trace = Trace(0.0, 1.0, [(s, t, "k") for s, t in kernels], [])
    assert trace.busy_s == pytest.approx(0.5)
    assert trace.gaps() == [(0.5, 1.0, "k")]
    cell = harness.load_cell(harness_root(), "chatglm3-6b.train-4k")
    reader = cell.code("metrics", "idle_share.train")
    run = harness.Run(cell, kind=None, units=1, window_s=1.0, trace=trace)
    assert reader.read(run) == pytest.approx(50.0)


def test_kernels_are_picked_by_name_and_gaps_named_by_the_host():
    """A reader's kernels are the device intervals of their names, cut
    to the window; an idle gap is named by the runtime call the host was
    in, else by the device operation it follows."""
    from portbench.trace import Trace
    device = [(-0.1, 0.1, "fa_bwd_dq_wgmma_kernel<128>"),
              (0.2, 0.3, "nvjet_gemm"),
              (0.5, 0.6, "void fa_bwd_dkdv_wgmma_kernel<128>"),
              (0.65, 0.7, "nvjet_gemm")]
    runtime = [(0.52, 0.64, "cudaStreamSynchronize"),
               (0.35, 0.36, "cudaLaunchKernel"),
               (0.69, 0.71, "cudaLaunchKernel")]
    trace = Trace(0.0, 1.0, device, sorted(runtime))
    seconds, n = trace.device_s_named(lambda name: "fa_bwd_" in name)
    assert (seconds, n) == (pytest.approx(0.2), 2)
    assert trace.device_s_named(lambda name: "flash_wgmma" in name) == \
        (0.0, 0)
    assert trace.gaps() == [(0.1, 0.2, device[0][2]),
                            (0.3, 0.5, "nvjet_gemm"),
                            (0.6, 0.65, device[2][2]),
                            (0.7, 1.0, "nvjet_gemm")]
    idle = dict(trace.breakdown()["idle_gaps"])
    assert idle == pytest.approx({
        f"after {device[0][2]}": 0.1, "after nvjet_gemm": 0.5,
        "cudaStreamSynchronize": 0.05})
    cell = harness.load_cell(harness_root(), "chatglm3-6b.train-4k")
    trace.units = 1
    run = harness.Run(cell, kind=None, units=1, window_s=1.0, trace=trace)
    m = cell.model
    bound = work.bound_s(work.flash_attention_bwd_work(
        1, 4096, 4096, m["num_heads"], m["num_kv_heads"], m["head_dim"]))
    assert cell.code("metrics", "flash_bwd_roofline.train").read(run) == \
        pytest.approx(100.0 * m["num_layers"] * m["microbatches"] * bound
                      / 0.2)
    trace.device = [d for d in device if "fa_bwd_" not in d[2]]
    assert cell.code("metrics", "flash_bwd_roofline.train").read(run) is None


def harness_root():
    from pathlib import Path
    return Path(__file__).resolve().parents[2]


def test_profiler_events_are_sorted_by_device_and_name():
    """The card's torch gives profiler events no activity type: kernels,
    copies, fills and runtime calls are told apart by device and name."""
    from torch.autograd import DeviceType

    from portbench.trace import _activity

    class Event:
        def __init__(self, name, device):
            self._name, self._device = name, device

        def name(self):
            return self._name

        def device_type(self):
            return self._device

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    want = {("nvjet_tst_128x256", cuda): "kernel",
            ("Memcpy HtoD (Pageable -> Device)", cuda): "gpu_memcpy",
            ("Memset (Device)", cuda): "gpu_memset",
            ("cudaLaunchKernel", cpu): "cuda_runtime",
            ("cuLaunchKernelEx", cpu): "cuda_runtime",
            ("aten::mm", cpu): ""}
    for (name, device), kind in want.items():
        assert _activity(Event(name, device)) == kind
