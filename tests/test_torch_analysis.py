"""The port's ``analysis/`` against the JAX package's, on the CPU.

- ``flops.param_counts`` and ``flops.model_flops`` equal the reference's
  bit for bit for all ten architectures and the four shape cells.
- ``hlo_parse`` is a copy of the reference's walker: its ``Totals`` equal
  the reference's on HLO that JAX emits here (a jitted scan over a dot, so
  a ``while`` with a trip count; an elementwise chain XLA fuses) and on a
  literal module with an ``all-reduce``.
- ``roofline.analyze_cell`` on the same HLO and record gives the
  reference's per-chip flops and bytes, collective terms, MODEL_FLOPS and
  useful ratio exactly; its times are the reference's rescaled by the
  ratio of the peaks (an H100's against a TPU v5e's).
- ``hlo_parse.analyze_trace`` of a dry-run trace: its matmul flops equal
  ``torch.utils.flop_counter.FlopCounterMode``'s over the same step.
- The LM kernels' work counts give the bound column of ``PERF.md``'s
  kernel table at its shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import flops as ref_flops
from repro.analysis import hlo_parse as ref_hlo
from repro.analysis import roofline as ref_roofline
from repro.configs import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro_torch.analysis import flops, hlo_parse, roofline
from repro_torch.configs import SHAPES, list_archs, reduced_config
from repro_torch.launch import dryrun

ALL_REDUCE_HLO = """HloModule literal_all_reduce, entry_computation_layout={(f32[64,128]{1,0}, f32[128,32]{1,0})->f32[128,32]{1,0}}

%add (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %x, f32[] %y)
}

ENTRY %main (p0: f32[64,128], p1: f32[128,32]) -> f32[128,32] {
  %p0 = f32[64,128]{1,0} parameter(0)
  %p1 = f32[128,32]{1,0} parameter(1)
  %d = f32[64,32]{1,0} dot(f32[64,128]{1,0} %p0, f32[128,32]{1,0} %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[64,32]{1,0} all-reduce(f32[64,32]{1,0} %d), replica_groups={}, to_apply=%add
  ROOT %ag = f32[128,32]{1,0} all-gather(f32[64,32]{1,0} %ar), dimensions={0}
}
"""


def _jax_hlo(case: str) -> str:
    """Optimized HLO that JAX emits on the CPU for one small program."""
    x = jnp.ones((8, 64), jnp.float32)
    w = jnp.ones((64, 64), jnp.float32)
    if case == "scan_dot":
        def f(x, w):
            def body(c, _):
                return jnp.tanh(c @ w), None
            c, _ = jax.lax.scan(body, x, None, length=7)
            return c
    else:   # an elementwise chain around a dot, fused by XLA
        def f(x, w):
            y = jnp.exp(x * 2.0 + 1.0) @ w
            return jnp.sum(jnp.sin(y) * y, axis=0)
    return jax.jit(f).lower(x, w).compile().as_text()


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_and_model_flops_equal_the_reference(arch):
    from repro_torch.configs import get_config
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert flops.param_counts(cfg) == ref_flops.param_counts(jcfg)
    for name, shape in SHAPES.items():
        got = flops.model_flops(cfg, shape)
        want = ref_flops.model_flops(jcfg, REF_SHAPES[name])
        assert got == want and type(got) is type(want), (name, got, want)


@pytest.mark.parametrize("case", ["scan_dot", "fusion", "all_reduce"])
def test_hlo_parse_totals_equal_the_reference(case):
    hlo = ALL_REDUCE_HLO if case == "all_reduce" else _jax_hlo(case)
    got, want = hlo_parse.analyze(hlo), ref_hlo.analyze(hlo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if case == "scan_dot":     # the walker read the loop's trip count
        assert [trip for _, trip, _ in got.while_loops] == [7]
        assert got.flops == 7 * 2 * 8 * 64 * 64
    if case == "fusion":
        assert "fusion" in hlo and got.flops == 2 * 8 * 64 * 64
    if case == "all_reduce":
        assert got.flops == 2 * 64 * 32 * 128
        assert got.collective_bytes == 2 * 64 * 32 * 4
        assert set(got.collective_by_op) == {"all-reduce", "all-gather"}


@pytest.mark.parametrize("arch,shape", [("qwen3-14b", "train_4k"),
                                        ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                                        ("xlstm-350m", "prefill_32k")])
@pytest.mark.parametrize("case", ["scan_dot", "all_reduce"])
def test_analyze_cell_on_hlo_equals_the_reference(arch, shape, case):
    hlo = ALL_REDUCE_HLO if case == "all_reduce" else _jax_hlo(case)
    record = {"flops": 123.0}
    want = ref_roofline.analyze_cell(arch, shape, mesh="16x16",
                                     hlo_text=hlo, record=record)
    got = roofline.analyze_cell(arch, shape, mesh="16x16", hlo_text=hlo,
                                record={**record, "chips": 256})
    for key in ("flops_per_chip", "bytes_per_chip", "collective_per_chip",
                "model_flops_total", "useful_ratio", "collective_by_op",
                "cost_analysis_flops", "arch", "shape", "mesh"):
        assert getattr(got, key) == getattr(want, key), key
    ratios = {"t_compute": ref_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS,
              "t_memory": ref_roofline.HBM_BW / roofline.HBM_BW,
              "t_collective": ref_roofline.ICI_BW / roofline.NVLINK_BW}
    for key, ratio in ratios.items():
        assert getattr(got, key) == pytest.approx(
            getattr(want, key) * ratio, rel=1e-12, abs=0), key
    assert got.dominant == max(
        ("compute", "memory", "collective"),
        key=lambda k: getattr(got, f"t_{k}"))
    assert roofline.format_row(got).startswith(f"| {arch} | {shape} | ")


def test_analyze_trace_counts_what_flop_counter_counts():
    """The dry run's matmul flops over a reduced train step equal
    ``FlopCounterMode``'s (the same registry) over the same step; the
    trace adds its kernel entries' flops and bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = reduced_config("qwen3-14b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
    step, args = dryrun.step_inputs(cfg, shape, dryrun.one_card_mesh())
    trace = dryrun.trace_step(step, args).as_dict()
    step, args = dryrun.step_inputs(cfg, shape, dryrun.one_card_mesh())
    with FlopCounterMode(display=False) as counter:
        step(*args)
    totals = hlo_parse.analyze_trace(trace)
    kernel_flops = sum(e["count"] * e["flops"] for e in trace["kernels"])
    kernel_bytes = sum(e["count"] * e["bytes"] for e in trace["kernels"])
    assert totals.flops - kernel_flops == counter.get_total_flops() > 0
    assert totals.bytes - kernel_bytes == sum(op[4] for op in trace["ops"])
    assert totals.collective_bytes == 0 and totals.while_loops == []


# the bound column of PERF.md's kernel table: (work, bound ms, bound by)
BOUNDS = [
    ("B3 qwen3 decode", roofline.flash_attention_work(2, 1, 24, 48, 8, 128),
     0.0000734, "bytes"),
    ("B3 qwen3 prefill",
     roofline.flash_attention_work(1, 2048, 2048, 48, 8, 128), 0.0521,
     "operations"),
    ("B3 recurrentgemma decode",
     roofline.flash_attention_work(2, 1, 24, 16, 1, 256), 0.0000245,
     "bytes"),
    ("B3 recurrentgemma forward",
     roofline.flash_attention_work(1, 4096, 4096, 16, 1, 256, window=2048),
     0.1042, "operations"),
    ("B3 whisper encoder",
     roofline.flash_attention_work(2, 1500, 1500, 16, 16, 64, causal=False),
     0.01864, "operations"),
    ("B3 whisper cross decode",
     roofline.flash_attention_work(2, 1, 1500, 16, 16, 64, causal=False),
     0.00367, "bytes"),
    ("B3 whisper cross forward",
     roofline.flash_attention_work(1, 448, 1500, 16, 16, 64, causal=False),
     0.00278, "operations"),
    ("B3 bwd D 128",
     roofline.flash_attention_bwd_work(2, 2048, 2048, 32, 2, 128,
                                       window=4096), 0.1738, "operations"),
    ("B3 bwd D 256",
     roofline.flash_attention_bwd_work(1, 2048, 2048, 16, 1, 256,
                                       window=2048), 0.0869, "operations"),
    ("B3 bwd simt f32",
     roofline.flash_attention_bwd_work(1, 2048, 2048, 16, 1, 256, "float32",
                                       window=2048), 1.2827, "operations"),
    ("B4", roofline.rglru_scan_work(1, 4096, 4096), 0.0601, "bytes"),
    ("B4 bwd", roofline.rglru_scan_bwd_work(1, 2048, 4096), 0.0501, "bytes"),
    ("B5", roofline.mlstm_work(1, 2048, 4, 512), 0.0174, "operations"),
    ("B5 bwd", roofline.mlstm_bwd_work(2, 2048, 4, 512), 0.0869,
     "operations"),
]


@pytest.mark.parametrize("name,work,ms,by", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_kernel_work_gives_the_tables_bound(name, work, ms, by):
    got, got_by = roofline.bound_ms(work)
    assert got_by == by
    assert got == pytest.approx(ms, rel=5e-3), name


def test_work_counts_read_what_each_call_moves_and_does():
    """Inputs read once, outputs written once, the work of each valid
    (query, key) pair; lse, row stats and h0 add their bytes."""
    w = roofline.flash_attention_work(1, 4, 4, 2, 1, 16)
    assert w.flops == 4 * 2 * (1 + 2 + 3 + 4) * 16
    assert w.bytes == 2 * (2 * 4 * 2 * 16 + 2 * 4 * 1 * 16)
    lse = roofline.flash_attention_work(1, 4, 4, 2, 1, 16, with_lse=True)
    assert lse.bytes - w.bytes == 4 * 2 * 4 and lse.flops == w.flops
    assert roofline.attention_pairs(4, 6, window=2) == 4 * 2
    assert roofline.attention_pairs(3, 5, causal=False) == 15
    stats = roofline.mlstm_work(1, 8, 2, 16, with_stats=True)
    assert stats.bytes - roofline.mlstm_work(1, 8, 2, 16).bytes == 4 * 2 * 16
    assert roofline.rglru_scan_work(2, 3, 4, h0=True).bytes == \
        roofline.rglru_scan_work(2, 3, 4).bytes + 4 * 2 * 4
    assert roofline.kernel_work("mlstm_bwd", dict(b=1, s=8, h=2, d=16)) == \
        roofline.mlstm_bwd_work(1, 8, 2, 16)
    assert roofline.bound_ms(roofline.Work(0, roofline.HBM_BW, "float32")) \
        == (1e3, "bytes")
    # the peaks are an H100's, none of the reference's TPU constants
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert not {ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW,
                ref_roofline.ICI_BW} & {
        roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_FP32, roofline.HBM_BW,
        roofline.NVLINK_BW}
    assert np.isclose(roofline.NVLINK_BW, 450e9)
