"""Roofline terms per (arch x shape x mesh) from the dry-run artifacts,
and the work of each LM kernel (port of ``analysis/roofline.py``).

Hardware constants: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s HBM3, and NVLink at 450 GB/s each way
per card.  Terms (seconds per global step, per chip: the port drives one
card, whose step is the whole program):

  compute    = step FLOPs per chip / 989e12
  memory     = step bytes per chip / 3.35e12
  collective = collective bytes per chip / 450e9

The dominant term is the bottleneck; MODEL_FLOPS / step FLOPs measures how
much of the computed work is useful (remat, padded heads, MoE capacity
slack, attention's quadratic part all land here).  A card set below 700 W
runs below these peaks: a share read against them names the card's limit.

The work counts (:class:`Work`, ``*_work``) are the LM kernels' own: the
flops a call's function needs and the bytes it must move, each input read
once and each output written once, by shape, dtype, causal flag and
window.  ``chip_smoke.py``'s bound column and the dry run's kernel entries
(``launch/dryrun.py``) both read them, so a share reads the same work
whatever implements the kernel.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

from repro_torch.analysis import hlo_parse
from repro_torch.analysis.flops import model_flops
from repro_torch.configs import SHAPES, ShapeConfig, get_config

PEAK_FLOPS = 989e12       # bf16 tensor cores, dense, per H100 SXM at 700 W
PEAK_FLOPS_FP32 = 67e12   # float32 outside the tensor cores
HBM_BW = 3.35e12          # bytes/s of HBM3
NVLINK_BW = 450e9         # bytes/s each way per card (900 GB/s both ways)

#: peak FLOP/s of the units a kernel's flops run on, by operand dtype
PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS,
                 "float32": PEAK_FLOPS_FP32}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do: ``flops`` on operands of ``dtype``
    and ``bytes`` moved (each input read once, each output written
    once)."""
    flops: float
    bytes: float
    dtype: str


def bound_ms(work: Work) -> tuple:
    """The least time the card could take for ``work``: bytes at the HBM
    rate against flops at the peak of ``work.dtype``; the larger, and
    which one it is (``"bytes"`` or ``"operations"``)."""
    b_ms = work.bytes / HBM_BW * 1e3
    f_ms = work.flops / PEAK_BY_DTYPE[work.dtype] * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def attention_pairs(sq: int, sk: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """Valid (query, key) pairs of one head: causal, the keys up to the
    query's position (the queries are the last Sq of Sk positions), a
    window leaving the last ``window`` of them; not causal, every key."""
    if not causal:
        return sq * sk
    return sum(min(sk, i + sk - sq + 1, window or sk) for i in range(sq))


def flash_attention_work(b, sq, sk, h, kh, d, dtype="bfloat16", window=None,
                         causal=True, with_lse=False) -> Work:
    """B3: q, k, v read and the output (and the f32 lse when asked) written
    once; 4 flops per (query, valid key, head, head-dim): the S and P.V
    products."""
    nbytes = ITEMSIZE[dtype] * (2 * b * sq * h * d + 2 * b * sk * kh * d)
    if with_lse:
        nbytes += 4 * b * h * sq
    flops = 4 * b * h * attention_pairs(sq, sk, causal, window) * d
    return Work(flops, nbytes, dtype)


def flash_attention_bwd_work(b, sq, sk, h, kh, d, dtype="bfloat16",
                             window=None, causal=True) -> Work:
    """B3's backward: q, k, v, out and dout read and dq, dk, dv written
    once; 10 flops per (query, valid key, head, head-dim), the five
    products any backward needs (S, dP, dV, dK, dQ)."""
    nbytes = ITEMSIZE[dtype] * (4 * b * sq * h * d + 4 * b * sk * kh * d)
    flops = 10 * b * h * attention_pairs(sq, sk, causal, window) * d
    return Work(flops, nbytes, dtype)


def rglru_scan_work(b, s, w, h0=False) -> Work:
    """B4: a and b read and h written once (and h0 read when given), f32;
    2 flops an element."""
    return Work(2 * b * s * w, 4 * (3 * b * s * w + (b * w if h0 else 0)),
                "float32")


def rglru_scan_bwd_work(b, s, w, h0=False, dh_last=False) -> Work:
    """B4's backward: a, dy and h read and db and da written once (h0,
    dh_last read and dh0 written when given), f32; 3 flops an element."""
    extra = b * w * (2 * int(h0) + int(dh_last))
    return Work(3 * b * s * w, 4 * (5 * b * s * w + extra), "float32")


def mlstm_work(b, s, h, d, dtype="bfloat16", with_stats=False) -> Work:
    """B5: q, k, v, log_i, log_f read and the output (and the two f32 row
    stats when asked) written once; 4 flops per (query, causal key, head,
    head-dim)."""
    nbytes = ITEMSIZE[dtype] * 4 * b * s * h * d + 4 * 2 * b * s * h
    if with_stats:
        nbytes += 4 * 2 * b * s * h
    return Work(4 * b * h * (s * (s + 1) // 2) * d, nbytes, dtype)


def mlstm_bwd_work(b, s, h, d, dtype="bfloat16") -> Work:
    """B5's backward: q, k, v, out, dout read and dq, dk, dv written once
    (and the f32 gates, stats and their gradients); 10 flops per (query,
    causal key, head, head-dim)."""
    nbytes = ITEMSIZE[dtype] * 8 * b * s * h * d + 4 * 6 * b * s * h
    return Work(10 * b * h * (s * (s + 1) // 2) * d, nbytes, dtype)


#: each LM kernel's work count, by the name its wrapper records
KERNEL_WORK = {"flash_attention": flash_attention_work,
               "flash_attention_bwd": flash_attention_bwd_work,
               "rglru_scan": rglru_scan_work,
               "rglru_scan_bwd": rglru_scan_bwd_work,
               "mlstm": mlstm_work, "mlstm_bwd": mlstm_bwd_work}


def kernel_work(kernel: str, shape: dict) -> Work:
    """The work of one call of ``kernel`` with the shape arguments its
    wrapper records."""
    return KERNEL_WORK[kernel](**shape)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    bytes_per_chip: float
    collective_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_ratio: float  # MODEL_FLOPS / (step FLOPs * chips)
    collective_by_op: dict
    cost_analysis_flops: float  # the record's own "flops", for reference

    def as_dict(self):
        return dataclasses.asdict(self)


def _shape_of(shape_name: str, record: dict) -> ShapeConfig:
    """The cell's shape: a named shape, or the one the record holds (a
    cell of the caller's own, ``dryrun.lower``)."""
    if shape_name in SHAPES:
        return SHAPES[shape_name]
    return ShapeConfig(shape_name, seq_len=record["seq_len"],
                       global_batch=record["global_batch"],
                       kind=record["kind"])


def analyze_cell(arch: str, shape_name: str, mesh: str = "1x1",
                 hlo_text: Optional[str] = None,
                 record: Optional[dict] = None,
                 trace: Optional[dict] = None, cfg=None) -> Roofline:
    """The roofline of one dry-run cell.  ``record`` and the op ``trace``
    default to the artifacts ``dryrun.run_cell`` wrote; with ``hlo_text``
    (the reference's optimized HLO) the totals are read from it instead.
    ``chips`` comes from the record; ``cfg`` defaults to ``arch``'s
    published config (pass the config a cut cell ran)."""
    stem = f"{arch}__{shape_name}__{mesh}"
    if record is None:
        record = json.loads((ARTIFACT_DIR / f"{stem}.json").read_text())
    if hlo_text is not None:
        totals = hlo_parse.analyze(hlo_text)
    else:
        if trace is None:
            trace = json.loads(
                (ARTIFACT_DIR / f"{stem}.trace.json").read_text())
        totals = hlo_parse.analyze_trace(trace)
    chips = record["chips"]
    mf = model_flops(cfg or get_config(arch), _shape_of(shape_name, record))

    t_c = totals.flops / PEAK_FLOPS
    t_m = totals.bytes / HBM_BW
    t_x = totals.collective_bytes / NVLINK_BW
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh,
        flops_per_chip=totals.flops,
        bytes_per_chip=totals.bytes,
        collective_per_chip=totals.collective_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dom,
        model_flops_total=mf,
        useful_ratio=mf / max(1.0, totals.flops * chips),
        collective_by_op={k: v for k, v in sorted(
            totals.collective_by_op.items())},
        cost_analysis_flops=record.get("flops", -1.0),
    )


def format_row(r: Roofline) -> str:
    return (f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute*1e3:.1f} | "
            f"{r.t_memory*1e3:.1f} | {r.t_collective*1e3:.1f} | "
            f"{r.dominant} | {r.useful_ratio:.2f} |")
