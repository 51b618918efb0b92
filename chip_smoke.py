"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                # full size: 8192 events, ~8.5 GB
    python3 chip_smoke.py --n-events 512 # a short first check

Phases, each printing one JSON line:

1. device  — torch's device name, nvidia-smi's name and power limit;
2. build   — nvcc builds both CUDA sources, one nvcc each, started together;
3. kernels — each kernel against its plain PyTorch version on the card.
   event_filter at the query path's chunk shape (64, 4096, 63) with S = 64
   and a ragged (37, 1000, 63), K in {1, 4, 17}, calib_iters in {0, 4},
   with and without a sum(pt) cap.  Masks must be equal at calib 0 without
   a cap; otherwise they may differ only on band events (a count-driving
   pt or the sum within rtol 1e-5 of its threshold), which are counted.
   flash_attention at qwen3-14b's decode (B 2, Sq 1, Sk in {1, 9, 24,
   256}, 48 q heads over 8 kv heads of 128, bf16) and prefill (B 1,
   Sq = Sk = 2048, causal, bf16) shapes and small cases (Sq < Sk, a
   window, a softcap, ragged tiles, f32, head dim 16), within
   |kernel - plain| <= atol + rtol |plain|: 2e-2 in bf16, 2e-4 in f32 with
   TF32 off (FA_TOL);
4. serve   — the paper's event workload (64 scalars, 4096 tracks x 63
   vars, 256 events per brick, replication 2) on 4 nodes, resident on the
   card; the serve workload (64 queries, 4 tenants, window 16, streamed)
   through QueryService on the spmd backend with the kernel, checked
   against a second service on the plain path; then spmd_query_step and
   spmd_query_batch_step with and without the kernel over one brick.
   Launch counts are zeroed just before each path (the serve run, each
   lockstep step) and read just after it, so every path has its own.
   One more run of the workload under torch.profiler gives the device
   time by kernel and the card's busy share;
5. lm      — the query store freed, qwen3-14b at full width (40 layers,
   d_model 5120, 48 (40 real) q heads x 128 over 8 kv heads, d_ff 17408,
   vocab 152064 padded, bf16, 30.4 GB of parameters drawn from a seeded
   generator) serves generate() for a batch of 2 prompts of 8 tokens and
   16 new tokens: 24 decode steps, each attention call the kernel, so
   flash_attention must launch 40 x 24 = 960 times (counts zeroed just
   before, read just after).  The same tokens are replayed teacher-forced
   through the kernel (its argmax must give generate()'s tokens) and
   through the plain attention; each step's max |logit difference| over
   the plain logits' spread must stay within LM_REL_TOL, and the top-1
   agreement at or above LM_TOP1_MIN.  One more generate() under
   torch.profiler gives the device time by kernel and the busy share;
6. prefill — one forward() over 1 x 2048 tokens (40 launches), compared
   with the plain attention in the same way;
7. timing  — each kernel at the shape the main path gave it, beside its
   plain version and its bound: device time (CUDA graph replay) and time
   per call (CUDA events around calls from the host); flash_attention at
   the decode shape with Sk = 24 and at the 2048 prefill, with
   scaled_dot_product_attention (enable_gqa) as the library call;
8. the kernels line, nvidia-smi's line, and the result line.

Any failed check raises, so the script exits non-zero and prints no
result line.  It needs one CUDA card and the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
BAND_RTOL = 1e-5
CHUNK_SHAPE = (64, 4096, 63)   # the query path's chunk: chunk_events x T x V
RAGGED_SHAPE = (37, 1000, 63)
BRICK_SHAPE = (256, 4096, 63)  # one brick: what the lockstep steps are given
DEVICE = torch.device("cuda")
N_SCALARS = 64
TIMING_ROTATION = 16           # distinct inputs cycled so L2 stays cold
TIMING_ITERS = 48

# flash attention: (rtol, atol) of |kernel - plain| <= atol + rtol |plain|
FA_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-4, 2e-4)}
LM_ARCH = "qwen3-14b"
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8, 16
PREFILL_LEN = 2048
LM_REL_TOL = 5e-2     # max |logit difference| / spread of the plain logits
LM_TOP1_MIN = 0.8     # share of positions whose argmax agrees


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# kernel inputs, band rule, timing
# --------------------------------------------------------------------- #
def make_operands(gen, n, t, v, k, *, cap: bool):
    """Event operands shaped like the store's (exponential pt, ragged
    n_tracks) plus K thresholds; caps near the typical sum(pt)."""
    dev = DEVICE
    scalars = torch.abs(torch.randn((n, N_SCALARS), generator=gen,
                                    device=dev) * 50.0)
    tracks = torch.randn((n, t, v), generator=gen, device=dev)
    pt = torch.empty((n, t), device=dev).exponential_(generator=gen) * 10.0
    tracks[:, :, 0] = pt
    n_tracks = torch.randint(1, t + 1, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    u = torch.rand((4, k), generator=gen, device=dev)
    thresholds = torch.stack([
        20.0 + 40.0 * u[0],                        # scalar threshold A
        5.0 + 20.0 * u[1],                         # pt threshold B
        torch.floor(1.0 + 4.0 * u[2]),             # min count C
        (10.0 * t / 2) * (0.5 + u[3]) if cap       # sum cap D (~median)
        else torch.full((k,), -1.0, device=dev),
    ]).contiguous()
    var_idx = torch.randint(0, 8, (k,), generator=gen, device=dev,
                            dtype=torch.int32)
    return scalars, tracks, n_tracks, thresholds, var_idx


def band_events(tracks, n_tracks, thresholds, calib_iters):
    """Events whose outcome rides on rounding: a valid calibrated pt or
    the sum(pt) within BAND_RTOL of one of its thresholds."""
    from repro_torch.kernels.event_filter.ref import calibrate_tracks
    pt = calibrate_tracks(tracks, calib_iters)[..., 0]
    t = torch.arange(pt.shape[1], device=pt.device)
    valid = t[None, :] < n_tracks[:, None]
    b = thresholds[1]
    near = (pt[..., None] - b).abs() <= BAND_RTOL * b.abs()
    band = (near & valid[..., None]).any(dim=1).any(dim=1)
    d = thresholds[3]
    ssum = torch.sum(torch.where(valid, pt, 0.0), dim=-1)
    near_sum = ((ssum[:, None] - d).abs() <= BAND_RTOL * d.abs()) & (d > 0)
    return band | near_sum.any(dim=1)


def compare(mask, var, mask_p, var_p, tracks, n_tracks, thresholds, calib,
            cap, name):
    """Hold one kernel output against its plain version; returns (band
    events allowed, max |difference|)."""
    torch.cuda.synchronize()
    if not torch.equal(var, var_p):
        raise AssertionError(f"{name}: var differs from the plain version")
    diff = (mask != mask_p)
    if diff.dim() == 1:
        diff = diff[:, None]
    bad_rows = diff.any(dim=1)
    n_band = 0
    if calib == 0 and not cap:
        if bool(bad_rows.any()):
            raise AssertionError(
                f"{name}: masks differ at calib 0 without a cap "
                f"({int(bad_rows.sum())} events)")
    else:
        thr = thresholds if thresholds.dim() == 2 else thresholds[:, None]
        band = band_events(tracks, n_tracks, thr, calib)
        if bool((bad_rows & ~band).any()):
            raise AssertionError(
                f"{name}: {int((bad_rows & ~band).sum())} events differ "
                f"outside the rtol {BAND_RTOL} band")
        n_band = int(band.sum())
    err = float((mask - mask_p).abs().max())
    return n_band, err


def call_time_ms(calls, iters=TIMING_ITERS) -> float:
    """Mean ms per call as a caller sees it, host work between launches
    included: ``iters`` calls cycling through ``calls`` (closures over
    distinct inputs, so each finds its inputs cold in L2), timed with CUDA
    events."""
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(calls, iters=TIMING_ITERS) -> float:
    """Mean device ms per call: the same ``iters`` calls captured into one
    CUDA graph and replayed, so no host time sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:2]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(scalars, n_tracks, thresholds, var_idx, calib_iters, t):
    """Least time for the function's work on these inputs: the bytes it
    must move (valid tracks' pt, n_tracks, scalars, thresholds, var_idx
    in; mask and var out, each once) at the HBM rate, against its flops
    (per valid track: K compares, one add, ~10 per calibration round) at
    the fp32 rate; the larger of the two, and which one it is."""
    n = scalars.shape[0]
    k = thresholds.numel() // 4
    valid = int(torch.clamp(n_tracks.long(), 0, t).sum())
    nbytes = 4 * (valid + n + scalars.numel() + 4 * k + k + n * k + n)
    flops = valid * (k + 1 + 10 * calib_iters)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def phase_kernels(gen):
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.event_filter.ref import (event_filter_batch_ref,
                                                      event_filter_ref)

    def plain_single(scalars, tracks, n_tracks, thr, var_idx, calib):
        a, b, c, d = thr.tolist()
        return event_filter_ref(scalars, tracks, n_tracks,
                                var_idx=int(var_idx[0]), scalar_thresh=a,
                                pt_thresh=b, min_count=c, sum_cap=d,
                                calib_iters=calib)

    rows = []
    for shape in (CHUNK_SHAPE, RAGGED_SHAPE):
        for k in (1, 4, 17):
            for calib in (0, 4):
                for cap in (False, True):
                    ops = make_operands(gen, *shape, k, cap=cap)
                    scalars, tracks, n_tracks, thr, var_idx = ops
                    mask, var = ef_kernel.event_filter_batch_cuda(
                        *ops, calib_iters=calib)
                    torch.cuda.synchronize()
                    mask_p, var_p = event_filter_batch_ref(
                        scalars, tracks, n_tracks, thr, var_idx=var_idx,
                        calib_iters=calib)
                    nb, err = compare(mask, var, mask_p, var_p, tracks,
                                      n_tracks, thr, calib, cap,
                                      "event_filter_batch")
                    row = {"kernel": "event_filter_batch",
                           "shape": list(shape), "k": k, "calib": calib,
                           "cap": cap, "band_events": nb,
                           "max_abs_err": err}
                    if k == 1:
                        t1 = thr[:, 0].contiguous()
                        m1, v1 = ef_kernel.event_filter_cuda(
                            scalars, tracks, n_tracks, t1, var_idx,
                            calib_iters=calib)
                        torch.cuda.synchronize()
                        m1p, v1p = plain_single(scalars, tracks, n_tracks,
                                                t1, var_idx, calib)
                        nb1, err1 = compare(m1, v1, m1p, v1p, tracks,
                                            n_tracks, t1, calib, cap,
                                            "event_filter")
                        rows.append({**row, "kernel": "event_filter",
                                     "band_events": nb1,
                                     "max_abs_err": err1})
                    rows.append(row)
    return rows


def time_kernel(name, gen, shape, k, calib_iters):
    """Times of one kernel and its plain version at one main-path shape,
    over TIMING_ROTATION distinct operand sets: device ms from graph
    replay (``ms``, ``plain_ms``) and ms per call with host work
    (``call_ms``, ``plain_call_ms``), each the mean of two runs taken
    plain, kernel, kernel, plain; with the bound and the largest
    difference from the plain version."""
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.event_filter.ref import (event_filter_batch_ref,
                                                      event_filter_ref)
    sets = [make_operands(gen, *shape, k, cap=False)
            for _ in range(TIMING_ROTATION)]
    kern, plain = [], []
    for s, tr, nt, th, vi in sets:
        if name == "event_filter":
            t1 = th[:, 0].contiguous()
            a, b, c, d = t1.tolist()
            kern.append(functools.partial(
                ef_kernel.event_filter_cuda, s, tr, nt, t1, vi,
                calib_iters=calib_iters))
            plain.append(functools.partial(
                event_filter_ref, s, tr, nt, var_idx=int(vi[0]),
                scalar_thresh=a, pt_thresh=b, min_count=c, sum_cap=d,
                calib_iters=calib_iters))
        else:
            kern.append(functools.partial(
                ef_kernel.event_filter_batch_cuda, s, tr, nt, th, vi,
                calib_iters=calib_iters))
            plain.append(functools.partial(
                event_filter_batch_ref, s, tr, nt, th, var_idx=vi,
                calib_iters=calib_iters))
    err = 0.0
    for kc, pc in zip(kern[:4], plain[:4]):
        (m, v), (mp, vp) = kc(), pc()
        torch.cuda.synchronize()
        err = max(err, float((m - mp).abs().max()),
                  float((v - vp).abs().max()))
    out = {}
    for key, timer in (("ms", device_time_ms), ("call_ms", call_time_ms)):
        p1, k1, k2, p2 = (timer(plain), timer(kern), timer(kern),
                          timer(plain))
        out[key] = (k1 + k2) / 2
        out["plain_" + key] = (p1 + p2) / 2
    bms = [bound_ms(s, nt, th, vi, calib_iters, shape[1])
           for s, tr, nt, th, vi in sets]
    return {**out, "bound_ms": float(np.mean([x for x, _ in bms])),
            "bound_by": bms[0][1], "max_abs_err": err}


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
# (case, B, Sq, Sk, H, K, D, dtype, flags): qwen3-14b's decode steps and
# prefill at full width, then the small cases
FA_CASES = [
    *[("decode", 2, 1, sk, 48, 8, 128, torch.bfloat16, {})
      for sk in (1, 9, 24, 256)],
    ("prefill", 1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128, torch.bfloat16, {}),
    ("sq<sk", 2, 37, 100, 4, 2, 16, torch.bfloat16, {}),
    ("sq<sk", 2, 37, 100, 4, 2, 16, torch.float32, {}),
    ("window", 1, 96, 96, 8, 2, 64, torch.bfloat16, {"window": 40}),
    ("window", 1, 96, 96, 8, 2, 64, torch.float32, {"window": 40}),
    ("softcap", 2, 64, 64, 4, 4, 32, torch.float32, {"logit_cap": 30.0}),
    ("ragged", 1, 300, 300, 48, 8, 128, torch.float32, {}),
    ("reduced", 2, 24, 24, 16, 2, 16, torch.float32, {}),
    ("not causal", 1, 50, 50, 4, 1, 16, torch.float32,
     {"causal": False, "window": 9}),
]


def fa_operands(gen, b, sq, sk, h, kh, d, dtype):
    return tuple(torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                 for shape in ((b, sq, h, d), (b, sk, kh, d),
                               (b, sk, kh, d)))


def fa_check(out, want, dtype, name) -> float:
    """Max |kernel - plain|; raises when an element lies outside
    atol + rtol |plain| (FA_TOL) or is not finite."""
    rtol, atol = FA_TOL[dtype]
    o, w = out.float(), want.float()
    if o.shape != w.shape or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"flash_attention {name}: shape {o.shape} or "
                             "non-finite output")
    err = (o - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"flash_attention {name} ({dtype}): {int(bad.sum())} elements "
            f"outside rtol {rtol} atol {atol}, max err {float(err.max())}")
    return float(err.max())


def phase_flash_kernels(gen):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rows = []
    for name, b, sq, sk, h, kh, d, dtype, kw in FA_CASES:
        q, k, v = fa_operands(gen, b, sq, sk, h, kh, d, dtype)
        out = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        again = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"flash_attention {name}: two runs differ")
        err = fa_check(out, flash_attention_ref(q, k, v, **kw), dtype, name)
        rows.append({"case": name, "shape": [b, sq, sk, h, kh, d],
                     "dtype": str(dtype).split(".")[-1], "flags": kw,
                     "max_abs_err": err})
    return rows


def fa_bound_ms(b, sq, sk, h, kh, d, itemsize):
    """Least time for causal attention on these shapes: q, k, v read and
    the output written once at the HBM rate, against 4 flops per (query,
    valid key, head, head-dim) pair at the bf16 tensor-core rate; the
    larger of the two, and which one it is."""
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * sk * kh * d)
    pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = 4 * b * h * pairs * d / BF16_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def time_flash(gen, b, sq, sk, h, kh, d):
    """flash_attention at one main-path shape (bf16, causal) over
    TIMING_ROTATION operand sets: kernel and plain version as in
    ``time_kernel``, and the library call,
    ``scaled_dot_product_attention(enable_gqa=True)`` (causal at prefill;
    at decode every key is valid and SDPA would align a causal mask
    top-left), timed only."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sets = [fa_operands(gen, b, sq, sk, h, kh, d, torch.bfloat16)
            for _ in range(TIMING_ROTATION)]
    kern = [functools.partial(fa_kernel.flash_attention_cuda, *qkv)
            for qkv in sets]
    plain = [functools.partial(flash_attention_ref, *qkv) for qkv in sets]
    lib = [functools.partial(sdpa, *(x.transpose(1, 2) for x in qkv),
                             is_causal=sq > 1, enable_gqa=True)
           for qkv in sets]
    err = lib_err = 0.0
    for kc, pc, lc in zip(kern[:4], plain[:4], lib[:4]):
        out, want, lo = kc(), pc(), lc().transpose(1, 2)
        err = max(err, fa_check(out, want, torch.bfloat16, "timing"))
        lib_err = max(lib_err, float((lo.float() - want.float()).abs()
                                     .max()))
    out = {}
    for key, timer in (("ms", device_time_ms), ("call_ms", call_time_ms)):
        p1, k1, k2, p2 = (timer(plain), timer(kern), timer(kern),
                          timer(plain))
        out[key] = (k1 + k2) / 2
        out["plain_" + key] = (p1 + p2) / 2
    bound, by = fa_bound_ms(b, sq, sk, h, kh, d, 2)
    return {**out, "library_ms": device_time_ms(lib),
            "library_max_abs_err": lib_err, "bound_ms": bound,
            "bound_by": by, "max_abs_err": err}


# --------------------------------------------------------------------- #
# serve
# --------------------------------------------------------------------- #
def serve_workload(svc, n_queries=64, tenants=4, window=16):
    """The serve launcher's multi-tenant workload (streamed)."""
    hot = ["e_total > 40 && count(pt > 15) >= 2",
           "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]
    tids = []
    for i in range(n_queries):
        if i % 3 != 2:
            expr = hot[i % len(hot)]
        else:
            expr = (f"e_total > {20 + (i % 7) * 10} && "
                    f"count(pt > 15) >= {1 + i % 4}")
        tids.append(svc.submit(expr, tenant=f"tenant{i % tenants}",
                               stream=True))
        if (i + 1) % window == 0:
            svc.step()
    svc.drain()
    return tids


def profile_run(phase, run):
    """Device time by kernel over one ``run()``, from torch.profiler; the
    profiler's own cost is in ``wall_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side activities only (kernels, copies): a host op's device
    # time is its children's, so counting both would count it twice
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    emit({"phase": phase, "wall_s": wall, "device_busy_s": busy_s,
          "device_busy_share": busy_s / wall,
          "device_launches": sum(n for _, _, n in rows),
          "top": [{"name": key[:80], "device_ms": us / 1e3, "count": n}
                  for us, key, n in rows[:12]]})


def profile_serve(make_service):
    """One more run of the serve workload on a fresh service (the same
    scans) under the profiler."""
    svc = make_service()
    profile_run("profile", lambda: serve_workload(svc))
    svc.close()


def phase_serve(n_events):
    from repro_torch.configs.geps_events import EventWorkloadConfig
    from repro_torch.core import events as ev
    from repro_torch.core import merge as merge_lib
    from repro_torch.core.backend import SpmdBackend
    from repro_torch.core.brick import create_store
    from repro_torch.core.catalog import MetadataCatalog
    from repro_torch.core.jse import spmd_query_batch_step, spmd_query_step
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.service import QueryScheduler, QueryService

    class RecordingBackend(SpmdBackend):
        """The spmd backend, keeping each window's JobStats and the
        kernel sub-batch width K it ran with."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.window_stats, self.kernel_widths = [], []

        def _split_plan(self, plan):
            split = super()._split_plan(plan)
            self.kernel_widths.append(len(split.kernel_cols))
            return split

        def run_batch(self, *a, **kw):
            merged, stats = super().run_batch(*a, **kw)
            self.window_stats.append(stats)
            return merged, stats

    cfg = EventWorkloadConfig()
    schema = ev.EventSchema.from_config(cfg)
    t0 = time.perf_counter()
    store = create_store(schema, n_events=n_events, n_nodes=4,
                         events_per_brick=cfg.events_per_brick,
                         replication=cfg.replication_factor, seed=0,
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    emit({"phase": "store", "n_events": store.n_events,
          "bricks": len(store.bricks), "resident_gb": resident / 1e9,
          "build_s": build_s})

    def counted(run):
        """Run one path with the launch counts zeroed just before it and
        read just after it: (its output, its launches)."""
        for key in ef_kernel.LAUNCHES:
            ef_kernel.LAUNCHES[key] = 0
        out = run()
        torch.cuda.synchronize()
        return out, dict(ef_kernel.LAUNCHES)

    # ---- the serve path ----
    backend = RecordingBackend(MetadataCatalog(store.n_nodes), store,
                               use_pallas=True, device="cuda")
    svc = QueryService(store, backend=backend,
                       scheduler=QueryScheduler(max_batch=16),
                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tids, launches = counted(lambda: serve_workload(svc))
    wall = time.perf_counter() - t0

    scanned = sum(s.events_scanned for s in backend.window_stats)
    kernel_events = sum(s.kernel_events for s in backend.window_stats)
    kernel_chunks = sum(s.packets for s, k in zip(backend.window_stats,
                                                  backend.kernel_widths)
                        if k)
    if launches["event_filter_batch"] <= 0 \
            or launches["event_filter_batch"] != kernel_chunks:
        raise AssertionError(
            f"the serve run launched event_filter_batch "
            f"{launches['event_filter_batch']} times for {kernel_chunks} "
            f"chunks of windows with kernel targets")
    if launches["event_filter"] != 0:
        raise AssertionError("the serve run launched the single-query "
                             "event_filter")
    if kernel_events != scanned or scanned == 0:
        raise AssertionError(f"kernel_events {kernel_events} != "
                             f"events_scanned {scanned}")

    # ---- the lockstep entry points, each over one brick ----
    brick0 = store.bricks[0]
    lock_expr = "e_total > 40 && count(pt > 15) >= 2"
    lock_exprs = [lock_expr, "e_t_miss > 30 && count(pt > 20) >= 1",
                  "pt_lead > 60 && count(pt > 10) >= 3"]
    step_k, step_launches = counted(lambda: spmd_query_step(
        lock_expr, schema, use_pallas=True, device="cuda")(brick0))
    bstep_k, bstep_launches = counted(lambda: spmd_query_batch_step(
        lock_exprs, schema, use_pallas=True, device="cuda")(brick0))
    for name, got, want in (
            ("spmd_query_step", step_launches,
             {"event_filter": 1, "event_filter_batch": 0}),
            ("spmd_query_batch_step", bstep_launches,
             {"event_filter": 0, "event_filter_batch": 1})):
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")

    def service(use_pallas):
        return QueryService(store, backend="spmd",
                            backend_kwargs={"use_pallas": use_pallas},
                            scheduler=QueryScheduler(max_batch=16),
                            device="cuda")

    plain = service(False)
    tids_p = serve_workload(plain)
    for a, b in zip(tids, tids_p):
        ra, rb = svc.result(a), plain.result(b)
        if ra.status != "SERVED" or rb.status != "SERVED":
            raise AssertionError(f"ticket {a}: {ra.status}/{rb.status}")
        if not merge_lib.results_identical(ra.result, rb.result):
            raise AssertionError(f"ticket {a} ({ra.expr}): kernel final "
                                 "differs from the plain path")
        if ra.result.n_processed != store.n_events:
            raise AssertionError(f"ticket {a} processed "
                                 f"{ra.result.n_processed} events")
        if not merge_lib.results_identical(svc.stream(a).latest().result,
                                           ra.result):
            raise AssertionError(f"ticket {a}: stream final != result")

    step_p = spmd_query_step(lock_expr, schema, use_pallas=False,
                             device="cuda")(brick0)
    bstep_p = spmd_query_batch_step(lock_exprs, schema, use_pallas=False,
                                    device="cuda")(brick0)
    for name, got, want in (("spmd_query_step", step_k, step_p),
                            ("spmd_query_batch_step", bstep_k, bstep_p)):
        for key in want:
            g, w = got[key], want[key]
            if g.shape != w.shape or not torch.isfinite(g).all() \
                    or not torch.equal(g, w):
                raise AssertionError(f"{name}[{key}]: kernel {g.tolist()} "
                                     f"!= plain {w.tolist()}")
    svc.close()
    plain.close()
    profile_serve(lambda: service(True))
    t, v = schema.max_tracks, schema.track_vars
    emit({"phase": "serve", "tickets": len(tids),
          "windows": len(backend.window_stats),
          "kernel_widths": backend.kernel_widths,
          "events_scanned": scanned, "kernel_events": kernel_events,
          "kernel_chunks": kernel_chunks, "launches": launches,
          "wall_s": wall, "events_per_s": scanned / wall,
          "track_gb_per_s": scanned * t * v * 4 / wall / 1e9,
          "results_identical_to_plain": True})
    emit({"phase": "lockstep", "events": int(brick0["scalars"].shape[0]),
          "spmd_query_step_launches": step_launches,
          "spmd_query_batch_step_launches": bstep_launches,
          "identical_to_plain": True})
    # each kernel's count from its own path: the batched kernel from the
    # serve run, the single-query kernel from spmd_query_step
    return ({"event_filter_batch": launches["event_filter_batch"],
             "event_filter": step_launches["event_filter"]},
            backend.kernel_widths)


# --------------------------------------------------------------------- #
# LM serve and prefill
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_attention():
    """Inside the block the dense model's attention calls take the plain
    version on CUDA tensors: the comparison runs only, never the served
    path, whose calls launch the kernel."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import transformer
    saved = transformer.flash_attention
    transformer.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        transformer.flash_attention = saved


def compare_logits(kern, plain, vocab):
    """Per leading index (a decode step, a prefill position): max |logit
    difference| over the plain logits' spread (max - min over the real
    vocab), and the share of rows whose argmax agrees."""
    k = kern[..., :vocab].float().flatten(1, -2)   # (N, rows, V)
    p = plain[..., :vocab].float().flatten(1, -2)
    if not bool(torch.isfinite(k).all()) or not bool(torch.isfinite(p).all()):
        raise AssertionError("non-finite logits")
    diff = (k - p).abs().amax(dim=(1, 2))
    spread = p.amax(dim=(1, 2)) - p.amin(dim=(1, 2))
    rel = (diff / spread).tolist()
    top1 = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    return rel, top1


def check_logits(name, rel, top1):
    if max(rel) > LM_REL_TOL or top1 < LM_TOP1_MIN:
        raise AssertionError(
            f"{name}: kernel vs plain attention max rel logit difference "
            f"{max(rel)} (limit {LM_REL_TOL}), top-1 agreement {top1} "
            f"(at least {LM_TOP1_MIN})")


def build_lm():
    """qwen3-14b at full width on the card, weights from a seeded
    generator: (cfg, model facade, parameter tree)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_zoo
    from repro_torch.models.transformer import TransformerLM
    cfg = get_config(LM_ARCH)
    model = model_zoo.build_model(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm = TransformerLM(cfg, model.table.init(gen, DEVICE))
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model,
          "q_heads": [cfg.num_heads, cfg.num_heads_padded],
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab_padded": cfg.vocab_padded,
          "dtype": cfg.param_dtype, "params": model.table.num_params(),
          "param_gb": model.table.bytes() / 1e9,
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "init_s": time.perf_counter() - t0})
    return cfg, model, lm.tree()


def replay(cfg, model, params, seq):
    """Teacher-forced decode of ``seq`` (B, S) from an empty cache: the
    logits of every step, (S, B, Vp) f32."""
    cache = model.init_cache(seq.shape[0], 256, DEVICE)
    steps = []
    for s in range(seq.shape[1]):
        logits, cache = model.decode_step(params, cache, seq[:, s:s + 1])
        steps.append(logits[:, -1].float())
    return torch.stack(steps)


@torch.inference_mode()
def phase_lm(cfg, model, params):
    """generate() through the kernel, its launch count, tok/s, and the
    teacher-forced comparison with the plain attention."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import generate
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=DEVICE)
    generate(cfg, model, params, prompt, max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()
    fa_kernel.LAUNCHES["flash_attention"] = 0
    t0 = time.perf_counter()
    tokens = generate(cfg, model, params, prompt, max_new_tokens=LM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_kernel.LAUNCHES["flash_attention"]
    want = cfg.num_layers * (LM_PROMPT + LM_NEW)
    if launches != want:
        raise AssertionError(f"generate launched flash_attention {launches} "
                             f"times, expected {want}")
    if tuple(tokens.shape) != (LM_BATCH, LM_NEW) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(tokens.shape)} or "
                             "ids outside the vocab")

    seq = torch.cat([prompt, tokens], dim=1)   # what the 24 steps were fed
    kern = replay(cfg, model, params, seq)
    with plain_attention():
        plain = replay(cfg, model, params, seq)
    pred = kern[..., :cfg.vocab_size].argmax(-1)       # (steps, B)
    if not torch.equal(pred[LM_PROMPT - 1:LM_PROMPT - 1 + LM_NEW].T, tokens):
        raise AssertionError("the kernel's teacher-forced replay does not "
                             "give generate()'s tokens")
    rel, top1 = compare_logits(kern, plain, cfg.vocab_size)
    check_logits("lm serve", rel, top1)
    profile_run("lm_profile", lambda: generate(
        cfg, model, params, prompt, max_new_tokens=LM_NEW))
    emit({"phase": "lm", "batch": LM_BATCH, "prompt": LM_PROMPT,
          "new_tokens": LM_NEW, "decode_steps": LM_PROMPT + LM_NEW,
          "flash_attention_launches": launches, "wall_s": wall,
          "tok_per_s": LM_BATCH * LM_NEW / wall,
          "ms_per_decode_step": wall / (LM_PROMPT + LM_NEW) * 1e3,
          "rel_logit_diff_per_step": rel, "top1_agreement": top1,
          "sample": tokens[0].tolist()})
    return launches


@torch.inference_mode()
def phase_prefill(cfg, model, params):
    """One forward() over 1 x PREFILL_LEN tokens through the kernel
    (one launch per layer), compared with the plain attention."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=gen,
                         device=DEVICE)
    torch.cuda.synchronize()
    fa_kernel.LAUNCHES["flash_attention"] = 0
    t0 = time.perf_counter()
    logits, _ = model.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_kernel.LAUNCHES["flash_attention"]
    if launches != cfg.num_layers:
        raise AssertionError(f"forward launched flash_attention {launches} "
                             f"times, expected {cfg.num_layers}")
    with plain_attention():
        plain, _ = model.forward(params, {"tokens": toks})
    # each position is one row of the comparison
    rel, top1 = compare_logits(logits[0][:, None], plain[0][:, None],
                               cfg.vocab_size)
    check_logits("prefill", rel, top1)
    emit({"phase": "prefill", "tokens": PREFILL_LEN,
          "flash_attention_launches": launches, "wall_s": wall,
          "tok_per_s": PREFILL_LEN / wall, "max_rel_logit_diff": max(rel),
          "top1_agreement": top1})
    return launches


# --------------------------------------------------------------------- #
def build_all():
    """One nvcc per source, all started together."""
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        futures = [pool.submit(m.build) for m in (ef_kernel, fa_kernel)]
        for f in futures:
            f.result()
    emit({"phase": "build",
          "sources": [ef_kernel.SOURCE.name, fa_kernel.SOURCE.name],
          "build_s": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-events", type=int, default=8192,
                    help="events in the served store (default: 8192)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_device": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    build_all()

    # 3. kernels against their plain versions (f32 plain path without
    # TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    rows = phase_kernels(gen)
    emit({"phase": "kernels", "cases": len(rows),
          "band_events": sum(r["band_events"] for r in rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows),
          "rows": rows})
    fa_rows = phase_flash_kernels(gen)
    emit({"phase": "flash_kernels", "cases": len(fa_rows),
          "tolerance": {str(k).split(".")[-1]: v for k, v in FA_TOL.items()},
          "rows": fa_rows})

    # 4. serve and lockstep (the query paths; launch counts read around
    # each)
    launches, widths = phase_serve(args.n_events)
    gc.collect()
    torch.cuda.empty_cache()

    # 5, 6. LM serve and prefill (launch counts read around each)
    lm = build_lm()
    launches["flash_attention"] = phase_lm(*lm)
    prefill_launches = phase_prefill(*lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    # 7. timing at the shapes the main path gave each kernel
    main_k = max(set(w for w in widths if w), key=widths.count)
    gen.manual_seed(1)
    timed = {
        "event_filter_batch": time_kernel("event_filter_batch", gen,
                                          CHUNK_SHAPE, main_k, 0),
        "event_filter": time_kernel("event_filter", gen,
                                    BRICK_SHAPE, 1, 0),
        "flash_attention": time_flash(gen, LM_BATCH, 1,
                                      LM_PROMPT + LM_NEW, 48, 8, 128),
    }
    prefill = time_flash(gen, 1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128)
    emit({"phase": "timing", "smi": smi,
          "event_filter_batch": {"shape": list(CHUNK_SHAPE), "k": main_k,
                                 **timed["event_filter_batch"]},
          "event_filter": {"shape": list(BRICK_SHAPE), "k": 1,
                           **timed["event_filter"]},
          "flash_attention_decode": {
              "shape": [LM_BATCH, 1, LM_PROMPT + LM_NEW, 48, 8, 128],
              "launches_serve": launches["flash_attention"],
              **timed["flash_attention"]},
          "flash_attention_prefill": {
              "shape": [1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128],
              "launches_prefill": prefill_launches, **prefill}})

    # 8. kernels line, nvidia-smi line, result line
    ef_src = "src/repro_torch/kernels/event_filter/csrc/event_filter.cu"
    sources = {
        "event_filter_batch": (ef_src, "src/repro/kernels/event_filter/"
                                       "kernel.py:178"),
        "event_filter": (ef_src, "src/repro/kernels/event_filter/"
                                 "kernel.py:225"),
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/"
                            "kernel.py:81"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": timed[name]["max_abs_err"],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"],
         "bound_ms": timed[name]["bound_ms"],
         "bound_by": timed[name]["bound_by"],
         "library_ms": timed[name].get("library_ms")}
        for name, (src, replaces) in sources.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
