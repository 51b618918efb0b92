"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                # full size: 8192 events, ~8.5 GB
    python3 chip_smoke.py --n-events 512 # a short first check

Phases, each printing one JSON line:

1. device  — torch's device name, nvidia-smi's name and power limit;
2. build   — nvcc builds the four CUDA sources, one nvcc each, started
   together; ptxas's registers and spills for every kernel instance (an
   instance of flash_attention, mlstm or rglru_scan that spills fails the
   run);
3. kernels — each kernel against its plain PyTorch version on the card.
   event_filter at the query path's chunk shape (64, 4096, 63) with S = 64
   and a ragged (37, 1000, 63), K in {1, 4, 17}, calib_iters in {0, 4},
   with and without a sum(pt) cap.  Masks must be equal at calib 0 without
   a cap; otherwise they may differ only on band events (a count-driving
   pt or the sum within rtol 1e-5 of its threshold), which are counted.
   flash_attention at qwen3-14b's decode (B 2, Sq 1, Sk in {1, 9, 24,
   256}, 48 q heads over 8 kv heads of 128, bf16) and prefill (B 1,
   Sq = Sk = 2048, causal, bf16) shapes, at recurrentgemma-9b's decode
   (Sk in {1, 24, 256}, 16 q heads over 1 kv head of 256) and prefill (B
   1, Sq = Sk = 4096, window 2048) shapes, the tensor-core kernels off
   those shapes (Sq 300, 64 <= Sq < Sk, head dim 64, window with softcap,
   non-causal, decode over 2048- and 4096-slot rings, which takes the
   split-K path and its merge), and small cases (Sq < Sk, a window, a
   softcap, ragged tiles, f32, head dim 16), within |kernel - plain| <=
   atol + rtol |plain|: 2e-2 in bf16, 2e-4 in f32 with TF32 off (FA_TOL);
   bf16 cases also against the plain version in f32 on the same values.
   Each row names the device kernel the wrapper's plan chose.  rglru_scan at recurrentgemma-9b's (1, 4096, 4096)
   with and without h0, a ragged (3, 100, 48), S under one chunk (2, 8,
   4096), W no multiple of 4 (2, 77, 50, the cp.async load path) and 141
   chunks (1, 9000, 128),
   within 1e-5 (SCAN_TOL) of the plain version and equal bit for bit to
   the chunked kernel's order of operations in plain PyTorch
   (rglru_scan_chunked_ref at the plan's chunk), each row with its plan
   (chunk, tile, blocks, load path);
   mlstm at xlstm-350m's (1, 2048, 4, 512) in bf16 (the tensor-core
   kernel) and f32, small f32 cases whose S is no multiple of the tile,
   and the tensor-core kernel off the model's shape (S 300 and 37, two
   batch rows, q, k, v as views of one fused tensor, gates under which
   exp(-m) wins the normaliser), against the plain version evaluated in
   f32 on the same values (the kernel's arithmetic): 2e-2 for a bf16
   output, 5e-4 in f32 (MLSTM_TOL); the distance from the plain version in
   bf16 is reported, and each row names the device kernel the wrapper's
   plan chose.  Two launches of every case must give the same bits;
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
5. lm      — the query store freed, three LMs at full width, one on the
   card at a time, each held by ``LanguageModel`` with parameters drawn
   from a seeded generator: qwen3-14b (40 layers, d_model 5120, 48 (40
   real) q heads x 128 over 8 kv heads, d_ff 17408, 30.4 GB bf16),
   recurrentgemma-9b (38 layers = 12 x (rec, rec, attn) + (rec, rec),
   d_model 4096, lru_width 4096, 16 q heads x 256 over 1 kv head, window
   2048, 17.2 GB) and xlstm-350m (24 layers = 3 x (7 mLSTM + 1 sLSTM),
   d_model 1024, 4 heads, 0.66 GB).  Each serves generate() for a batch
   of 2 prompts of 8 tokens and 16 new tokens: 24 decode steps, each
   attention call the flash kernel, so flash_attention must launch 40 x
   24 = 960 times for qwen3-14b, 12 x 24 = 288 for recurrentgemma-9b and
   0 for xlstm-350m, whose decode runs no kernel (counts of every LM
   kernel zeroed just before, read just after), every flash call on the
   GQA-packed decode kernel (``flash_attention.decode``).  The same tokens are
   replayed teacher-forced through the kernels (their argmax must give
   generate()'s tokens) and through the plain versions
   (``plain_kernels()``, in the working dtype and in f32); for qwen3-14b
   each step's max |logit difference| over the plain logits' spread must
   stay within LM_REL_TOL, and the top-1 agreement at or above
   LM_TOP1_MIN.  One more generate() under torch.profiler gives the
   device time by kernel and the busy share;
6. prefill — one forward() for each LM: qwen3-14b over 1 x 2048 tokens
   (40 flash launches), recurrentgemma-9b over 1 x 4096 (26 rglru_scan
   and 12 flash launches; the window bites), every flash call on the
   tensor-core prefill kernel (``flash_attention.wgmma``), xlstm-350m
   over 1 x 2048 (21 mlstm launches, all on the tensor-core kernel,
   ``mlstm.wgmma``), each compared with the same forward on the plain
   versions in the same way; then xlstm-350m's forward logits over 1024
   tokens against a teacher-forced decode of the same tokens (the
   recurrent form), which ties the mLSTM kernel to the recurrence.  Every
   kernel call of these paths is also held against its plain version in
   f32 on the same inputs (``shadow_kernels()``); a flash_attention call
   on which that plain version is itself outside FA_TOL of the exact
   (f64) value (recurrentgemma-9b's forward, C-ref5) is held instead,
   element by element, within FA_TOL of the exact value plus the
   element's sensitivity to f32 score rounding (SENS_KAPPA), with its
   largest and mean error no more than ERR_RATIO times the plain
   version's, and its counts against both yardsticks are reported.  End
   to end, the recurrent models' logits are reported beside the distance
   between two plain runs that differ only in rounding, not gated
   (E2E_GATED);
7. timing  — each kernel at the shape the main path gave it, beside its
   plain version and its bound: device time (CUDA graph replay) and time
   per call (CUDA events around calls from the host); flash_attention at
   the decode shape with Sk = 24 and at the 2048 prefill (qwen3-14b), at
   recurrentgemma-9b's decode and its 4096 prefill under the window, with
   scaled_dot_product_attention (enable_gqa; an explicit mask under the
   window) as the library call; rglru_scan and mlstm with no library call
   (no PyTorch call computes either function); every row with its share of
   the bound, the event filter's also with the sector bound of the store's
   strided pt, beside the launch floor (a one-element fill);
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
# RG-LRU scan: |kernel - plain| <= atol + rtol |plain| (f32; the kernel
# runs the recurrence in order, the plain version as a doubling scan)
SCAN_TOL = (1e-5, 1e-5)
# mLSTM: against the plain version evaluated in f32 on the same values (the
# kernel's and the Pallas kernel's arithmetic), as FA_TOL for a bf16
# output and as tests/test_kernels.py (5e-4) in f32
MLSTM_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (5e-4, 5e-4)}
LM_ARCH = "qwen3-14b"
RG_ARCH = "recurrentgemma-9b"
XL_ARCH = "xlstm-350m"
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8, 16
PREFILL_LEN = 2048
# forward lengths: recurrentgemma's 4096 passes its 2048 attention window
FORWARD_LEN = {LM_ARCH: PREFILL_LEN, RG_ARCH: 4096, XL_ARCH: 2048}
# xlstm-350m's forward against its own decode: the decode runs token by
# token (~50 ms a step, host-bound), so 1024 tokens keep it near a minute
TIE_LEN = 1024
# models whose logits through the kernels are held end to end against the
# plain versions (LM_REL_TOL, LM_TOP1_MIN).  Not the recurrent models: with
# the reference's initialisation their full-width paths are chaotic, so
# two plain runs that differ only in rounding (bf16 against f32 plain
# versions) already disagree far beyond those limits.  recurrentgemma-9b
# is MQA and draws its key projection at 1/sqrt(1) (C-ref5): attention
# scores spread over ~1e3, every softmax is an argmax, and a flipped
# near-tie is carried on by the next layers and the recurrence.
# xlstm-350m draws the sLSTM's recurrent weights at 1/sqrt(hd), not 0.01
# (C-ref6), over 2048 steps.  For them every kernel call on the path is
# held against its plain version in f32 on the same inputs
# (shadow_kernels), and the end-to-end numbers are reported beside that
# baseline.
E2E_GATED = (LM_ARCH,)
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


def time_pair(kern, plain):
    """Device ms (graph replay) and ms per call of a kernel and its plain
    version, each the mean of two runs taken plain, kernel, kernel,
    plain."""
    out = {}
    for key, timer in (("ms", device_time_ms), ("call_ms", call_time_ms)):
        p1, k1, k2, p2 = (timer(plain), timer(kern), timer(kern),
                          timer(plain))
        out[key] = (k1 + k2) / 2
        out["plain_" + key] = (p1 + p2) / 2
    return out


def with_share(row):
    """A timing row with the share of its bound that the kernel reaches
    (bound over device time)."""
    return {**row, "share_of_bound": row["bound_ms"] / row["ms"]}


def launch_floor_ms() -> float:
    """Device ms of the least kernel, a one-element fill, timed as the
    kernels are (graph replay): what a launch costs before any work."""
    one = torch.zeros(1, device=DEVICE)
    return device_time_ms([one.zero_])


def sector_bound_ms(n_tracks, t) -> float:
    """Least time to read the valid tracks' pt from the store's (N, T, V)
    layout, where each 4-byte pt costs a 32-byte sector, at the HBM rate."""
    valid = int(torch.clamp(n_tracks.long(), 0, t).sum())
    return 32 * valid / HBM_BYTES_PER_S * 1e3


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
    bms = [bound_ms(s, nt, th, vi, calib_iters, shape[1])
           for s, tr, nt, th, vi in sets]
    sectors = [sector_bound_ms(nt, shape[1]) for _, _, nt, _, _ in sets]
    return with_share({**time_pair(kern, plain),
                       "bound_ms": float(np.mean([x for x, _ in bms])),
                       "bound_by": bms[0][1],
                       "sector_bound_ms": float(np.mean(sectors)),
                       "max_abs_err": err})


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
# (case, B, Sq, Sk, H, K, D, dtype, flags): qwen3-14b's and
# recurrentgemma-9b's decode steps and prefill at full width, then the
# small cases
FA_CASES = [
    *[("decode", 2, 1, sk, 48, 8, 128, torch.bfloat16, {})
      for sk in (1, 9, 24, 256)],
    ("prefill", 1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128, torch.bfloat16, {}),
    # recurrentgemma-9b: MQA, 16 q heads over 1 kv head of 256, window 2048
    *[("rg decode", 2, 1, sk, 16, 1, 256, torch.bfloat16, {})
      for sk in (1, 24, 256)],
    ("rg prefill", 1, 4096, 4096, 16, 1, 256, torch.bfloat16,
     {"window": 2048}),
    # the tensor-core kernels off the models' own shapes: a prefill whose
    # Sq is no multiple of 64, 64 <= Sq < Sk, head dim 64, window with
    # softcap, non-causal, and decode over long rings (split K and merge)
    ("tc ragged", 1, 300, 300, 48, 8, 128, torch.bfloat16, {}),
    ("tc sq<sk", 2, 100, 300, 8, 2, 128, torch.bfloat16, {}),
    ("tc d64", 1, 200, 200, 8, 2, 64, torch.bfloat16, {}),
    ("tc window+cap", 1, 260, 260, 8, 4, 64, torch.bfloat16,
     {"window": 70, "logit_cap": 30.0}),
    ("tc not causal", 1, 150, 150, 4, 1, 128, torch.bfloat16,
     {"causal": False, "window": 33}),
    ("rg long ring", 2, 1, 2048, 16, 1, 256, torch.bfloat16,
     {"window": 2048}),
    ("long ring", 2, 1, 4096, 48, 8, 128, torch.bfloat16, {}),
    ("decode 2 rows", 1, 2, 300, 12, 2, 64, torch.bfloat16,
     {"logit_cap": 20.0}),
    ("d256 ragged", 1, 300, 300, 4, 2, 256, torch.float32, {"window": 200}),
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
        pl = fa_kernel.plan(b, sq, sk, h, kh, d, dtype,
                            kw.get("causal", True), kw.get("window"))
        out = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        again = fa_kernel.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"flash_attention {name}: two runs differ")
        err = fa_check(out, flash_attention_ref(q, k, v, **kw), dtype, name)
        row = {"case": name, "shape": [b, sq, sk, h, kh, d],
               "dtype": str(dtype).split(".")[-1], "flags": kw,
               "variant": pl.variant, "splits": len(pl.splits),
               "max_abs_err": err}
        if dtype != torch.float32:
            # and against the plain version in f32 on the same values (the
            # kernels' arithmetic: q * scale never rounded), as the LM
            # paths' per-call check holds them
            row["max_abs_err_vs_f32"] = fa_check(
                out, flash_attention_ref(q.float(), k.float(), v.float(),
                                         **kw), dtype, name + " vs f32")
        rows.append(row)
    return rows


def fa_bound_ms(b, sq, sk, h, kh, d, itemsize, window=None):
    """Least time for causal attention on these shapes: q, k, v read and
    the output written once at the HBM rate, against 4 flops per (query,
    valid key, head, head-dim) pair at the bf16 tensor-core rate (a window
    leaves the last ``window`` keys of each query valid); the larger of
    the two, and which one it is."""
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * sk * kh * d)
    pairs = sum(min(sk, i + sk - sq + 1, window or sk) for i in range(sq))
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = 4 * b * h * pairs * d / BF16_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def time_flash(gen, b, sq, sk, h, kh, d, window=None):
    """flash_attention at one main-path shape (bf16, causal) over
    TIMING_ROTATION operand sets: kernel and plain version as in
    ``time_kernel``, and the library call,
    ``scaled_dot_product_attention(enable_gqa=True)`` (causal at prefill,
    or an explicit boolean mask under a window; at decode every key is
    valid and SDPA would align a causal mask top-left), timed only."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sets = [fa_operands(gen, b, sq, sk, h, kh, d, torch.bfloat16)
            for _ in range(TIMING_ROTATION)]
    kern = [functools.partial(fa_kernel.flash_attention_cuda, *qkv,
                              window=window) for qkv in sets]
    plain = [functools.partial(flash_attention_ref, *qkv, window=window)
             for qkv in sets]
    lib_kw = {"is_causal": sq > 1}
    if window is not None:
        q_pos = torch.arange(sq, device=DEVICE)[:, None] + sk - sq
        k_pos = torch.arange(sk, device=DEVICE)[None, :]
        lib_kw = {"attn_mask": (k_pos <= q_pos) & (k_pos > q_pos - window)}
    lib = [functools.partial(sdpa, *(x.transpose(1, 2) for x in qkv),
                             enable_gqa=True, **lib_kw) for qkv in sets]
    err = lib_err = 0.0
    for kc, pc, lc in zip(kern[:4], plain[:4], lib[:4]):
        out, want, lo = kc(), pc(), lc().transpose(1, 2)
        err = max(err, fa_check(out, want, torch.bfloat16, "timing"))
        lib_err = max(lib_err, float((lo.float() - want.float()).abs()
                                     .max()))
    bound, by = fa_bound_ms(b, sq, sk, h, kh, d, 2, window)
    pl = fa_kernel.plan(b, sq, sk, h, kh, d, torch.bfloat16, True, window)
    return {"variant": pl.variant, "splits": len(pl.splits),
            **time_pair(kern, plain), "library_ms": device_time_ms(lib),
            "library_max_abs_err": lib_err, "bound_ms": bound,
            "bound_by": by, "max_abs_err": err}


# --------------------------------------------------------------------- #
# RG-LRU scan and mLSTM
# --------------------------------------------------------------------- #
# (B, S, W, with h0): recurrentgemma-9b's forward shape with and without
# a carried state, a ragged case, S under one chunk, W no multiple of 4
# (the kernel's cp.async load path), and more than 16 groups of chunks
# (the carry reads group aggregates in two batches)
SCAN_CASES = [(1, 4096, 4096, False), (1, 4096, 4096, True),
              (3, 100, 48, True), (2, 8, 4096, True), (2, 77, 50, True),
              (1, 9000, 128, True)]
# (B, S, H, D, dtype, flags): xlstm-350m's forward shape, then small cases
# whose S is no multiple of the 32-row tile, then the tensor-core kernel
# (bf16, D 512) off the model's shape: a ragged S, S under one 64-row
# tile, two batch rows, q, k and v as strided views of one fused
# projection, and input gates low enough (log i ~ N(-3, 1)) that exp(-m)
# wins the normaliser on most rows
MLSTM_CASES = [(1, 2048, 4, 512, torch.bfloat16, {}),
               (1, 2048, 4, 512, torch.float32, {}),
               (1, 64, 2, 16, torch.float32, {}),
               (2, 100, 2, 16, torch.float32, {}),
               (2, 96, 4, 32, torch.float32, {}),
               (1, 100, 1, 64, torch.float32, {}),
               (2, 70, 2, 512, torch.float32, {}),
               (2, 37, 4, 64, torch.bfloat16, {}),
               (1, 300, 4, 512, torch.bfloat16, {}),
               (1, 37, 4, 512, torch.bfloat16, {}),
               (2, 512, 4, 512, torch.bfloat16, {}),
               (2, 200, 4, 512, torch.bfloat16, {"fused": True}),
               (1, 300, 4, 512, torch.bfloat16, {"i_shift": -3.0})]


def scan_operands(gen, b, s, w, with_h0):
    """a in [0.7, 1) as the RG-LRU's decays, b ~ N(0, 1), h0 ~ N(0, 1)."""
    a = torch.rand((b, s, w), generator=gen, device=DEVICE) * 0.3 + 0.7
    x = torch.randn((b, s, w), generator=gen, device=DEVICE)
    h0 = torch.randn((b, w), generator=gen, device=DEVICE) \
        if with_h0 else None
    return a, x, h0


def mlstm_operands(gen, b, s, h, d, dtype, fused=False, i_shift=0.0):
    """q, k, v ~ N(0, 1) in ``dtype``, log_i ~ N(i_shift, 1), log_f =
    -|N(0, 1)| / 2 (f32), as the reference's kernel tests draw them; with
    ``fused`` q, k and v are views of one (B, S, 3, H, D) tensor."""
    if fused:
        qkv = torch.randn((b, s, 3, h, d), generator=gen,
                          device=DEVICE).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=DEVICE)
                   .to(dtype) for _ in range(3))
    log_i = torch.randn((b, s, h), generator=gen, device=DEVICE) + i_shift
    log_f = -torch.randn((b, s, h), generator=gen, device=DEVICE).abs() * 0.5
    return q, k, v, log_i, log_f


def normaliser_share(q, k, log_i, log_f):
    """Share of rows whose normaliser max(|den|, exp(-m)) is exp(-m), from
    the plain function in f32 (m the gate part's row max)."""
    b, s, h, d = q.shape
    fcum = torch.cumsum(log_f, dim=1)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logw = fcum[:, :, None] - fcum[:, None, :] + log_i[:, None, :]
    logw = torch.where(causal[None, :, :, None], logw, -1e30)
    m = logw.amax(dim=2)
    sc = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * d ** -0.5
    den = (torch.exp(logw - m[:, :, None]) * sc).sum(dim=2)
    return float((torch.exp(-m) > den.abs()).float().mean())


def close_check(out, want, rtol, atol, name) -> float:
    """Max |kernel - plain|; raises when an element lies outside
    atol + rtol |plain| or is not finite."""
    o, w = out.float(), want.float()
    if o.shape != w.shape or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{name}: shape {o.shape} or non-finite output")
    err = (o - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} atol "
            f"{atol}, max err {float(err.max())}")
    return float(err.max())


def mlstm_plain_f32(q, k, v, log_i, log_f):
    """The plain version evaluated in f32 on the same values: what the
    kernel (and the Pallas kernel, which upcasts q, k, v) computes."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    return mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f)


def phase_scan_kernels(gen):
    """rglru_scan and mlstm against their plain versions; two launches of
    each case must give the same bits, and rglru_scan must equal its
    order of operations in plain PyTorch (rglru_scan_chunked_ref) bit for
    bit."""
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_chunked_ref,
                                                    rglru_scan_ref)
    rows = []
    for b, s, w, with_h0 in SCAN_CASES:
        a, x, h0 = scan_operands(gen, b, s, w, with_h0)
        pl = rg_kernel.plan(b, s, w)
        out, last = rg_kernel.rglru_scan_cuda(a, x, h0)
        again, _ = rg_kernel.rglru_scan_cuda(a, x, h0)
        torch.cuda.synchronize()
        name = f"rglru_scan {(b, s, w)}"
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs differ")
        emul, emul_last = rglru_scan_chunked_ref(a, x, h0, pl.chunk)
        if not (torch.equal(out, emul) and torch.equal(last, emul_last)):
            raise AssertionError(
                f"{name}: not bit-equal to rglru_scan_chunked_ref at chunk "
                f"{pl.chunk}: {int((out != emul).sum())} elements differ, "
                f"max {float((out - emul).abs().max())}")
        want, want_last = rglru_scan_ref(a, x, h0)
        err = close_check(out, want, *SCAN_TOL, name)
        close_check(last, want_last, *SCAN_TOL, "rglru_scan h_last")
        rows.append({"kernel": "rglru_scan", "shape": [b, s, w],
                     "h0": with_h0, "chunk": pl.chunk,
                     "tile": rg_kernel.TILE, "blocks": pl.blocks,
                     "load": pl.load, "bit_equal_chunked_ref": True,
                     "max_abs_err": err})
    for b, s, h, d, dtype, kw in MLSTM_CASES:
        ops = mlstm_operands(gen, b, s, h, d, dtype, **kw)
        pl = ml_kernel.plan(b, s, h, d, dtype)
        out = ml_kernel.mlstm_cuda(*ops)
        again = ml_kernel.mlstm_cuda(*ops)
        torch.cuda.synchronize()
        name = f"mlstm {(b, s, h, d)} {dtype} {kw}"
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two runs differ")
        err = close_check(out, mlstm_plain_f32(*ops), *MLSTM_TOL[dtype], name)
        row = {"kernel": "mlstm", "shape": [b, s, h, d],
               "dtype": str(dtype).split(".")[-1], "flags": kw,
               "variant": pl.variant, "blocks": len(pl.items) * b * h,
               "split_tiles": pl.split_tiles, "max_abs_err": err}
        if "i_shift" in kw:
            row["exp_neg_m_share"] = normaliser_share(ops[0], ops[1],
                                                      ops[3], ops[4])
        if dtype != torch.float32:
            # the plain version in the working dtype rounds a to bf16
            # before a.v, as the reference's mlstm_parallel: reported, and
            # held end to end by the xlstm forward's logit check
            plain = mlstm_ref(*ops).float()
            diff = (out.float() - plain).abs()
            row["vs_plain_in_dtype"] = {
                "max_abs_err": float(diff.max()),
                "share_outside_tol": float(
                    (diff > 2e-2 + 2e-2 * plain.abs()).float().mean())}
        rows.append(row)
    return rows


def scan_bound_ms(b, s, w):
    """Least time for the recurrence without h0, as the forward calls it:
    a and b read and h written once at the HBM rate, against 2 flops an
    element at the fp32 rate; the larger, and which one it is."""
    nbytes = 4 * 3 * b * s * w
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = 2 * b * s * w / FP32_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def mlstm_bound_ms(b, s, h, d, itemsize):
    """Least time for the chunkwise mLSTM: q, k, v, log_i, log_f read and
    the output written once at the HBM rate, against 4 flops per (query,
    causal key, head, head-dim) at the bf16 tensor-core rate; the larger,
    and which one it is."""
    nbytes = itemsize * 4 * b * s * h * d + 4 * 2 * b * s * h
    pairs = s * (s + 1) // 2
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = 4 * b * h * pairs * d / BF16_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def time_scan(gen, b, s, w):
    """rglru_scan at recurrentgemma-9b's forward shape (no h0, as the
    forward calls it) over TIMING_ROTATION operand sets.  No library
    call: no single PyTorch call computes a first-order linear
    recurrence."""
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    sets = [scan_operands(gen, b, s, w, False)[:2]
            for _ in range(TIMING_ROTATION // 4)]
    kern = [functools.partial(rg_kernel.rglru_scan_cuda, *ab) for ab in sets]
    plain = [functools.partial(rglru_scan_ref, *ab) for ab in sets]
    err = 0.0
    for kc, pc in zip(kern[:2], plain[:2]):
        err = max(err, close_check(kc()[0], pc()[0], *SCAN_TOL, "timing"))
    bound, by = scan_bound_ms(b, s, w)
    pl = rg_kernel.plan(b, s, w)
    return with_share({"chunk": pl.chunk, "blocks": pl.blocks,
                       "load": pl.load, **time_pair(kern, plain),
                       "library_ms": None, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err})


def time_mlstm(gen, b, s, h, d):
    """mlstm at xlstm-350m's forward shape (bf16) over TIMING_ROTATION
    operand sets; the plain version in bf16, as the model's plain path.
    No library call: scaled_dot_product_attention cannot apply the gate
    decay or the max(|den|, exp(-m)) normaliser."""
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    sets = [mlstm_operands(gen, b, s, h, d, torch.bfloat16)
            for _ in range(TIMING_ROTATION)]
    kern = [functools.partial(ml_kernel.mlstm_cuda, *ops) for ops in sets]
    plain = [functools.partial(mlstm_ref, *ops) for ops in sets]
    err = 0.0
    for kc, ops in zip(kern[:4], sets[:4]):
        err = max(err, close_check(kc(), mlstm_plain_f32(*ops),
                                   *MLSTM_TOL[torch.bfloat16], "timing"))
    bound, by = mlstm_bound_ms(b, s, h, d, 2)
    pl = ml_kernel.plan(b, s, h, d, torch.bfloat16)
    return with_share({"variant": pl.variant,
                       "blocks": len(pl.items) * b * h,
                       **time_pair(kern, plain), "library_ms": None,
                       "bound_ms": bound, "bound_by": by,
                       "max_abs_err": err})


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


def profile_run(phase, run, **extra):
    """Device time by kernel over one ``run()``, from torch.profiler; the
    profiler's own cost is in ``wall_s``.  ``extra`` goes into the line."""
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
    emit({"phase": phase, **extra, "wall_s": wall, "device_busy_s": busy_s,
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
LM_KERNELS = ("flash_attention", "rglru_scan", "mlstm")
F32_UNIT = 2.0 ** -24         # f32's unit roundoff
SENS_KEYS = 64                # keys a row for flash_exact's sensitivity
# on ill-conditioned flash calls (shadow_kernels): each score may be off by
# SENS_KAPPA u |s|, twice the largest error of the plain version's f32
# scores (3.4 u |s| in cuBLAS's order, 4.5 u |s| with the head dim
# reversed; scripts/flash_conditioning.py on recurrentgemma-9b's forward),
# and the kernel's largest and mean errors against the exact value may be
# ERR_RATIO times the plain version's in the kernel's output dtype
SENS_KAPPA = 8.0
ERR_RATIO = 1.1


@contextlib.contextmanager
def plain_kernels(f32=False):
    """Inside the block every LM-path kernel call on a CUDA tensor takes
    the plain version: attention in the dense and hybrid models (both
    reach it through ``transformer.flash_attention``), the RG-LRU
    recurrence and the chunkwise mLSTM.  With ``f32`` the plain versions
    run on the same values upcast to f32 (the kernels' arithmetic) and
    cast their output back.  The comparison runs only, never the served
    path, whose calls launch the kernels."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import rglru, transformer, xlstm

    def flash_f32(q, k, v, **kw):
        return flash_attention_ref(q.float(), k.float(), v.float(),
                                   **kw).to(q.dtype)

    def mlstm_f32(q, k, v, log_i, log_f):
        return mlstm_plain_f32(q, k, v, log_i, log_f).to(q.dtype)

    swaps = ((transformer, "flash_attention",
              flash_f32 if f32 else flash_attention_ref),
             (rglru, "linear_scan", rglru_scan_ref),
             (xlstm, "mlstm_scan", mlstm_f32 if f32 else mlstm_ref))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def flash_exact(q, k, v, *, causal=True, window=None, scale=None,
                logit_cap=None, rows=256, sensitivity=False):
    """flash_attention's function evaluated in float64 (to ~1e-15), query
    rows in chunks: the exact value both the kernel and the plain version
    in f32 approximate.

    With ``sensitivity`` also returns, for each output element, how far it
    moves when every score s_j moves by u |s_j| (u = 2^-24, f32's unit
    roundoff), to first order: sum_j p_j u |s_j| |v_j - out|, over the
    SENS_KEYS keys of largest p_j |s_j| of the row, plus the rest's weight
    times max |v| + |out| as a bound.  A score held in f32 is off by at
    least its own rounding, u |s_j|, so an element whose sensitivity is
    comparable to FA_TOL is decided by rounding, not by the arithmetic."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kk = k.double().repeat_interleave(h // kh, dim=2)
    vv = v.double().repeat_interleave(h // kh, dim=2)
    v_max = float(vv.abs().max())
    k_pos = torch.arange(sk, device=q.device)[None, :]
    out = torch.empty((b, sq, h, d), dtype=torch.float64, device=q.device)
    sens = torch.empty_like(out) if sensitivity else None
    for i0 in range(0, sq, rows):
        qs = q[:, i0:i0 + rows].double()
        raw = torch.einsum("bqhd,bkhd->bhqk", qs, kk) * scale
        s = raw if logit_cap is None else \
            logit_cap * torch.tanh(raw / logit_cap)
        q_pos = torch.arange(i0, i0 + qs.shape[1], device=q.device)[:, None] \
            + (sk - sq if causal else 0)
        valid = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            valid &= k_pos <= q_pos
        if window is not None:
            valid &= k_pos > q_pos - window
        s = s.masked_fill(~valid, float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1))   # rows of no key: 0
        o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
        out[:, i0:i0 + rows] = o
        if sensitivity:
            # a capped score moves no more than the raw one (tanh' <= 1)
            w = p * raw.abs() * F32_UNIT                  # (B, H, R, Sk)
            top, idx = w.topk(min(SENS_KEYS, sk), dim=-1)
            rest = (w.sum(-1) - top.sum(-1)).clamp(min=0)
            vsel = torch.gather(
                vv.permute(0, 2, 1, 3)[:, :, None].expand(
                    -1, -1, qs.shape[1], -1, -1), 3,
                idx[..., None].expand(-1, -1, -1, -1, d))   # (B,H,R,T,D)
            ob = o.permute(0, 2, 1, 3)                    # (B, H, R, D)
            dev = (vsel - ob[:, :, :, None]).abs()
            e = (top[..., None] * dev).sum(-2) + \
                rest[..., None] * (v_max + ob.abs())
            sens[:, i0:i0 + rows] = e.permute(0, 2, 1, 3)
    return (out, sens) if sensitivity else out


@contextlib.contextmanager
def shadow_kernels():
    """Inside the block every LM-path kernel call still launches its
    kernel, whose output the path goes on with, and is then held against
    its plain version evaluated in f32 on the same inputs (FA_TOL,
    SCAN_TOL, MLSTM_TOL, elementwise): the per-call check of each kernel
    at the shapes and on the activations the path gives it.  Yields the
    per-kernel tally (calls, elements outside the tolerance, max
    |difference|).

    flash_attention is also evaluated exactly (``flash_exact``, f64).  A
    call whose plain version in f32 is itself outside FA_TOL of the exact
    value somewhere is ill-conditioned: its scores spread so wide (C-ref5:
    recurrentgemma-9b's forward, |s| to ~5e3) that the rounding of each
    score to f32 decides near-ties, so an evaluation without error fails
    the comparison with the plain version in f32 there.  On such a call
    each element of the kernel is held against the exact value instead,
    within FA_TOL plus SENS_KAPPA times the element's sensitivity to f32
    score rounding (``flash_exact``), and the kernel's largest and mean
    error against the exact value may be no more than ERR_RATIO times
    those of the plain version in f32 rounded to the kernel's output
    dtype.  Every other call is held against the plain version in f32 as
    before.  The tally keeps, for the ill-conditioned calls, the elements
    outside FA_TOL of the exact value (kernel, plain version), those where
    the kernel is outside it and the plain version inside, the elements
    of the kernel outside FA_TOL of the plain version in f32, and those of
    the exact value rounded to the output dtype."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import rglru, transformer, xlstm
    tally = {name: {"calls": 0, "outside": 0, "elements": 0,
                    "max_abs_err": 0.0} for name in LM_KERNELS}
    tally["flash_attention"].update(
        ill_conditioned_calls=0, ill_kernel_outside_exact=0,
        ill_plain_f32_outside_exact=0, ill_kernel_off_where_plain_on=0,
        ill_kernel_outside_plain_f32=0, ill_exact_outside_plain_f32=0,
        ill_max_err_ratio=0.0, ill_mean_err_ratio=0.0)

    def off(out, want, rtol, atol):
        o, w = out.to(want.dtype), want
        return ~((o - w).abs() <= atol + rtol * w.abs())

    def outside(out, want, rtol, atol):
        return int(off(out, want, rtol, atol).sum())

    def record(name, out, want, rtol, atol, counted=None):
        o, w = out.float(), want.float()
        err = (o - w).abs()
        t = tally[name]
        t["calls"] += 1
        t["elements"] += err.numel()
        t["outside"] += outside(o, w, rtol, atol) if counted is None \
            else counted
        t["max_abs_err"] = max(t["max_abs_err"], float(err.max()))

    kern_fa, kern_scan, kern_mlstm = (transformer.flash_attention,
                                      rglru.linear_scan, xlstm.mlstm_scan)

    def flash(q, k, v, **kw):
        out = kern_fa(q, k, v, **kw)
        rtol, atol = FA_TOL[q.dtype]
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        exact = flash_exact(q, k, v, **kw)
        plain_off = off(want, exact, rtol, atol)
        counted = None
        if bool(plain_off.any()):
            exact, sens = flash_exact(q, k, v, sensitivity=True, **kw)
            o = out.double()
            err = (o - exact).abs()
            counted = int((err > atol + rtol * exact.abs() +
                           SENS_KAPPA * sens).sum())
            kern_off = off(o, exact, rtol, atol)
            err_p = (want.to(out.dtype).double() - exact).abs()
            t = tally["flash_attention"]
            t["ill_conditioned_calls"] += 1
            t["ill_kernel_outside_exact"] += int(kern_off.sum())
            t["ill_plain_f32_outside_exact"] += int(plain_off.sum())
            t["ill_kernel_off_where_plain_on"] += int(
                (kern_off & ~plain_off).sum())
            t["ill_kernel_outside_plain_f32"] += outside(out, want, rtol,
                                                         atol)
            t["ill_exact_outside_plain_f32"] += outside(
                exact.to(out.dtype), want, rtol, atol)
            t["ill_max_err_ratio"] = max(t["ill_max_err_ratio"], float(
                err.max() / err_p.max()))
            t["ill_mean_err_ratio"] = max(t["ill_mean_err_ratio"], float(
                err.mean() / err_p.mean()))
            del sens, err, err_p
        del exact
        record("flash_attention", out, want, rtol, atol, counted=counted)
        return out

    def scan(a, b, h0=None):
        out = kern_scan(a, b, h0)
        record("rglru_scan", out[0], rglru_scan_ref(a, b, h0)[0], *SCAN_TOL)
        return out

    def mlstm(q, k, v, log_i, log_f):
        out = kern_mlstm(q, k, v, log_i, log_f)
        record("mlstm", out, mlstm_plain_f32(q, k, v, log_i, log_f),
               *MLSTM_TOL[q.dtype])
        return out

    swaps = ((transformer, "flash_attention", flash),
             (rglru, "linear_scan", scan), (xlstm, "mlstm_scan", mlstm))
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield tally
    finally:
        transformer.flash_attention = kern_fa
        rglru.linear_scan = kern_scan
        xlstm.mlstm_scan = kern_mlstm


def check_calls(name, tally):
    for kernel, t in tally.items():
        if t["outside"]:
            raise AssertionError(
                f"{name}: {t['outside']} of {t['elements']} elements of "
                f"{t['calls']} {kernel} calls outside the tolerance against "
                f"the plain version in f32 (on ill-conditioned flash calls: "
                f"against the exact value, FA_TOL plus the score-rounding "
                f"band), max err {t['max_abs_err']}; {t}")
    t = tally["flash_attention"]
    if max(t["ill_max_err_ratio"], t["ill_mean_err_ratio"]) > ERR_RATIO:
        raise AssertionError(
            f"{name}: on ill-conditioned calls the flash kernel's error "
            f"against the exact value exceeds {ERR_RATIO} times the plain "
            f"version's in the same dtype: {t}")


def compare_runs(cfg, kern, run, rows):
    """``kern``, the kernels' logits of a path, against ``run()`` (the
    same path) on the plain versions in the working dtype and in f32; the
    two plain runs against each other, which differ only in rounding (the
    path's own sensitivity); each as (max relative logit difference, top-1
    agreement) over ``rows(logits)``.  And the per-call check of the
    path's kernels."""
    def cmp(a, b):
        rel, top1 = compare_logits(rows(a), rows(b), cfg.vocab_size)
        return {"max_rel_logit_diff": max(rel), "top1_agreement": top1,
                "rel_logit_diff": rel}

    with plain_kernels():
        plain = run()
    with plain_kernels(f32=True):
        plain_f32 = run()
    out = {"plain": cmp(kern, plain), "plain_f32": cmp(kern, plain_f32),
           "plain_vs_plain_f32": cmp(plain, plain_f32)}
    del plain, plain_f32
    with shadow_kernels() as tally:
        run()
    out["per_call"] = tally
    return out


def summary(cmp):
    """The comparison without its per-row lists, for the phase line."""
    return {key: {k: v for k, v in val.items() if k != "rel_logit_diff"}
            for key, val in cmp.items() if key.startswith("plain")}


def check_runs(name, cfg, cmp):
    """The per-call check always; the end-to-end logits against the plain
    versions where the model is not chaotic (E2E_GATED)."""
    check_calls(name, cmp["per_call"])
    if cfg.name in E2E_GATED:
        check_logits(name, [cmp["plain"]["max_rel_logit_diff"]],
                     cmp["plain"]["top1_agreement"])


def lm_counted(run):
    """Run one LM path with the LM kernels' launch counts zeroed just
    before it and read just after it: (its output, its launches), with
    the flash_attention and mlstm calls also counted by the device kernel
    each took (``flash_attention.<variant>``, ``mlstm.<variant>``)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    counters = (fa_kernel.LAUNCHES, rg_kernel.LAUNCHES, ml_kernel.LAUNCHES)
    for c in (*counters, fa_kernel.VARIANT_CALLS, ml_kernel.VARIANT_CALLS):
        for key in c:
            c[key] = 0
    out = run()
    torch.cuda.synchronize()
    launches = {}
    for c in counters:
        launches.update(c)
    launches.update({f"flash_attention.{key}": n
                     for key, n in fa_kernel.VARIANT_CALLS.items()})
    launches.update({f"mlstm.{key}": n
                     for key, n in ml_kernel.VARIANT_CALLS.items()})
    return out, launches


def check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"{name} launched {got}, expected {want}")


def lm_launches(flash=0, variant=None, rglru_scan=0, mlstm=0):
    """The launch counts of one LM path: ``flash`` flash_attention calls,
    all taking the device kernel ``variant``, and ``mlstm`` calls, all on
    the tensor-core kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    out = {"flash_attention": flash, "rglru_scan": rglru_scan,
           "mlstm": mlstm}
    out.update({f"flash_attention.{key}": flash if key == variant else 0
                for key in fa_kernel.VARIANTS})
    out.update({f"mlstm.{key}": mlstm if key == "wgmma" else 0
                for key in ml_kernel.VARIANTS})
    return out


def path_launches(cfg):
    """What each path of ``cfg``'s model must launch, counted from its
    pattern: ``generate`` (every decode step's attention layers, each on
    the GQA-packed decode kernel) and one ``forward`` (each attention,
    RG-LRU and mLSTM layer once, the attention and the mLSTM on their
    tensor-core kernels)."""
    from repro_torch.models import hybrid, xlstm
    steps = LM_PROMPT + LM_NEW
    if cfg.family == "hybrid":
        unit, n_super, tail = hybrid._pattern(cfg)
        n_attn = n_super * unit.count("attn")
        n_rec = n_super * unit.count("rec") + tail.count("rec")
        return (lm_launches(n_attn * steps, "decode"),
                lm_launches(n_attn, "wgmma", rglru_scan=n_rec))
    if cfg.family == "ssm":
        unit, n_super = xlstm._pattern(cfg)
        return (lm_launches(),
                lm_launches(mlstm=n_super * unit.count("mlstm")))
    return (lm_launches(cfg.num_layers * steps, "decode"),
            lm_launches(cfg.num_layers, "wgmma"))


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
            f"{name}: kernels vs plain versions max rel logit difference "
            f"{max(rel)} (limit {LM_REL_TOL}), top-1 agreement {top1} "
            f"(at least {LM_TOP1_MIN})")


def build_lm(arch):
    """``arch`` at full width on the card, weights from a seeded
    generator, held by ``LanguageModel``: (cfg, model facade, parameter
    tree)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_zoo
    cfg = get_config(arch)
    model = model_zoo.build_model(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm = model_zoo.LanguageModel(model, model.table.init(gen, DEVICE))
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "q_heads": [cfg.num_heads, cfg.num_heads_padded],
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "lru_width": cfg.lru_width,
          "attention_window": cfg.attention_window,
          "xlstm_pattern": list(cfg.xlstm_pattern),
          "vocab_padded": cfg.vocab_padded,
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
    """generate() through the kernels, its launch counts, tok/s, and the
    teacher-forced comparison with the plain versions."""
    from repro_torch.launch.serve import generate
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=DEVICE)
    generate(cfg, model, params, prompt, max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, launches = lm_counted(lambda: generate(
        cfg, model, params, prompt, max_new_tokens=LM_NEW))
    wall = time.perf_counter() - t0
    check_launches(f"{cfg.name} generate", launches, path_launches(cfg)[0])
    if tuple(tokens.shape) != (LM_BATCH, LM_NEW) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {tuple(tokens.shape)} or "
                             "ids outside the vocab")

    seq = torch.cat([prompt, tokens], dim=1)   # what the 24 steps were fed
    kern = replay(cfg, model, params, seq)
    pred = kern[..., :cfg.vocab_size].argmax(-1)       # (steps, B)
    if not torch.equal(pred[LM_PROMPT - 1:LM_PROMPT - 1 + LM_NEW].T, tokens):
        raise AssertionError("the kernels' teacher-forced replay does not "
                             "give generate()'s tokens")
    cmp = compare_runs(cfg, kern, lambda: replay(cfg, model, params, seq),
                       lambda logits: logits)
    check_runs(f"{cfg.name} serve", cfg, cmp)
    profile_run("lm_profile", lambda: generate(
        cfg, model, params, prompt, max_new_tokens=LM_NEW), arch=cfg.name)
    emit({"phase": "lm", "arch": cfg.name, "batch": LM_BATCH,
          "prompt": LM_PROMPT, "new_tokens": LM_NEW,
          "decode_steps": LM_PROMPT + LM_NEW,
          "flash_attention_launches": launches["flash_attention"],
          "launches": launches, "wall_s": wall,
          "tok_per_s": LM_BATCH * LM_NEW / wall,
          "ms_per_decode_step": wall / (LM_PROMPT + LM_NEW) * 1e3,
          "rel_logit_diff_per_step": cmp["plain"]["rel_logit_diff"],
          "top1_agreement": cmp["plain"]["top1_agreement"],
          "end_to_end_gated": cfg.name in E2E_GATED, **summary(cmp),
          "per_call": cmp["per_call"], "sample": tokens[0].tolist()})
    return launches


@torch.inference_mode()
def phase_prefill(cfg, model, params):
    """One forward() over 1 x FORWARD_LEN tokens through the kernels
    (each attention, RG-LRU and mLSTM layer launches once), compared with
    the same forward on the plain versions."""
    length = FORWARD_LEN[cfg.name]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, length), generator=gen,
                         device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (logits, _), launches = lm_counted(
        lambda: model.forward(params, {"tokens": toks}))
    wall = time.perf_counter() - t0
    check_launches(f"{cfg.name} forward", launches, path_launches(cfg)[1])
    # each position is one row of the comparison
    cmp = compare_runs(cfg, logits,
                       lambda: model.forward(params, {"tokens": toks})[0],
                       lambda x: x[0][:, None])
    del logits
    check_runs(f"{cfg.name} forward", cfg, cmp)
    emit({"phase": "prefill", "arch": cfg.name, "tokens": length,
          "flash_attention_launches": launches["flash_attention"],
          "launches": launches, "wall_s": wall, "tok_per_s": length / wall,
          "max_rel_logit_diff": cmp["plain"]["max_rel_logit_diff"],
          "top1_agreement": cmp["plain"]["top1_agreement"],
          "end_to_end_gated": cfg.name in E2E_GATED, **summary(cmp),
          "per_call": cmp["per_call"]})
    return launches


@torch.inference_mode()
def phase_recurrent_tie(cfg, model, params):
    """The forward's logits through the mLSTM kernel against a
    teacher-forced decode of the same tokens (the recurrent form, no
    kernel launch): each position is one row of the comparison.  Beside
    it the same tie with the plain mLSTM in f32, the path's own
    sensitivity; reported, not gated (E2E_GATED).  The decode must launch
    no kernel."""
    length = min(TIE_LEN, FORWARD_LEN[cfg.name])
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, length), generator=gen,
                         device=DEVICE)
    t0 = time.perf_counter()
    steps, launches = lm_counted(lambda: replay(cfg, model, params, toks))
    wall = time.perf_counter() - t0
    check_launches(f"{cfg.name} decode", launches, lm_launches())
    ties = {}
    for key, ctx in (("kernel", contextlib.nullcontext()),
                     ("plain_f32", plain_kernels(f32=True))):
        with ctx:
            logits, _ = model.forward(params, {"tokens": toks})
        rel, top1 = compare_logits(logits[0][:, None], steps,
                                   cfg.vocab_size)
        first = next((i for i, r in enumerate(rel) if r > LM_REL_TOL), None)
        ties[key] = {"max_rel_logit_diff": max(rel), "top1_agreement": top1,
                     "first_position_over_tol": first,
                     "rel_at": {p: rel[p] for p in (0, 15, 63, 255, 1023,
                                                    length - 1)
                                if p < length}}
        del logits
    emit({"phase": "recurrent_tie", "arch": cfg.name, "tokens": length,
          "decode_wall_s": wall, "decode_launches": launches, **ties})


# --------------------------------------------------------------------- #
def kernel_name(mangled) -> str:
    """A kernel's readable name from its mangled one: the name and its
    template arguments (a type as bf16 or f32, an int as itself)."""
    import re
    m = re.search(r"\d+([a-z_]+_kernel)(I(.*?)EEv)?", mangled)
    if m is None:
        return mangled
    args, text, i = [], m.group(3) or "", 0
    while i < len(text):
        if text.startswith("Li", i):
            j = text.index("E", i)
            args.append(text[i + 2:j])
            i = j + 1
        elif text.startswith("13__nv_bfloat16", i):
            args.append("bf16")
            i += len("13__nv_bfloat16")
        elif text[i] == "f":
            args.append("f32")
            i += 1
        else:
            i += 1
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(source) -> list:
    """Registers and spill bytes of each kernel instance in ``source``,
    from the ptxas report its build kept."""
    import re
    from repro_torch import kernels
    rows = []
    for line in kernels.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"kernel": kernel_name(m.group(1))})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def build_all():
    """One nvcc per source, all started together."""
    from repro_torch.kernels.event_filter import kernel as ef_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    modules = (ef_kernel, fa_kernel, rg_kernel, ml_kernel)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        futures = [pool.submit(m.build) for m in modules]
        for f in futures:
            f.result()
    ptxas = {m.SOURCE.name: ptxas_report(m.SOURCE) for m in modules}
    emit({"phase": "build", "sources": [m.SOURCE.name for m in modules],
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})
    # the tensor-core kernels hold their state in registers by design, and
    # the chunked scan holds a few floats a thread: a spill is a fault of
    # the build, not a slowdown to report
    spilled = [row for m in (fa_kernel, ml_kernel, rg_kernel)
               for row in ptxas[m.SOURCE.name]
               if row.get("spill_stores") or row.get("spill_loads")]
    if spilled:
        raise AssertionError(f"kernel instances spill: {spilled}")
    for m, name in ((ml_kernel, "mlstm_wgmma_kernel"),
                    (rg_kernel, "rglru_chunked_kernel")):
        if not any(row["kernel"].startswith(name)
                   for row in ptxas[m.SOURCE.name]):
            raise AssertionError(f"no {name} in the ptxas report")


def release():
    gc.collect()
    torch.cuda.empty_cache()


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
    scan_rows = phase_scan_kernels(gen)
    emit({"phase": "scan_kernels", "cases": len(scan_rows),
          "tolerance": {"rglru_scan": SCAN_TOL,
                        "mlstm": {str(k).split(".")[-1]: v
                                  for k, v in MLSTM_TOL.items()}},
          "rows": scan_rows})

    # 4. serve and lockstep (the query paths; launch counts read around
    # each)
    launches, widths = phase_serve(args.n_events)
    release()

    # 5, 6. each LM at full width: serve and one forward (launch counts
    # read around each path), one model on the card at a time
    lm = build_lm(LM_ARCH)
    launches["flash_attention"] = phase_lm(*lm)["flash_attention"]
    prefill_launches = phase_prefill(*lm)["flash_attention"]
    del lm
    release()
    lm = build_lm(RG_ARCH)
    rg_serve = phase_lm(*lm)
    rg_forward = phase_prefill(*lm)
    launches["rglru_scan"] = rg_forward["rglru_scan"]
    del lm
    release()
    lm = build_lm(XL_ARCH)
    phase_lm(*lm)
    launches["mlstm"] = phase_prefill(*lm)["mlstm"]
    phase_recurrent_tie(*lm)
    del lm
    release()

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
        "rglru_scan": time_scan(gen, 1, FORWARD_LEN[RG_ARCH], 4096),
        "mlstm": time_mlstm(gen, 1, FORWARD_LEN[XL_ARCH], 4, 512),
    }
    prefill = time_flash(gen, 1, PREFILL_LEN, PREFILL_LEN, 48, 8, 128)
    rg_len = FORWARD_LEN[RG_ARCH]
    rg_decode = time_flash(gen, LM_BATCH, 1, LM_PROMPT + LM_NEW, 16, 1, 256)
    rg_prefill = time_flash(gen, 1, rg_len, rg_len, 16, 1, 256, window=2048)
    emit({"phase": "timing", "smi": smi,
          "launch_floor_ms": launch_floor_ms(),
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
              "launches_prefill": prefill_launches, **prefill},
          "flash_attention_rg_decode": {
              "shape": [LM_BATCH, 1, LM_PROMPT + LM_NEW, 16, 1, 256],
              "launches_serve": rg_serve["flash_attention"], **rg_decode},
          "flash_attention_rg_prefill": {
              "shape": [1, rg_len, rg_len, 16, 1, 256], "window": 2048,
              "launches_forward": rg_forward["flash_attention"],
              **rg_prefill},
          "rglru_scan": {"shape": [1, rg_len, 4096],
                         "launches_forward": launches["rglru_scan"],
                         **timed["rglru_scan"]},
          "mlstm": {"shape": [1, FORWARD_LEN[XL_ARCH], 4, 512],
                    "dtype": "bfloat16",
                    "launches_forward": launches["mlstm"],
                    **timed["mlstm"]}})

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
        "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/"
                       "rglru_scan.cu",
                       "src/repro/kernels/rglru_scan/kernel.py:42"),
        "mlstm": ("src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
                  "src/repro/kernels/mlstm_scan/kernel.py:70"),
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
