"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py                # full size: 8192 events, ~8.5 GB
    python3 chip_smoke.py --n-events 512 # a short first check

Phases, each printing one JSON line:

1. device  — torch's device name, nvidia-smi's name and power limit;
2. build   — nvcc builds the query path's CUDA source;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the query path's chunk shape (64, 4096, 63) with S = 64 and a ragged
   (37, 1000, 63), K in {1, 4, 17}, calib_iters in {0, 4}, with and
   without a sum(pt) cap.  Masks must be equal at calib 0 without a cap;
   otherwise they may differ only on band events (a count-driving pt or
   the sum within rtol 1e-5 of its threshold), which are counted;
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
5. timing  — each kernel at the shape the main path gave it, beside its
   plain version and its bound: device time (CUDA graph replay) and time
   per call (CUDA events around calls from the host);
6. the kernels line, nvidia-smi's line, and the result line.

Any failed check raises, so the script exits non-zero and prints no
result line.  It needs one CUDA card and the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import functools
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
BAND_RTOL = 1e-5
CHUNK_SHAPE = (64, 4096, 63)   # the query path's chunk: chunk_events x T x V
RAGGED_SHAPE = (37, 1000, 63)
BRICK_SHAPE = (256, 4096, 63)  # one brick: what the lockstep steps are given
DEVICE = torch.device("cuda")
N_SCALARS = 64
TIMING_ROTATION = 16           # distinct inputs cycled so L2 stays cold
TIMING_ITERS = 48


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


def profile_serve(make_service):
    """Device time by kernel over one more run of the serve workload on a
    fresh service (the same scans), from torch.profiler; the profiler's
    own cost is in ``wall_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    svc = make_service()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_workload(svc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    svc.close()
    # device-side activities only (kernels, copies): a host op's device
    # time is its children's, so counting both would count it twice
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_s,
          "device_busy_share": busy_s / wall,
          "top": [{"name": key[:80], "device_ms": us / 1e3, "count": n}
                  for us, key, n in rows[:12]]})


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
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-events", type=int, default=8192,
                    help="events in the served store (default: 8192)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.event_filter import kernel as ef_kernel

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_device": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    ef_kernel.build()
    emit({"phase": "build", "sources": [ef_kernel.SOURCE.name],
          "build_s": time.perf_counter() - t0})

    # 3. kernels against their plain versions
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    rows = phase_kernels(gen)
    emit({"phase": "kernels", "cases": len(rows),
          "band_events": sum(r["band_events"] for r in rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows),
          "rows": rows})

    # 4. serve and lockstep (the main paths; launch counts read around
    # each)
    launches, widths = phase_serve(args.n_events)

    # 5. timing at the shapes the main path gave each kernel
    main_k = max(set(w for w in widths if w), key=widths.count)
    gen.manual_seed(1)
    timed = {
        "event_filter_batch": time_kernel("event_filter_batch", gen,
                                          CHUNK_SHAPE, main_k, 0),
        "event_filter": time_kernel("event_filter", gen,
                                    BRICK_SHAPE, 1, 0),
    }
    emit({"phase": "timing", "smi": smi,
          "event_filter_batch": {"shape": list(CHUNK_SHAPE), "k": main_k,
                                 **timed["event_filter_batch"]},
          "event_filter": {"shape": list(BRICK_SHAPE), "k": 1,
                           **timed["event_filter"]}})

    # 6. kernels line, nvidia-smi line, result line
    src = "src/repro_torch/kernels/event_filter/csrc/event_filter.cu"
    replaces = {"event_filter_batch": "src/repro/kernels/event_filter/"
                                      "kernel.py:178",
                "event_filter": "src/repro/kernels/event_filter/"
                                "kernel.py:225"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": timed[name]["max_abs_err"],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"],
         "bound_ms": timed[name]["bound_ms"],
         "bound_by": timed[name]["bound_by"], "library_ms": None}
        for name in ("event_filter_batch", "event_filter")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
