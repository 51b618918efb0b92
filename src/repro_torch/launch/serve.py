"""Serving launcher of the port: the multi-tenant GEPS query service.

``python -m repro_torch.launch.serve --mode query --backend spmd
--use-pallas`` stands up a brick store on the card, replays a
multi-tenant workload with repeats through a ``QueryService``, and
reports shared-scan amortization and cache hit rates.  ``--stream`` turns
every submission into a streamed ticket (per-packet prefix merges
mid-scan) and adds time-to-first-partial vs time-to-final to the report.

``--backend {sim,spmd}`` picks the execution backend: the virtual-time
grid simulation (default) or the chunked streaming scan over the
device-resident bricks; ``--use-pallas`` (spmd) runs in-family plan
targets through the fused ``event_filter`` CUDA kernel.  ``--device``
picks where the store lives and the scans run (default ``cuda``).

Not ported yet: ``--mode lm``, ``--fleet > 1``, ``--policy``,
``--trace-out``, ``--metrics-dump``, ``--flight-out`` and
``--autotune``; each exits with a message saying so.
"""
from __future__ import annotations

import argparse
import time

NOT_PORTED = "is not ported to repro_torch yet"


def _backend_kwargs(args):
    """Collect the SPMD performance knobs from the CLI into the
    ``backend_kwargs`` dict QueryService forwards to the backend
    constructor.  Returns None for the simulated backend — the knobs are
    scan-path concepts and passing them there should fail loudly, not
    silently no-op."""
    if args.backend != "spmd":
        for flag, name in ((args.use_pallas, "--use-pallas"),
                           (args.chunk_events, "--chunk-events"),
                           (args.adaptive_chunks, "--adaptive-chunks"),
                           (args.mesh_devices, "--mesh-devices")):
            if flag:
                raise SystemExit(
                    f"{name} requires --backend spmd (the simulation "
                    "has no kernel scan path)")
        return None
    kw = {}
    if args.use_pallas:
        kw["use_pallas"] = True
    if args.chunk_events is not None:
        kw["chunk_events"] = args.chunk_events
    if args.adaptive_chunks:
        kw["adaptive_chunks"] = True
    if args.mesh_devices is not None:
        kw["mesh_devices"] = args.mesh_devices
    return kw or None


def serve_queries(args):
    """Query-serving mode: multi-tenant traffic over the brick store.

    With ``--adaptive-window`` the service runs a virtual arrival clock at
    ``--arrival-rate`` q/s and lets the EWMA WindowController size each
    dispatch window against measured scan latency, instead of stepping
    every fixed ``--window`` submissions.  ``--cost-budget`` enables
    per-tenant cost-budgeted admission (planner cost units)."""
    from repro_torch.configs.geps_events import reduced as geps_reduced
    from repro_torch.core import events as ev
    from repro_torch.core.brick import create_store
    from repro_torch.service import (QueryScheduler, QueryService,
                                     WindowController)

    cfg = geps_reduced()
    schema = ev.EventSchema.from_config(cfg)
    store = create_store(schema, n_events=args.n_events,
                         n_nodes=args.n_nodes,
                         events_per_brick=cfg.events_per_brick,
                         replication=cfg.replication_factor, seed=0,
                         device=args.device)
    sched = QueryScheduler(
        max_batch=args.window,
        cost_budget_per_tenant=args.cost_budget)
    wc = clock = None
    if args.adaptive_window:
        # virtual clock: arrivals spaced 1/rate apart
        vnow = [0.0]
        clock = lambda: vnow[0]
        wc = WindowController(initial=args.window)
    svc = QueryService(store, scheduler=sched, window_controller=wc,
                       backend=args.backend,
                       backend_kwargs=_backend_kwargs(args),
                       device=args.device,
                       **({"clock": clock} if clock else {}))
    # multi-tenant workload: a few hot queries repeated across tenants
    # (the interactive-analysis regime) plus per-tenant near-duplicate
    # long-tail queries sharing aggregate fragments
    hot = ["e_total > 40 && count(pt > 15) >= 2",
           "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]
    t0 = time.time()
    sample_tid = None
    first_partial = {}  # ticket -> t_virtual of its FIRST published snapshot
    for i in range(args.queries):
        tenant = f"tenant{i % args.tenants}"
        if i % 3 != 2:
            expr = hot[i % len(hot)]
        else:
            expr = (f"e_total > {20 + (i % 7) * 10} && "
                    f"count(pt > 15) >= {1 + i % 4}")
        tid = svc.submit(expr, tenant=tenant, stream=args.stream)
        if args.stream:
            # record at publish time: the buffer conflates under
            # backpressure, so reading it later would miss early snapshots
            svc.stream(tid).subscribe(
                lambda s, t=tid: first_partial.setdefault(t, s.t_virtual))
        if sample_tid is None:
            sample_tid = tid
        if args.adaptive_window:
            vnow[0] += 1.0 / args.arrival_rate
            if svc.scheduler.n_pending >= wc.window():
                svc.step()
        elif (i + 1) % args.window == 0:
            svc.step()
    svc.drain()
    dt = time.time() - t0
    s = svc.stats
    scanned_per_query = s.events_scanned / max(1, s.served - s.cache_hits)
    print(f"query-service ({args.device}): {s.served}/{s.submitted} served "
          f"in {dt:.2f}s ({s.served / dt:.1f} q/s wall)")
    print(f"  batches={s.batches} jobs_run={s.jobs_run} "
          f"cache_hits={s.cache_hits} rejected={s.rejected}")
    print(f"  events_scanned={s.events_scanned} "
          f"(store={store.n_events} events; "
          f"{scanned_per_query:.0f} scanned/executed-query)")
    if s.fragment_evals:
        print(f"  planner: fragment_evals={s.fragment_evals} "
              f"vs unshared={s.fragment_evals_unshared} "
              f"({s.fragment_evals_unshared / s.fragment_evals:.2f}x "
              f"factored out), "
              f"fragment_cache_puts={svc.cache.stats.fragment_puts}")
    if svc.window_history and args.adaptive_window:
        print(f"  adaptive windows: {svc.window_history}")
    if args.stream:
        ratios = []
        for tid, stream in svc.streams.items():
            if not stream.done or stream.published < 2:
                continue  # cache hits stream a single final snapshot
            ratios.append(first_partial[tid] / stream.latest().t_virtual)
        if ratios:
            print(f"  streaming: {len(svc.streams)} streams, "
                  f"first-partial/final time ratio "
                  f"{sum(ratios) / len(ratios):.2f} "
                  f"(mean over {len(ratios)} scanned tickets)")
        sample = svc.streams.get(sample_tid)
        if sample is not None and sample.latest() is not None:
            snap = sample.latest()
            cov = snap.coverage
            print(f"  sample ticket {sample_tid}: {sample.published} "
                  f"snapshots ({sample.dropped} conflated), final coverage "
                  f"{cov.events_scanned}/{cov.events_total} events over "
                  f"{len(cov.bricks_seen)}/{cov.bricks_total} bricks")
    svc.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "query"), default="query",
                    help="query: the GEPS query service (lm "
                         f"{NOT_PORTED})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the brick store lives and scans run")
    ap.add_argument("--n-events", type=int, default=1024)
    ap.add_argument("--n-nodes", type=int, default=4)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--window", type=int, default=16,
                    help="submissions per dispatch window")
    ap.add_argument("--adaptive-window", action="store_true",
                    help="EWMA-controlled window width (arrival rate vs. "
                         "measured scan latency)")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="virtual arrivals/sec for --adaptive-window")
    ap.add_argument("--cost-budget", type=float, default=None,
                    help="per-tenant pending cost budget (planner units)")
    ap.add_argument("--stream", action="store_true",
                    help="progressive delivery: per-ticket ResultStreams "
                         "fed per-packet prefix merges mid-scan")
    ap.add_argument("--backend", choices=("sim", "spmd"), default="sim",
                    help="execution backend for dispatch windows: the "
                         "virtual-time grid simulation or the chunked "
                         "streaming scan over the device-resident bricks")
    ap.add_argument("--use-pallas", action="store_true",
                    help="spmd backend: run in-family plan targets "
                         "through the fused event_filter CUDA kernel "
                         "(its plain version with --device cpu)")
    ap.add_argument("--chunk-events", type=int, default=None, metavar="N",
                    help="spmd backend: events per scan chunk "
                         "(= streamed partial granularity)")
    ap.add_argument("--adaptive-chunks", action="store_true",
                    help="spmd backend: size chunks from measured scan "
                         "rate (EWMA ChunkController)")
    ap.add_argument("--mesh-devices", type=int, default=None, metavar="D",
                    help="spmd backend: lockstep emulation of a D-device "
                         "scan mesh")
    # options of the JAX package's launcher that have no port yet
    ap.add_argument("--fleet", type=int, default=1)
    ap.add_argument("--policy", action="store_true")
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH")
    ap.add_argument("--flight-out", default=None, metavar="PATH")
    ap.add_argument("--autotune", action="store_true")
    args = ap.parse_args(argv)

    if args.mode == "lm":
        raise SystemExit(f"--mode lm {NOT_PORTED}")
    for given, name in ((args.fleet > 1, "--fleet > 1"),
                        (args.policy, "--policy"),
                        (args.trace_out, "--trace-out"),
                        (args.metrics_dump, "--metrics-dump"),
                        (args.flight_out, "--flight-out"),
                        (args.autotune, "--autotune")):
        if given:
            raise SystemExit(f"{name} {NOT_PORTED}")
    serve_queries(args)


if __name__ == "__main__":
    main()
