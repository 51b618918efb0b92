"""Serving launcher of the port, with two modes.

``--mode lm``: batched prefill -> decode loop over the decode state of a
decoder LM (ring KV cache; dense, with experts or with pixtral's patch
front end), the encoder-decoder whisper (the ring plus the cross-attention
K/V), the hybrid recurrentgemma (RG-LRU state and a local-attention ring)
or xLSTM (matrix and scalar memories).  ``python -m
repro_torch.launch.serve --mode lm --arch qwen3-14b`` (or any other arch:
``pixtral-12b``, ``phi3.5-moe-42b-a6.6b``, ``whisper-medium``,
``recurrentgemma-9b``, ``xlstm-350m``, ...) builds the model at full
width with seeded random weights, generates ``--new-tokens`` for a
``--batch`` of random prompts, and prints tok/s and a sample;
``--reduced`` takes the tiny same-family config.  For whisper the stub
frames come from the same seeded generator, the encoder fills the
cross-attention cache, and the decode runs on that cache (the reference's
launcher decodes on a fresh zero cache, C-ref8).  On a CUDA device every
attention call launches the hand-written flash-attention kernel; the
recurrent families' decode steps are plain PyTorch, as in the reference.

``--mode query`` (default): ``python -m repro_torch.launch.serve --mode query --backend spmd
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

``--fleet N`` replaces the single QueryService with a coherence-fabric
:class:`~repro_torch.fabric.fleet.Fleet` of N front-ends over the one
store: submissions round-robin across the fleet, a shared L2 cache tier
and a fragment registry turn repeats into zero-I/O hits on any
front-end, a mid-run dataset bump shows the gossip invalidation bound,
and with ``--stream`` one sample ticket is read cross-front-end through
the bus fan-out.  ``--single-flight`` adds scan-intent leases and stream
adoption, ``--drop-rate`` and ``--bus-seed`` make the bus lossy and
seeded, ``--kill-node`` kills a grid node a third of the way in, and
``--flight-out`` writes the causal decision log that
``python -m repro_torch.obs.replay`` replays.

``--policy`` arms the failure-policy engine (``service/policy.py``) on
each front-end (with ``--fleet`` also gossip ack/repair);
``--trace-out`` and ``--metrics-dump`` turn the observability plane on
and write its span trace and metrics snapshot.  ``--autotune`` (spmd,
with ``--use-pallas``, on the card) sweeps the event_filter kernel's
launch shape per chunk shape class and prints the winner.

``--mode lm`` decodes on a (1, 1) mesh over ``("data", "model")`` of its
one device (:func:`lm_mesh`, ``launch/mesh.py``), whose ``Sharder``
every decode step gets; the port drives one card however many the host
has.  ``--production-mesh`` asks for the reference's 16 x 16 mesh:
``make_production_mesh`` raises with the CUDA device count this process
sees.  A mesh emulated on the one card (``make_mesh_of(...,
emulate=True)``), on which the decode attends through the grid-brick
cache, is asked for through the API.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


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
                           (args.mesh_devices, "--mesh-devices"),
                           (args.autotune, "--autotune")):
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
    if args.autotune:
        kw["autotune"] = True
    return kw or None


def _print_autotune(backends):
    """The report's autotune lines: each backend's last verdict (a fleet's
    front-ends share the in-process cache, so a shape class is swept once,
    but their last windows may be of different classes)."""
    for i, backend in enumerate(backends):
        tuned = getattr(backend, "last_autotune", None)
        if tuned is None:
            print(f"  autotune[fe{i}]: no kernel window swept")
            continue
        times = ", ".join(f"{t}: {ms:.4f} ms" for t, ms in tuned.measurements)
        print(f"  autotune[fe{i}]: {tuned.threads} threads a block "
              f"(default {tuned.default_ms:.4f} ms, best {tuned.best_ms:.4f} "
              f"ms, x{tuned.speedup_vs_default:.3f}; {times})")


def _dump_trace(records, path):
    """Write trace records to ``path``: JSONL for ``.jsonl``, Chrome-trace
    JSON (Perfetto-loadable) otherwise."""
    from repro_torch.obs import trace as trace_lib
    if str(path).endswith(".jsonl"):
        trace_lib.save_jsonl(records, path)
    else:
        trace_lib.save_chrome(records, path)
    print(f"  trace: {len(records)} records -> {path}")


def _dump_metrics(snapshot, path):
    """Write a metrics snapshot: Prometheus text exposition format for
    ``.prom`` paths, JSON otherwise."""
    with open(path, "w") as f:
        if str(path).endswith(".prom"):
            f.write(snapshot.to_prom_text())
        else:
            json.dump(snapshot.to_dict(), f, indent=2, sort_keys=True)
    print(f"  metrics: {len(snapshot.metrics)} series -> {path}")


def _query_store(args):
    """The reduced event schema's brick store on ``--device``."""
    from repro_torch.configs.geps_events import reduced as geps_reduced
    from repro_torch.core import events as ev
    from repro_torch.core.brick import create_store
    cfg = geps_reduced()
    store = create_store(ev.EventSchema.from_config(cfg),
                         n_events=args.n_events, n_nodes=args.n_nodes,
                         events_per_brick=cfg.events_per_brick,
                         replication=cfg.replication_factor, seed=0,
                         device=args.device)
    return cfg, store


def serve_fleet(args):
    """Fleet serving mode: the multi-tenant workload of ``serve_queries``
    replayed round-robin over ``--fleet N`` coherence-fabric front-ends.
    Reports fleet-aggregate hit rates (incl. the shared-L2 contribution),
    the gossip propagation bound, registry pre-warming, and — with
    ``--stream`` — a cross-frontend proxy read of one sample ticket."""
    from repro_torch.fabric import Fleet, FragmentRegistry, MessageBus
    from repro_torch.obs import flight as flight_lib

    cfg, store = _query_store(args)
    want_obs = bool(args.trace_out or args.metrics_dump or args.policy)
    bus = MessageBus(drop_rate=args.drop_rate, seed=args.bus_seed)
    recorder = None
    if args.flight_out:
        # the store_config record makes the log self-contained: replay
        # (python -m repro_torch.obs.replay) rebuilds an equal store from it
        recorder = flight_lib.FlightRecorder()
        recorder.record("store_config", origin="serve",
                        schema_name="geps_reduced", n_events=args.n_events,
                        n_nodes=args.n_nodes,
                        events_per_brick=cfg.events_per_brick,
                        replication=cfg.replication_factor, seed=0)
    fleet = Fleet(store, args.fleet, bus=bus, registry=FragmentRegistry(),
                  backend=args.backend, backend_kwargs=_backend_kwargs(args),
                  obs=want_obs,
                  policy=args.policy, gossip_repair=args.policy,
                  single_flight=args.single_flight,
                  flight=recorder if recorder is not None else False,
                  device=args.device)
    hot = ["e_total > 40 && count(pt > 15) >= 2",
           "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]
    t0 = time.time()
    sample = None
    for i in range(args.queries):
        tenant = f"tenant{i % args.tenants}"
        if i % 3 != 2:
            # hot index advances slower than the submit round-robin, so
            # consecutive submissions of the same hot query land on
            # DIFFERENT front-ends in the same window — the same-window
            # duplicate-scan race single-flight leases exist to close
            expr = hot[(i // 3) % len(hot)]
        else:
            expr = (f"e_total > {20 + (i % 7) * 10} && "
                    f"count(pt > 15) >= {1 + i % 4}")
        gtid = fleet.submit(expr, tenant=tenant, stream=args.stream)
        if sample is None:
            sample = gtid
        if (i + 1) % args.window == 0:
            fleet.step()
        if args.kill_node is not None and i == args.queries // 3:
            # mid-run grid-node death: failover + liveness gossip (and,
            # when recording, the event the replay must reproduce)
            fleet.node_leave(args.kill_node)
        if args.queries > 2 and i == args.queries // 2:
            # mid-run dataset bump on one member: gossip invalidates the
            # whole fleet within the documented bound
            fleet.bump_dataset_version(0)
    fleet.drain()
    dt = time.time() - t0
    s = fleet.fleet_stats()
    print(f"fleet ({args.device}): {args.fleet} front-ends, "
          f"{s['served']}/{s['submitted']} served in {dt:.2f}s "
          f"({s['served'] / max(dt, 1e-9):.1f} q/s)")
    print(f"  hit_rate={s['hit_rate']:.3f} (cache_hits={s['cache_hits']}, "
          f"of which l2_hits={s['l2_hits']}), "
          f"events_scanned={s['events_scanned']}")
    if args.single_flight:
        print(f"  single-flight: adopted={s['adopted']} tickets rode a "
              f"remote lease owner's stream "
              f"(fallbacks={s['lease_fallbacks']})")
    print(f"  gossip: bound={fleet.rounds_bound} rounds "
          f"(fanout={fleet.gossip_fanout}), epochs="
          f"{[fe.catalog.dataset_epoch for fe in fleet.frontends]}")
    if fleet.l2 is not None:
        print(f"  shared L2: {len(fleet.l2)} entries, "
              f"{fleet.l2.stats.hits} hits, "
              f"{fleet.l2.stats.fragment_puts} fragment installs")
    if fleet.registry is not None:
        print(f"  registry: {len(fleet.registry)} fragments tracked, "
              f"hot={fleet.registry.hot(4)}")
    if args.policy:
        # one line is enough: the front-ends' views converge via gossip
        fe_id, states = next(iter(fleet.policy_states().items()))
        bad = {n: st for n, st in states.items() if st != "ok"}
        print(f"  policy[{fe_id}]: {bad if bad else 'all nodes ok'} "
              f"(gossip repair: "
              f"{fleet.frontends[0].gossip.stats.repairs} repairs)")
    if args.stream and sample is not None:
        owner_idx = fleet.owner_of(sample)
        reader = (owner_idx + 1) % args.fleet
        proxy = fleet.stream(sample, frontend=reader)
        fleet.drain()
        print(f"  cross-frontend stream: ticket {sample} (owner fe"
              f"{owner_idx}) read from fe{reader}: {proxy.published} "
              f"snapshots, state={proxy.state}")
    if args.trace_out:
        _dump_trace(fleet.trace_records(), args.trace_out)
    if args.metrics_dump:
        _dump_metrics(fleet.metrics_snapshot(), args.metrics_dump)
    if args.autotune:
        _print_autotune([fe.service.backend for fe in fleet.frontends])
    if args.flight_out:
        n = fleet.save_flight(args.flight_out)
        print(f"  flight: {n} records -> {args.flight_out} (replay: "
              f"python -m repro_torch.obs.replay {args.flight_out} "
              f"--device {args.device})")
    fleet.close()


def prefill_into_cache(cfg, model, params, cache, tokens, shd=None):
    """Feed a prompt through decode steps to fill the ring cache (token by
    token, as the reference does for correctness and small prompts)."""
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                          shd)
    return logits, cache


@torch.inference_mode()
def generate(cfg, model, params, prompt, max_new_tokens=16, cache_len=256,
             cache=None, shd=None):
    """Greedy generation: prompt (B, P) int64 -> (B, max_new_tokens) token
    ids, on the prompt's device.  ``cache`` is the decode state to start
    from (for whisper, one whose cross-attention K/V
    :func:`encoder_cache` filled); None starts from a fresh
    ``model.init_cache(B, cache_len)``.  ``shd`` is the mesh's Sharder
    every decode step gets (None: the one-card path)."""
    b = prompt.shape[0]
    if cache is None:
        cache = model.init_cache(b, cache_len, prompt.device)
    logits, cache = prefill_into_cache(cfg, model, params, cache, prompt,
                                       shd)
    out = []
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
    for _ in range(max_new_tokens):
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok, shd)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size],
                           dim=-1).reshape(b, 1)
    return torch.cat(out, dim=1)


@torch.inference_mode()
def encoder_cache(cfg, model, params, batch, generator, cache_len=256):
    """An encoder-decoder's decode state for ``batch`` stub inputs: frame
    embeddings (B, S_enc, d) drawn from ``generator`` (standard normal,
    in cfg.dtype, on the generator's device), run through the encoder into
    the cross-attention K/V of a fresh cache.  Returns (cache, frames)."""
    from repro_torch.models import encdec
    from repro_torch.models.params import torch_dtype
    device = generator.device
    frames = torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                         generator=generator, device=device).to(
                             torch_dtype(cfg.dtype))
    cache = model.init_cache(batch, cache_len, device)
    return encdec.prefill_cross_cache(cfg, params, frames, cache), frames


def lm_mesh(device, production: bool = False):
    """The mesh ``--mode lm`` decodes on: with ``production`` the
    reference's 16 x 16 mesh, which ``make_production_mesh`` refuses with
    the CUDA device count, else a (1, 1) mesh of ``device``, however many
    devices the host has (a real mesh of several cards is outside the
    one-card port)."""
    from repro_torch.launch.mesh import make_mesh_of, make_production_mesh
    if production:
        return make_production_mesh()
    return make_mesh_of((1, 1), ("data", "model"), device=device)


def serve_lm(args):
    """LM mode: build the model on ``--device`` with weights drawn from a
    seeded generator, generate for random prompts, report tok/s."""
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.kernels import resolve_device
    from repro_torch.models import model_zoo
    from repro_torch.parallel.sharding import Sharder

    if args.arch is None:
        raise SystemExit("--arch is required for --mode lm")
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else \
        get_config(args.arch)
    shd = Sharder(cfg, lm_mesh(device, production=args.production_mesh))
    model = model_zoo.build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    lm = model_zoo.LanguageModel(model, model.table.init(gen, device))
    params = lm.tree()
    cache = None
    t0 = time.time()
    if cfg.is_encoder_decoder:
        # fill the cross-attention cache from stub frames first, and
        # decode on it (C-ref8: the reference's launcher fills one cache
        # and then generates on a fresh zero one)
        gen.manual_seed(1)
        cache, _ = encoder_cache(cfg, model, params, args.batch, gen)
    gen.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    tokens = generate(cfg, model, params, prompt,
                      max_new_tokens=args.new_tokens, cache=cache, shd=shd)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"arch={cfg.name} ({device}) generated {tuple(tokens.shape)} in "
          f"{dt:.1f}s ({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("sample:", tokens[0, :12].tolist())
    return tokens


def serve_queries(args):
    """Query-serving mode: multi-tenant traffic over the brick store.

    With ``--adaptive-window`` the service runs a virtual arrival clock at
    ``--arrival-rate`` q/s and lets the EWMA WindowController size each
    dispatch window against measured scan latency, instead of stepping
    every fixed ``--window`` submissions.  ``--cost-budget`` enables
    per-tenant cost-budgeted admission (planner cost units)."""
    from repro_torch.service import (QueryScheduler, QueryService,
                                     WindowController)

    _, store = _query_store(args)
    sched = QueryScheduler(
        max_batch=args.window,
        cost_budget_per_tenant=args.cost_budget)
    wc = clock = None
    if args.adaptive_window:
        # virtual clock: arrivals spaced 1/rate apart
        vnow = [0.0]
        clock = lambda: vnow[0]
        wc = WindowController(initial=args.window)
    obs = None
    if args.trace_out or args.metrics_dump or args.policy:
        from repro_torch.obs import Observability
        obs = Observability(origin="fe0")
    policy = catalog = None
    if args.policy:
        # the policy and the service must judge node liveness from the
        # SAME catalogue, so build it here and hand it to both
        from repro_torch.core.catalog import MetadataCatalog
        from repro_torch.service.policy import FailurePolicy
        catalog = MetadataCatalog(store.n_nodes)
        policy = FailurePolicy(catalog, store, obs=obs)
    svc = QueryService(store, catalog, scheduler=sched, window_controller=wc,
                       backend=args.backend,
                       backend_kwargs=_backend_kwargs(args),
                       obs=obs, policy=policy, device=args.device,
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
    if args.autotune:
        _print_autotune([svc.backend])
    if policy is not None:
        bad = {n: st for n, st in policy.states().items() if st != "ok"}
        print(f"  policy: {bad if bad else 'all nodes ok'} "
              f"(speculation {'on' if policy.config.speculate else 'off'})")
    if obs is not None:
        if args.trace_out:
            _dump_trace(obs.tracer.records(), args.trace_out)
        if args.metrics_dump:
            _dump_metrics(obs.metrics.snapshot(), args.metrics_dump)
    svc.close()


def main(argv=None):
    from repro_torch.configs.registry import list_archs
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "query"), default="query",
                    help="query: the GEPS query service; lm: generation "
                         "with a dense, hybrid or xLSTM LM")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model or the brick store lives and "
                         "the work runs")
    # lm mode
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    # query mode
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
    ap.add_argument("--fleet", type=int, default=1,
                    help="number of coherence-fabric front-ends (1 = a "
                         "single QueryService)")
    ap.add_argument("--single-flight", action="store_true",
                    help="with --fleet: scan-intent leases + in-flight "
                         "stream adoption (fabric/leases.py) — N "
                         "duplicate scans become 1 scan + N-1 zero-I/O "
                         "stream subscriptions")
    ap.add_argument("--policy", action="store_true",
                    help="enable the failure-policy engine (node state "
                         "machine, routing avoidance, speculative "
                         "re-execution, proactive re-replication; with "
                         "--fleet also gossip ack/repair)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable the observability plane and write the "
                         "span trace to PATH (.jsonl = JSONL records, "
                         "anything else = Chrome-trace JSON)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="enable the observability plane and write the "
                         "(fleet-merged) metrics snapshot to PATH (.prom "
                         "= Prometheus text exposition, anything else = "
                         "JSON)")
    ap.add_argument("--flight-out", default=None, metavar="PATH",
                    help="with --fleet: arm the flight recorder and write "
                         "the causal decision log as JSONL to PATH; "
                         "replay with 'python -m repro_torch.obs.replay "
                         "PATH'")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="with --fleet: seeded message-loss probability "
                         "on every bus link")
    ap.add_argument("--bus-seed", type=int, default=0,
                    help="with --fleet: RNG seed for the bus loss draw")
    ap.add_argument("--kill-node", type=int, default=None, metavar="N",
                    help="with --fleet: kill grid node N a third of the "
                         "way through the workload (failover + liveness "
                         "gossip)")
    ap.add_argument("--autotune", action="store_true",
                    help="spmd backend with --use-pallas: sweep the "
                         "event_filter kernel's launch shape (threads a "
                         "block) per chunk shape class and launch every "
                         "kernel chunk with the winner (CUDA only)")
    args = ap.parse_args(argv)

    if args.mode == "lm":
        return serve_lm(args)
    if args.fleet > 1:
        serve_fleet(args)
    else:
        serve_queries(args)


if __name__ == "__main__":
    main()
