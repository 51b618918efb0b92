"""Multi-tenant query front-end over the JSE/brick substrate.

The flow per dispatch window::

    submit(expr, tenant) --admission--> scheduler queues (per tenant,
                       |                count caps + cost budgets)
                       \\--cache hit--> answered with zero brick I/O
    step(): window = scheduler.next_batch()        (fairness + coalescing +
                                                    window-cost bounding)
            dedup identical canonical queries      (one execution, fan-out)
            planner.plan_window(uniques)           (fragment factoring +
                                                    materialization policy)
            backend.run_batch(jobs, plan=plan)     (ONE shared scan —
                                                    simulated grid OR SPMD
                                                    chunked shard scan,
                                                    each unique fragment
                                                    evaluated once/packet)
            results -> cache (queries AND shared fragments), tickets,
            catalog; WindowController observes scan latency and retunes
            scheduler.max_batch for the next window

The execution backend is pluggable (``core/backend.py``): the service
programs only against ``ExecutionBackend.run_batch``, so streaming, cache
write-through, cost-model calibration and window planning behave
identically whether the window runs on the virtual-time grid simulation
or as an SPMD chunked scan over the brick shards.

    streamed tickets additionally get per-packet prefix merges published
    into their ResultStream DURING the scan (service/streaming.py), with
    a final snapshot bit-identical to the batch result.

Everything lands in the existing ``MetadataCatalog`` job records (tenant +
batch id included), so failover, stragglers and persistence keep working
unchanged underneath the service.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import merge as merge_lib
from repro_torch.core.brick import BrickStore
from repro_torch.core.catalog import DONE, FAILED, MetadataCatalog
from repro_torch.core.jse import TimeModel
from repro_torch.service import planner as planner_lib
from repro_torch.service import streaming as streaming_lib
from repro_torch.service.cache import ResultCache
from repro_torch.service.scheduler import (AdmissionError, QueryScheduler,
                                           Submission, make_submission)

QUEUED, SERVED, REJECTED = "QUEUED", "SERVED", "REJECTED"


@dataclasses.dataclass
class Ticket:
    """Per-submission record a tenant polls via ``QueryService.result``.

    ``status`` moves QUEUED -> SERVED/REJECTED/FAILED; ``note`` carries the
    rejection/failure reason; ``from_cache`` marks zero-I/O answers and
    ``adopted`` answers taken from another front-end's in-flight lease
    stream (single-flight execution — also zero local I/O)."""
    ticket_id: int
    tenant: str
    expr: str
    calib_iters: int
    status: str = QUEUED
    job_id: int = -1
    batch_id: int = -1
    from_cache: bool = False
    result: Optional[merge_lib.QueryResult] = None
    note: str = ""
    streamed: bool = False  # progressive delivery via QueryService.stream()
    adopted: bool = False   # resolved from a remote lease owner's stream


@dataclasses.dataclass
class ServiceStats:
    """Service-lifetime counters (monotonic; see also ``ResultCache.stats``
    and the per-window history in ``QueryService.window_history``)."""
    submitted: int = 0
    served: int = 0
    rejected: int = 0
    cache_hits: int = 0
    batches: int = 0
    jobs_run: int = 0
    events_scanned: int = 0
    # planner accounting: unique-fragment evaluations actually performed
    # vs. what K independent per-query compiles would have performed
    # (fragment-cache installs are counted by ResultCache.stats)
    fragment_evals: int = 0
    fragment_evals_unshared: int = 0
    # single-flight accounting: tickets resolved by adopting a remote
    # lease owner's stream, and adoptions that had to fall back (owner
    # death/ban/epoch bump — resolved from cache or by rescanning)
    adopted: int = 0
    lease_fallbacks: int = 0


class WindowController:
    """EWMA controller for dispatch-window width.

    The queueing sweet spot for a batching server: a window should be
    about as wide as the number of arrivals during one scan, ``w = λ·L``
    (arrival rate x scan latency).  Narrower windows waste sweeps on
    near-empty batches; wider windows add queueing delay without extra
    amortization.  The controller tracks an EWMA of submission
    inter-arrival gaps and of observed scan latencies and proposes
    ``clamp(round(λ·L), min_window, max_window)``.

    Arrival timestamps and scan latencies must share ONE clock.  The
    simulated service feeds virtual-time scan makespans, so drive arrivals
    with a virtual clock too (``QueryService(clock=...)``); a wall-clock
    deployment feeds wall-clock latencies instead.

    ``hysteresis`` is a relative dead-band on the output: the held window
    only moves when the proposal differs from it by more than
    ``hysteresis x current``.  Under square-wave (bursty) arrivals the
    raw EWMA proposal straddles two widths and flaps every window —
    resizing churn with no amortization gain; the dead-band holds the
    width until the demand shift is real.  ``hysteresis=0`` reproduces
    the raw controller exactly.
    """

    def __init__(self, *, initial: int = 16, min_window: int = 1,
                 max_window: int = 256, alpha: float = 0.3,
                 hysteresis: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if not (1 <= min_window <= max_window):
            raise ValueError("need 1 <= min_window <= max_window")
        if hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        self.initial = initial
        self.min_window = min_window
        self.max_window = max_window
        self.alpha = alpha
        self.hysteresis = hysteresis
        self._interarrival: Optional[float] = None
        self._latency: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._held: Optional[int] = None

    def observe_arrival(self, t: float):
        """Record one submission at time ``t`` (controller clock units)."""
        if self._last_arrival is not None:
            gap = max(0.0, t - self._last_arrival)
            if self._interarrival is None:
                self._interarrival = gap
            else:
                self._interarrival = (self.alpha * gap
                                      + (1 - self.alpha) * self._interarrival)
        self._last_arrival = t

    def observe_scan(self, latency_s: float):
        """Record one dispatch window's measured scan latency."""
        if latency_s <= 0:
            return
        if self._latency is None:
            self._latency = latency_s
        else:
            self._latency = (self.alpha * latency_s
                             + (1 - self.alpha) * self._latency)

    @property
    def arrival_rate(self) -> Optional[float]:
        """Smoothed arrivals/second, or None before two arrivals."""
        if self._interarrival is None:
            return None
        return 1.0 / max(self._interarrival, 1e-9)

    @property
    def scan_latency(self) -> Optional[float]:
        """Smoothed scan latency (seconds), or None before one window."""
        return self._latency

    def window(self) -> int:
        """Window width for the next dispatch: the clamped ``λ·L``
        proposal, filtered through the hysteresis dead-band."""
        lam, lat = self.arrival_rate, self.scan_latency
        if lam is None or lat is None:
            target = max(self.min_window,
                         min(self.max_window, self.initial))
        else:
            target = max(self.min_window,
                         min(self.max_window, round(lam * lat)))
        if self._held is None or \
                abs(target - self._held) > self.hysteresis * self._held:
            self._held = target
        return self._held


@dataclasses.dataclass
class _Adoption:
    # one in-flight single-flight adoption: the dequeued submissions of a
    # canonical group riding a remote lease owner's proxied stream
    key: str
    owner: str
    subs: List[Submission]
    proxy: streaming_lib.ResultStream
    epoch: int
    fp: str
    adopted_round: int = 0   # bus round the adoption was made
    last_published: int = 0  # proxy progress at the last stall check
    checked_round: int = 0   # bus round of the last stall check


class QueryService:
    """Multi-tenant query service: tickets in, shared scans underneath.

    Public API: :meth:`submit` (admission + cache probe), :meth:`step`
    (one dispatch window), :meth:`drain` (windows until idle),
    :meth:`result` (ticket lookup), :meth:`stream` (progressive
    partial-merge delivery for tickets submitted with ``stream=True``).

    Parameters
    ----------
    store / catalog:
        The brick-sharded event store and the metadata catalogue (one is
        created when not supplied).
    backend:
        The execution backend dispatch windows run on: ``"sim"`` (the
        virtual-time grid simulation, default), ``"spmd"`` (the chunked
        streaming scan over brick shards), or a pre-built
        :class:`~repro_torch.core.backend.ExecutionBackend` instance — which
        must be constructed over this service's ``store``; its catalogue
        is adopted when ``catalog`` is not passed and must match when it
        is.  Every service feature (streaming, caching, cost admission,
        window planning, telemetry refits) routes through the backend
        contract, so behaviour is backend-agnostic by construction.
    cache / scheduler:
        Injectable :class:`ResultCache` / :class:`QueryScheduler`; pass a
        scheduler with cost budgets for cost-based admission.
    window_controller:
        Optional :class:`WindowController`; when present the service feeds
        it arrival timestamps (from ``clock``) and per-window virtual scan
        makespans, and retunes ``scheduler.max_batch`` before each window.
    clock:
        Timestamp source for arrival telemetry (default
        ``time.monotonic``).  Use a virtual clock when replaying traffic
        so arrivals and the simulator's makespans share units.
    planner_materialize:
        Cache shared boolean fragments of each window as first-class
        results (fragment-level cache entries).
    stream_capacity:
        Buffer depth of each per-ticket
        :class:`~repro_torch.service.streaming.ResultStream` (see
        ``submit(stream=True)`` / :meth:`stream`).
    registry:
        Optional :class:`~repro_torch.fabric.registry.FragmentRegistry`: every
        window's plan is observed into it and seeds the next window's
        interner with cross-window hot fragments (fabric pre-warming).
    refit_cost_every:
        Every K dispatch windows, refit the admission cost model from
        accumulated per-packet compute telemetry
        (:func:`~repro_torch.service.planner.fit_cost_weights`); ``None``
        keeps the static cold-start weights forever.
    stream_ramp:
        When a window has stream subscribers, cap its first packets at
        this many events (growing geometrically — see
        :class:`~repro_torch.core.packets.AdaptivePacketScheduler`), so
        time-to-first-partial stays small WITHOUT disabling
        PROOF-adaptive sizing for the rest of the scan.  ``None``
        disables the ramp.
    frontend_id:
        Stable identity of this front-end inside a fleet (fabric gossip
        and stream fan-out address it by this id).
    backend_kwargs:
        Extra constructor kwargs for a string-selected backend — the
        SPMD performance knobs (``use_pallas``, ``chunk_events``,
        ``adaptive_chunks``, ``mesh_devices``, ``double_buffer``) or
        simulation extras (``adaptive_packets``).  Rejected alongside a
        pre-built backend instance, same as ``time_model``.
    obs:
        Optional :class:`repro_torch.obs.Observability` bundle (a
        :class:`~repro_torch.fabric.fleet.Fleet` built with ``obs=True``
        gives each front-end its own).  When present the service traces
        every ticket (submit/window/plan/dispatch/per-packet/stream/final
        spans on one deterministic virtual timeline), records the metric
        catalog of ``docs/observability.md``, feeds the per-node health
        monitor, and installs the bundle on the execution backend and
        scheduler.  ``None`` (default) disables the whole plane — every
        instrumentation site is one ``is not None`` test.
    policy:
        Optional :class:`repro_torch.service.policy.FailurePolicy` over
        the service's catalogue: one decision per window, from the
        health monitor's report when ``obs`` is on (else from node
        liveness alone), applied as routing, speculation and
        re-replication on a backend that supports them (the sim
        backend).  ``None`` (default) disables it.
    leases:
        Optional :class:`repro_torch.fabric.leases.LeaseManager`: scan
        intents announced at submit, duplicate scans adopted from the
        lease owner's stream (a fleet built with ``single_flight=True``
        installs one per front-end).
    device:
        Where the scans run (default ``"cuda"``): the store must live
        there, and a string-selected backend is built for it.  Asking
        for ``"cuda"`` without a CUDA device raises ``RuntimeError``.
    """

    #: sliding-window size of retained per-packet telemetry observations
    #: (cost refits only need recent history)
    TELEMETRY_WINDOW = 4096

    def __init__(self, store: BrickStore,
                 catalog: Optional[MetadataCatalog] = None, *,
                 backend: Union[str, "backend_lib.ExecutionBackend",
                                None] = None,
                 cache: Optional[ResultCache] = None,
                 scheduler: Optional[QueryScheduler] = None,
                 time_model: Optional[TimeModel] = None,
                 node_speed: Optional[Dict[int, float]] = None,
                 use_cache: bool = True,
                 window_controller: Optional[WindowController] = None,
                 clock: Callable[[], float] = time.monotonic,
                 planner_materialize: bool = True,
                 stream_capacity: int = 32,
                 registry=None,
                 refit_cost_every: Optional[int] = None,
                 stream_ramp: Optional[int] = None,
                 frontend_id: str = "fe0",
                 obs=None,
                 policy=None,
                 leases=None,
                 backend_kwargs: Optional[Dict[str, object]] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.store = store
        self.device = store.check_device(device)
        if backend is not None and not isinstance(backend, str):
            # instance backend: it owns a catalogue/store pair already
            if backend.store is not store:
                raise ValueError(
                    "backend was built over a different brick store")
            if catalog is None:
                catalog = backend.catalog
            elif backend.catalog is not catalog:
                raise ValueError(
                    "backend and service must share one catalogue")
        self.catalog = catalog or MetadataCatalog(store.n_nodes)
        if backend is None or isinstance(backend, str):
            kind = backend or "sim"
            if kind != "sim" and (time_model is not None
                                  or node_speed is not None):
                raise ValueError(
                    "time_model/node_speed are simulation knobs; the "
                    f"{kind!r} backend would silently ignore them")
            kwargs = ({"time_model": time_model, "node_speed": node_speed}
                      if kind == "sim" else {})
            kwargs["device"] = self.device
            # performance knobs (use_pallas/interpret/chunk_events/
            # mesh_devices/autotune/...) pass straight through to the
            # chosen backend's constructor
            kwargs.update(backend_kwargs or {})
            backend = backend_lib.make_backend(kind, self.catalog, store,
                                               **kwargs)
        elif time_model is not None or node_speed is not None:
            raise ValueError(
                "pass time_model/node_speed when constructing the "
                "backend, not alongside a pre-built instance")
        elif backend_kwargs:
            raise ValueError(
                "pass backend tuning kwargs when constructing the "
                "backend, not alongside a pre-built instance")
        self.backend = backend
        # back-compat handle for simulation-tuning callers (None on
        # non-simulated backends)
        self.jse = getattr(backend, "engine", None)
        # `is not None`, NOT truthiness: an empty injected cache is falsy
        # (it has __len__) and must not be silently replaced
        self.cache = (cache if cache is not None
                      else ResultCache(catalog=self.catalog))
        self.scheduler = (scheduler if scheduler is not None
                          else QueryScheduler())
        if self.scheduler.backend is None:
            # the scheduler recosts queued submissions against the
            # backend's calibrated cost weights when bounding windows
            self.scheduler.backend = self.backend
        self.use_cache = use_cache
        self.window_controller = window_controller
        self.clock = clock
        self.planner_materialize = planner_materialize
        self.stream_capacity = stream_capacity
        self.registry = registry
        self.refit_cost_every = refit_cost_every
        self.stream_ramp = stream_ramp
        self.frontend_id = frontend_id
        self.cost_weights: Optional[planner_lib.CostWeights] = None
        self.tickets: Dict[int, Ticket] = {}
        self.streams: Dict[int, streaming_lib.ResultStream] = {}
        self.stats = ServiceStats()
        self.window_history: List[int] = []  # max_batch used per window
        self._telemetry: List = []  # per-packet compute, for cost refits
        self._next_ticket = 0
        self._next_batch = 0
        self._closed = False
        # observability plane: install the bundle on the execution
        # backend (per-packet spans/health) and the scheduler (advisory
        # health hints); the service's own virtual timeline accumulates
        # window makespans so every span shares one deterministic axis
        self.obs = obs
        self._virtual_now = 0.0
        self._stream_spans: Dict[int, object] = {}
        if obs is not None:
            if getattr(self.backend, "obs", "missing") is None:
                self.backend.obs = obs
            if getattr(self.scheduler, "obs", "missing") is None:
                self.scheduler.obs = obs
        # failure policy (service/policy.py): decided before each window
        # (routing avoidance + speculation on capable backends), resolved
        # after it (probe outcomes); the scheduler narrows admission by
        # the routable fraction
        self.policy = policy
        if policy is not None and \
                getattr(self.scheduler, "policy", "missing") is None:
            self.scheduler.policy = policy
        # single-flight leases (fabric/leases.py): scan intents are
        # announced at admission, remote leases adopted at dispatch, and
        # adoptions resolved by poll_adoptions (the Fleet pumps it).
        # None (standalone service / single_flight off) disables every
        # lease site, exactly like obs/policy.
        self.leases = leases
        self._adoptions: Dict[str, _Adoption] = {}
        if leases is not None and \
                getattr(self.scheduler, "leases", "missing") is None:
            # adopted submissions cost ~0 against window budgets
            self.scheduler.leases = leases

    # ------------------------------------------------------------------ #
    def submit(self, expr: str, *, tenant: str = "default",
               calib_iters: int = 0, stream: bool = False) -> int:
        """Accept (or reject) one query; returns a ticket id.

        Admission: the expression is validated and costed
        (``planner.estimate_cost`` over the store size), then checked
        against the scheduler's count caps and cost budgets.  Cache hits
        are answered immediately — the catalog still gets a job record
        (marked DONE, zero events processed) so the tenant's history is
        complete.  Rejections surface as ticket status REJECTED with the
        reason in ``note``; nothing raises.

        With ``stream=True`` the ticket additionally gets a
        :class:`~repro_torch.service.streaming.ResultStream` (read it via
        :meth:`stream`): the dispatch window publishes an exact prefix
        merge + coverage after every packet, and the final snapshot is
        bit-identical to the batch result.  A cache hit streams a single
        final snapshot; a rejection aborts the stream with the reason."""
        tid = self._next_ticket
        self._next_ticket += 1
        ticket = Ticket(tid, tenant, expr, calib_iters, streamed=stream)
        self.tickets[tid] = ticket
        self.stats.submitted += 1
        obs = self.obs
        span = None
        if obs is not None:
            span = obs.tracer.begin("submit", t_virtual=self._virtual_now,
                                    ticket=tid, tenant=tenant,
                                    stream=stream)
        rs = None
        if stream:
            rs = streaming_lib.ResultStream(tid,
                                            capacity=self.stream_capacity)
            self.streams[tid] = rs
            if obs is not None:
                # the stream span lives until the stream closes (finish
                # OR abort — the on_close hook covers every path, so an
                # aborted stream can never leak an open span)
                self._stream_spans[tid] = obs.tracer.begin(
                    "stream", t_virtual=self._virtual_now, ticket=tid,
                    parent=span)
                rs.on_close(self._close_stream_span)
        try:
            sub = make_submission(tid, tenant, expr, calib_iters,
                                  self.store.schema,
                                  n_events=self.store.n_events,
                                  stream=stream,
                                  weights=self.cost_weights)
        except AdmissionError as e:
            ticket.status = REJECTED
            ticket.note = str(e)
            self.stats.rejected += 1
            if rs is not None:
                rs.abort(str(e))
            if obs is not None:
                obs.metrics.counter("submit.rejected").inc()
                obs.tracer.end(span, t_virtual=self._virtual_now,
                               status="error", note=str(e))
            return tid

        if self.use_cache:
            l2_before = self.cache.stats.l2_hits
            hit = self.cache.get(expr, calib_iters,
                                 self.catalog.dataset_epoch,
                                 canonical=sub.canonical)
            if hit is not None:
                jid = self.catalog.submit(expr, calib_iters,
                                          tuple(sorted(self.store.bricks)),
                                          tenant=tenant)
                self.catalog.update(jid, status=DONE, note="cache-hit",
                                    result={"n_selected": hit.n_selected,
                                            "n_processed": hit.n_processed,
                                            "sum_var": hit.sum_var})
                ticket.status = SERVED
                ticket.job_id = jid
                ticket.from_cache = True
                ticket.result = hit
                self.stats.served += 1
                self.stats.cache_hits += 1
                if rs is not None:
                    # zero-I/O answer: one final snapshot, complete coverage
                    rs.finish(streaming_lib.StreamSnapshot(
                        seq=0, result=hit,
                        coverage=merge_lib.Coverage(
                            events_scanned=hit.n_processed,
                            events_total=hit.n_processed),
                        t_virtual=0.0, final=True))
                if obs is not None:
                    # a cache hit is still a complete (short) ticket
                    # trace: tier-attributed metric, closed submit span,
                    # final event — never a telemetry bypass
                    tier = ("l2" if self.cache.stats.l2_hits > l2_before
                            else "l1")
                    obs.metrics.counter(f"cache.hits_{tier}").inc()
                    # a cache hit is a served ticket: tickets.served must
                    # reconcile with ServiceStats.served across the fleet
                    obs.metrics.counter("tickets.served").inc()
                    span.attrs["cache_tier"] = tier
                    obs.tracer.end(span, t_virtual=self._virtual_now)
                    obs.tracer.event("final", t_virtual=self._virtual_now,
                                     ticket=tid, outcome=SERVED,
                                     cached=True)
                return tid
            if obs is not None:
                obs.metrics.counter("cache.misses").inc()

        try:
            self.scheduler.enqueue(sub)
            # only queued work counts as an arrival: cache hits and
            # rejections never reach a dispatch window, and sizing the
            # window from them would defer scans past the lambda*L spot
            if self.window_controller is not None:
                self.window_controller.observe_arrival(self.clock())
            if self.leases is not None:
                # single-flight: announce the scan intent NOW, so by
                # dispatch time the fleet has resolved one owner per
                # duplicated canonical (deterministic bus-order tiebreak)
                self.leases.announce(sub.canonical, sub.calib_iters)
            if obs is not None:
                span.attrs["queued"] = True
                obs.tracer.end(span, t_virtual=self._virtual_now)
        except AdmissionError as e:
            ticket.status = REJECTED
            ticket.note = str(e)
            self.stats.rejected += 1
            if rs is not None:
                rs.abort(str(e))
            if obs is not None:
                obs.metrics.counter("submit.rejected").inc()
                obs.tracer.end(span, t_virtual=self._virtual_now,
                               status="error", note=str(e))
        return tid

    # ------------------------------------------------------------------ #
    def step(self, *, failure_script=None) -> List[int]:
        """Run one dispatch window; returns the ticket ids served
        SUCCESSFULLY (failed tickets resolve to status FAILED with the
        reason in their note, and are not returned).

        The window is deduplicated on canonical form, fragment-factored by
        the planner (each unique subexpression evaluated once per resident
        packet), and executed as ONE shared scan; shared boolean fragments
        the planner materialized are installed in the result cache
        alongside the per-query results.

        Tickets submitted with ``stream=True`` receive progressive
        snapshots *during* the scan: a
        :class:`~repro_torch.service.streaming.WindowStreamPublisher` rides the
        JSE's per-packet hook, folds each column's partial into a prefix
        merge, and publishes exact intermediate results into every
        subscribed stream.  A DONE window closes the streams with a final
        snapshot bit-identical to the ticket result; a FAILED window
        aborts them without one."""
        if failure_script and not getattr(
                self.backend, "supports_failure_injection", False):
            # fail BEFORE dequeuing: a mid-dispatch error would strand
            # the window's tickets/streams with no way to re-run them
            raise ValueError(
                "this execution backend does not support failure "
                "injection (failure scripts are a simulated-grid "
                "concept)")
        if self.window_controller is not None:
            self.scheduler.max_batch = self.window_controller.window()
        # failure policy: one decision per window, from the freshest
        # health evidence (local + gossip-merged); the scheduler's
        # next_batch narrows admission by the resulting routable fraction
        decision = None
        if self.policy is not None:
            report = (self.obs.health.report()
                      if self.obs is not None else None)
            if self.obs is not None:
                # transition/rereplicate events land on the service's
                # virtual timeline, not at 0 (reset after the dispatch)
                self.obs.tracer.virtual_base = self._virtual_now
            try:
                decision = self.policy.decide(report)
            finally:
                if self.obs is not None:
                    self.obs.tracer.virtual_base = 0.0
        window = self.scheduler.next_batch()
        if not window:
            return []
        if self.leases is not None:
            # single-flight: a canonical group another front-end holds a
            # fresh lease on is ADOPTED — its tickets ride the owner's
            # in-flight stream (fan-out buffered-prefix replay, zero
            # local I/O) and resolve in poll_adoptions; only what is
            # left dispatches as our own scan
            keep: List[Submission] = []
            byc: "OrderedDict[str, List[Submission]]" = OrderedDict()
            for sub in window:
                byc.setdefault(sub.canonical, []).append(sub)
            for canonical, subs in byc.items():
                key = self.leases.key_for(canonical, subs[0].calib_iters)
                owner = self.leases.holder(key)
                if owner is not None and owner != self.leases.node_id:
                    self._adopt(key, owner, subs)
                else:
                    keep.extend(subs)
            window = keep
            if not window:
                return []
        self.window_history.append(self.scheduler.max_batch)
        batch_id = self._next_batch
        self._next_batch += 1
        self.stats.batches += 1
        obs = self.obs
        wspan = None
        if obs is not None:
            wspan = obs.tracer.begin("window", t_virtual=self._virtual_now,
                                     batch=batch_id, queries=len(window))
            obs.tracer.push(wspan)
            obs.metrics.counter("window.dispatched").inc()
            obs.metrics.histogram("window.queries").observe(len(window))

        # dedup: identical canonical queries execute once, fan out to all
        groups: "OrderedDict[str, List[Submission]]" = OrderedDict()
        for sub in window:
            groups.setdefault(sub.canonical, []).append(sub)

        # fragment factoring across the window's unique queries; the
        # fabric registry (when present) seeds the interner with
        # cross-window hot fragments and pre-warms their materialization
        pspan = None
        if obs is not None:
            pspan = obs.tracer.begin("plan", t_virtual=self._virtual_now,
                                     batch=batch_id, unique=len(groups))
        plan = planner_lib.plan_window(
            list(groups), materialize=self.planner_materialize
            and self.use_cache, registry=self.registry,
            metrics=None if obs is None else obs.metrics)
        if obs is not None:
            pspan.attrs["materialized"] = len(plan.materialize)
            obs.tracer.end(pspan, t_virtual=self._virtual_now)
        if self.registry is not None:
            self.registry.observe_plan(plan)

        bricks = tuple(sorted(self.store.bricks))
        epoch = self.catalog.dataset_epoch
        job_ids = []
        for canonical, subs in groups.items():
            rep = subs[0]
            jid = self.catalog.submit(
                rep.expr, rep.calib_iters, bricks, tenant=rep.tenant,
                batch_id=batch_id)
            job_ids.append(jid)
        # streaming: per-column prefix-merge publisher over the subscribed
        # tickets of this window (dedup fan-out included); columns with no
        # subscriber cost nothing
        publisher = None
        col_streams = [[self.streams[s.ticket] for s in subs
                        if s.ticket in self.streams]
                       for subs in groups.values()]
        # single-flight owner side: export one lease stream per query
        # column we are scanning, plus one per materialized fragment
        # (fragment columns align with the plan's partials layout —
        # roots first, then materialize order), so adoptees receive the
        # bit-identical per-packet prefix stream with zero I/O
        window_leases: List[str] = []
        if self.leases is not None:
            calib_w = window[0].calib_iters
            for ci, canonical in enumerate(groups):
                key = self.leases.key_for(canonical, calib_w)
                es = streaming_lib.ResultStream(
                    key, capacity=self.stream_capacity)
                self.leases.export(key, es)
                col_streams[ci].append(es)
                window_leases.append(key)
            for fk in plan.materialize_keys():
                key = self.leases.announce(fk, calib_w)
                es = streaming_lib.ResultStream(
                    key, capacity=self.stream_capacity)
                self.leases.export(key, es)
                col_streams.append([es])
                window_leases.append(key)
        if any(col_streams):
            publisher = streaming_lib.WindowStreamPublisher(
                col_streams,
                events_total=sum(self.store.specs[b].n_events
                                 for b in bricks),
                bricks_total=len(bricks), obs=obs)
        # stream-aware packet sizing: a window someone is streaming gets
        # the small-early/growing-later ramp (fast first partial) while
        # keeping PROOF-adaptive sizing for the bulk of the scan
        dspan = None
        if obs is not None:
            dspan = obs.tracer.begin("dispatch",
                                     t_virtual=self._virtual_now,
                                     batch=batch_id, jobs=len(job_ids))
            # per-packet spans from the engine nest under this dispatch
            # and land on the service's cumulative virtual timeline
            obs.tracer.push(dspan)
            obs.tracer.virtual_base = self._virtual_now
        routing_kwargs = {}
        if decision is not None and getattr(
                self.backend, "supports_routing_policy", False):
            routing_kwargs = decision.backend_kwargs()
        try:
            merged, stats = self.backend.run_batch(
                job_ids, failure_script=failure_script, plan=plan,
                on_partial=publisher.on_partial if publisher is not None
                else None,
                packet_ramp=self.stream_ramp if publisher is not None
                else None,
                **routing_kwargs)
        finally:
            if obs is not None:
                obs.tracer.virtual_base = 0.0
        if self.policy is not None:
            # resolve probe outcomes from this window's telemetry (any
            # resulting transition stamps at the window's end time)
            if obs is not None:
                obs.tracer.virtual_base = \
                    self._virtual_now + stats.makespan_s
            try:
                self.policy.observe_window(stats)
            finally:
                if obs is not None:
                    obs.tracer.virtual_base = 0.0
        if obs is not None:
            ok_all = all(self.catalog.jobs[j].status == DONE
                         for j in job_ids)
            self._virtual_now += stats.makespan_s
            obs.tracer.end(dspan, t_virtual=self._virtual_now,
                           status="ok" if ok_all else "error")
            obs.tracer.pop()
            obs.metrics.histogram("window.makespan_s").observe(
                stats.makespan_s)
            if getattr(self.backend, "obs", None) is not obs:
                # backend without native instrumentation (a custom
                # ExecutionBackend): fall back to feeding metrics and
                # health from the telemetry the contract guarantees
                for t in stats.packet_telemetry:
                    obs.metrics.counter("packet.count").inc()
                    obs.metrics.histogram("packet.latency_s").observe(
                        t.wall_s)
                    obs.metrics.histogram("packet.events").observe(t.size)
                    obs.health.observe_packet(getattr(t, "node", -1),
                                              t.size, t.wall_s)
        self.stats.jobs_run += len(job_ids)
        self.stats.events_scanned += stats.events_scanned
        self.stats.fragment_evals += stats.fragment_evals
        self.stats.fragment_evals_unshared += stats.fragment_evals_unshared
        if self.window_controller is not None:
            self.window_controller.observe_scan(stats.makespan_s)
        if self.refit_cost_every:
            # accumulate per-packet compute and periodically refit the
            # admission cost model (static weights stay the cold prior).
            # Keep a bounded sliding window: the fit only needs recent
            # telemetry, and a long-lived service must not grow (or
            # re-fit) an unbounded history.
            self._telemetry.extend(stats.packet_telemetry)
            del self._telemetry[:-self.TELEMETRY_WINDOW]
            if self.stats.batches % self.refit_cost_every == 0:
                self.cost_weights = planner_lib.fit_cost_weights(
                    self._telemetry, prior=self.cost_weights)
                # calibrated weights live on the backend too: the
                # scheduler's window-cost bounding recosts queued work
                # against the backend it dispatches to
                self.backend.cost_weights = self.cost_weights

        calib = window[0].calib_iters
        served = []
        batch_ok = all(self.catalog.jobs[j].status == DONE for j in job_ids)
        if publisher is not None:
            if batch_ok:
                # final snapshot IS the batch-merged result object (the
                # prefix property guarantees the accumulator agrees);
                # with lease exports the fragment columns get their
                # merged fragment results, same order as the plan
                finals = list(merged)
                if self.leases is not None:
                    finals += [stats.fragment_results[k]
                               for k in plan.materialize_keys()]
                publisher.finish(finals, stats.makespan_s)
            else:
                publisher.abort(self.catalog.jobs[job_ids[0]].note)
        for (canonical, subs), jid, res in zip(groups.items(), job_ids,
                                               merged):
            ok = self.catalog.jobs[jid].status == DONE
            if ok and self.use_cache:
                self.cache.put(subs[0].expr, subs[0].calib_iters, epoch, res,
                               canonical=canonical)
            for sub in subs:
                ticket = self.tickets[sub.ticket]
                ticket.job_id = jid
                ticket.batch_id = batch_id
                ticket.result = res if ok else None
                ticket.status = SERVED if ok else FAILED
                ticket.note = "" if ok else self.catalog.jobs[jid].note
                if ok:
                    self.stats.served += 1
                    served.append(sub.ticket)
                if obs is not None:
                    obs.tracer.event(
                        "final", t_virtual=self._virtual_now,
                        ticket=sub.ticket, batch=batch_id,
                        outcome=ticket.status)
                    obs.metrics.counter(
                        "tickets.served" if ok
                        else "tickets.failed").inc()
        # fragment-level cache entries: a future query equal to a shared
        # conjunct of this window is then a zero-I/O hit
        if batch_ok and self.use_cache:
            for frag_key, frag_res in stats.fragment_results.items():
                self.cache.put_fragment(frag_key, calib, epoch, frag_res)
        # single-flight: the window resolved (DONE or FAILED), release
        # its leases — adoptees still waiting get the release promptly
        # instead of waiting out the TTL; finished exports stay readable
        # for late subscribers until the lease GC reclaims them
        if self.leases is not None:
            for key in window_leases:
                self.leases.release(key)
        if obs is not None:
            obs.tracer.end(wspan, t_virtual=self._virtual_now,
                           status="ok" if batch_ok else "error")
            obs.tracer.pop()
        return served

    def drain(self, *, max_windows: int = 10_000) -> List[int]:
        """Dispatch windows until no work is pending (bounded by
        ``max_windows``); returns every ticket id served successfully
        across those windows."""
        served: List[int] = []
        for _ in range(max_windows):
            if self.scheduler.n_pending == 0:
                break
            served.extend(self.step())
        return served

    # ------------------------- single-flight -------------------------- #
    @property
    def adoptions_pending(self) -> bool:
        """True while any adopted canonical group is still waiting for
        its remote lease owner's final (or for fallback)."""
        return bool(self._adoptions)

    def _adopt(self, key: str, owner: str,
               subs: List[Submission]) -> None:
        """Attach a dequeued canonical group to a remote owner's lease
        stream: proxy it through the fan-out, withdraw our own intent,
        and mirror live proxy snapshots into the group's ticket streams
        (non-final only — an adopted partial is NEVER surfaced as
        final; the final lands in :meth:`_resolve_adoption`)."""
        self.leases.withdraw(key)
        ad = self._adoptions.get(key)
        if ad is not None:
            # a later window re-adopted the same key: the new tickets
            # catch up on the buffered prefix, then ride the live feed
            for snap in ad.proxy.buffered():
                if not snap.final:
                    self._mirror(ad, snap)
            ad.subs.extend(subs)
            return
        proxy = self.leases.fanout.proxy(key, owner)
        ad = _Adoption(key=key, owner=owner, subs=list(subs), proxy=proxy,
                       epoch=self.catalog.dataset_epoch,
                       fp=self.leases.current_fp(),
                       adopted_round=self.leases.bus.round,
                       checked_round=self.leases.bus.round)
        self._adoptions[key] = ad
        proxy.subscribe(lambda snap, a=ad: None if snap.final
                        else self._mirror(a, snap))
        self.stats.adopted += len(subs)
        if self.leases.flight is not None:
            self.leases.flight.record("lease_adopt", key=key, owner=owner,
                                      tickets=[s.ticket for s in subs])
        if self.obs is not None:
            self.obs.metrics.counter("lease.adopted").inc(len(subs))
            for sub in subs:
                self.obs.tracer.event(
                    "lease_adopt", t_virtual=self._virtual_now,
                    ticket=sub.ticket, owner=owner)

    def _mirror(self, ad: _Adoption, snap) -> None:
        # forward one non-final owner snapshot into the adopted tickets'
        # streams (same snapshot object: bit-identical prefixes)
        for sub in ad.subs:
            rs = self.streams.get(sub.ticket)
            if rs is not None:
                rs.publish(snap)

    def poll_adoptions(self) -> None:
        """Advance every pending adoption (the Fleet calls this each
        fabric round): a DONE proxy under a still-current epoch resolves
        its tickets from the owner's final; an aborted proxy, an
        expired/released/revoked lease, or a mid-stream epoch bump falls
        back — shared-cache re-probe first (the owner's completed result
        is reachable in-process even across a bus partition), own rescan
        on a miss.  A stalled-but-fresh adoption re-subscribes, healing
        snapshots a partition dropped."""
        if self.leases is None:
            return
        for key in list(self._adoptions):
            ad = self._adoptions.get(key)
            if ad is None:
                continue
            if ad.proxy.done:
                if self.leases.fp_current(ad.fp):
                    self._resolve_adoption(ad)
                else:
                    self._fallback(ad, "epoch bumped mid-adoption")
            elif ad.proxy.state == streaming_lib.ABORTED:
                self._fallback(ad, f"owner aborted: {ad.proxy.note}")
            elif not self.leases.fp_current(ad.fp):
                self._fallback(ad, "epoch bumped mid-adoption")
            else:
                owner_now = self.leases.holder(key)
                if owner_now != ad.owner \
                        and not self.leases.released_recently(key):
                    self._fallback(ad, "lease lost (owner dead or "
                                       "banned mid-stream)")
                    continue
                rnd = self.leases.bus.round
                if rnd - ad.checked_round >= self.leases.ttl:
                    ad.checked_round = rnd
                    if ad.proxy.published == ad.last_published:
                        # fresh lease but no progress for a full TTL:
                        # re-subscribe — the owner replays its buffered
                        # prefix (and final, if any), healing whatever a
                        # partition dropped
                        self.leases.fanout.resubscribe(key, ad.owner)
                    ad.last_published = ad.proxy.published

    def _resolve_adoption(self, ad: _Adoption) -> None:
        final = ad.proxy.latest()
        res = final.result
        self._adoptions.pop(ad.key, None)
        self.leases.fanout.release(ad.key)
        if self.use_cache:
            # same write-through as a local scan: later duplicates are
            # L1 hits here and zero-I/O everywhere via L2
            self.cache.put(ad.subs[0].expr, ad.subs[0].calib_iters,
                           ad.epoch, res, canonical=ad.subs[0].canonical)
        for sub in ad.subs:
            jid = self.catalog.submit(sub.expr, sub.calib_iters,
                                      tuple(sorted(self.store.bricks)),
                                      tenant=sub.tenant)
            self.catalog.update(jid, status=DONE, note="adopted",
                                result={"n_selected": res.n_selected,
                                        "n_processed": res.n_processed,
                                        "sum_var": res.sum_var})
            ticket = self.tickets[sub.ticket]
            ticket.status = SERVED
            ticket.job_id = jid
            ticket.adopted = True
            ticket.result = res
            ticket.note = f"adopted from {ad.owner}"
            self.stats.served += 1
            rs = self.streams.get(sub.ticket)
            if rs is not None:
                rs.finish(final)  # the owner's final snapshot, verbatim
            if self.obs is not None:
                self.obs.metrics.counter("tickets.served").inc()
                self.obs.tracer.event(
                    "final", t_virtual=self._virtual_now,
                    ticket=sub.ticket, outcome=SERVED, adopted=True)

    def _fallback(self, ad: _Adoption, reason: str) -> None:
        self._adoptions.pop(ad.key, None)
        self.leases.fanout.release(ad.key)
        self.stats.lease_fallbacks += 1
        if self.leases.flight is not None:
            self.leases.flight.record(
                "lease_fallback", key=ad.key, owner=ad.owner,
                reason=reason, tickets=[s.ticket for s in ad.subs])
        if self.obs is not None:
            self.obs.metrics.counter("lease.fallbacks").inc()
            self.obs.tracer.event("lease_fallback",
                                  t_virtual=self._virtual_now,
                                  note=reason)
        sub0 = ad.subs[0]
        hit = (self.cache.get(sub0.expr, sub0.calib_iters,
                              self.catalog.dataset_epoch,
                              canonical=sub0.canonical)
               if self.use_cache else None)
        if hit is not None:
            # the owner finished (its result is in the shared tier) but
            # the final/release never reached us: a zero-I/O resolve —
            # "never lose a final" without a duplicate scan
            for sub in ad.subs:
                jid = self.catalog.submit(sub.expr, sub.calib_iters,
                                          tuple(sorted(self.store.bricks)),
                                          tenant=sub.tenant)
                self.catalog.update(
                    jid, status=DONE, note="adopted (cache fallback)",
                    result={"n_selected": hit.n_selected,
                            "n_processed": hit.n_processed,
                            "sum_var": hit.sum_var})
                ticket = self.tickets[sub.ticket]
                ticket.status = SERVED
                ticket.job_id = jid
                ticket.adopted = True
                ticket.from_cache = True
                ticket.result = hit
                ticket.note = f"adopted via cache ({reason})"
                self.stats.served += 1
                self.stats.cache_hits += 1
                rs = self.streams.get(sub.ticket)
                if rs is not None:
                    rs.finish(streaming_lib.StreamSnapshot(
                        seq=0, result=hit,
                        coverage=merge_lib.Coverage(
                            events_scanned=hit.n_processed,
                            events_total=hit.n_processed),
                        t_virtual=0.0, final=True))
                if self.obs is not None:
                    self.obs.metrics.counter("tickets.served").inc()
            return
        # genuine fallback: requeue for our own scan and re-announce a
        # fresh intent — N-1 simultaneous fallbacks re-race and resolve
        # to exactly one rescanner, the others re-adopt
        for sub in ad.subs:
            self.scheduler.requeue(sub)
        self.leases.announce(sub0.canonical, sub0.calib_iters)

    # ------------------------------------------------------------------ #
    def result(self, ticket_id: int) -> Ticket:
        """Look up the :class:`Ticket` for a submission (KeyError if the
        id was never issued)."""
        return self.tickets[ticket_id]

    def stream(self, ticket_id: int) -> streaming_lib.ResultStream:
        """Look up the :class:`~repro_torch.service.streaming.ResultStream` of a
        ticket submitted with ``stream=True`` (KeyError otherwise)."""
        return self.streams[ticket_id]

    def close(self) -> None:
        """Shut the service down: detach the result cache's invalidation
        hook from the catalogue (a long-lived catalogue must not keep
        every cache ever attached alive through its hook list) and abort
        any still-open streams so no tenant waits on a final that will
        never come.  Idempotent; the service must not be used after."""
        if self._closed:
            return
        self._closed = True
        self.cache.detach()
        for rs in self.streams.values():
            rs.abort("service closed")

    def _close_stream_span(self, stream) -> None:
        """Stream ``on_close`` hook: close the ticket's stream span with
        the stream's terminal state (error on ABORTED — rejected tickets,
        truncated scans and service shutdown all land here, so no path
        leaks an open span)."""
        span = self._stream_spans.pop(stream.ticket_id, None)
        if span is None or self.obs is None:
            return
        if stream.state == streaming_lib.ABORTED:
            self.obs.tracer.end(span, t_virtual=self._virtual_now,
                                status="error", note=stream.note)
        else:
            self.obs.tracer.end(span, t_virtual=self._virtual_now)

    def release_stream(self, ticket_id: int) -> None:
        """Drop a finished consumer's stream (and its buffered snapshots)
        from the service.  Streams — like tickets — live for the service
        lifetime by default so late readers can still drain them; a
        long-running tenant loop should release each stream once read.
        No-op if the ticket has no stream; the ticket itself (and its
        final ``result``) is unaffected."""
        self.streams.pop(ticket_id, None)
