"""Fleet: N query front-ends joined into one coherent service by the
fabric.

The paper's scalability story ("freely adding ... any grid computing and
storage node") only holds if the *service* tier scales out too.  A
:class:`Fleet` stands up N :class:`~repro_torch.service.frontend.QueryService`
front-ends over ONE shared brick store, each with its own catalogue view,
and wires them through the fabric's four mechanisms:

- a deterministic :class:`~repro_torch.fabric.bus.MessageBus` simulating the
  inter-front-end network;
- :class:`~repro_torch.fabric.gossip.GossipNode` epoch + liveness gossip, so a
  dataset bump or node death observed anywhere reaches every catalogue
  within :func:`~repro_torch.fabric.gossip.rounds_bound` rounds;
- a :class:`~repro_torch.fabric.shared_cache.SharedCacheTier` L2 under every
  front-end's L1, so whole-query and fragment results computed once are
  zero-I/O hits fleet-wide;
- a fleet-shared :class:`~repro_torch.fabric.registry.FragmentRegistry`
  seeding every window's planner with cross-window hot fragments;
- :class:`~repro_torch.fabric.fanout.StreamFanout` ticket routing, so a tenant
  can read any ticket's progressive stream from any front-end.

Tickets are fleet-global: :meth:`Fleet.submit` returns an id valid at
every front-end (``result``/``stream`` route to the owner), which is the
"any door" property interactive grids need from a load-balanced service
tier.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.brick import BrickStore
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.core.elastic import ElasticManager, MigrationPlan
from repro_torch.fabric.bus import MessageBus
from repro_torch.fabric.fanout import STREAM_TOPIC, StreamFanout
from repro_torch.fabric.gossip import (GOSSIP_TOPIC, GossipNode,
                                       adaptive_fanout, rounds_bound)
from repro_torch.fabric import leases as leases_lib
from repro_torch.fabric.leases import LEASE_TOPIC, LeaseManager
from repro_torch.fabric.registry import FragmentRegistry
from repro_torch.fabric.shared_cache import (SharedCacheTier,
                                             TieredResultCache)
from repro_torch.obs import (HealthMonitor, HealthReport, MetricsRegistry,
                             MetricsSnapshot, Observability, merge_snapshots)
from repro_torch.obs import flight as flight_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.service import streaming as streaming_lib
from repro_torch.service.frontend import QUEUED, QueryService, Ticket
from repro_torch.service.policy import FailurePolicy
from repro_torch.service.scheduler import QueryScheduler


@dataclasses.dataclass
class Frontend:
    """One fleet member: the service plus its fabric endpoints (own
    catalogue view, gossip node, stream fan-out, and — under
    ``single_flight=True`` — the scan-intent lease manager).  ``alive``
    turns False on :meth:`Fleet.frontend_leave`: a dead front-end stops
    emitting/receiving and its leases expire by TTL."""
    index: int
    node_id: str
    service: QueryService
    catalog: MetadataCatalog
    gossip: GossipNode
    fanout: StreamFanout
    obs: Optional[Observability] = None
    leases: Optional[LeaseManager] = None
    alive: bool = True


class Fleet:
    """N coherent query front-ends over one brick store (see module doc).

    Parameters
    ----------
    store:
        The shared brick-sharded event store (the grid's storage fabric).
    n_frontends:
        Fleet width.
    bus:
        Injectable :class:`~repro_torch.fabric.bus.MessageBus` (pass one with
        delay/drop/partition configured for fault experiments).
    shared_cache:
        ``True`` installs one :class:`SharedCacheTier` L2 under every
        front-end; ``False`` gives each front-end an independent L1 only
        (the A/B baseline the fabric benchmark measures against).
    registry:
        Fleet-shared :class:`FragmentRegistry`, or ``None`` for
        per-window planning only.
    backend:
        Execution backend every front-end dispatches on: ``"sim"``
        (default) or ``"spmd"`` — passed by name so each front-end
        constructs its own backend over its own catalogue view (see
        ``core/backend.py``).
    backend_kwargs:
        Tuning kwargs forwarded to every front-end's backend
        constructor — the SPMD performance knobs (``use_pallas``,
        ``chunk_events``, ``adaptive_chunks``, ``mesh_devices``,
        ``double_buffer``).
    gossip_fanout:
        Digest push targets per round; ``None`` (default) adapts to
        fleet size (``max(1, ceil(log2(n)))``).  The propagation bound
        is ``rounds_bound(n_frontends, gossip_fanout)``.
    scheduler_factory:
        Per-front-end :class:`QueryScheduler` constructor (schedulers
        hold queues and cannot be shared).
    service_kwargs:
        Extra keyword arguments applied to every ``QueryService`` (e.g.
        ``stream_ramp``, ``refit_cost_every``, ``use_cache``).
    obs:
        ``True`` stands up the observability plane: one
        :class:`~repro_torch.obs.Observability` bundle per front-end (origin
        ``fe{i}``) wired through the service, its gossip node (health
        digests piggyback on epoch gossip), plus one fleet-level
        :class:`~repro_torch.obs.MetricsRegistry` (origin ``fleet``) installed
        on the shared infrastructure — the bus and the L2 tier.  Default
        ``False`` keeps every hook at ``None`` (zero overhead).
    gossip_repair:
        ``True`` runs the gossip nodes in ack/repair mode (see
        ``fabric/gossip.py``): digests are acknowledged, unacked ones
        re-pushed, and acks from stale senders carry a push-pull reply —
        the hardening that keeps ``rounds_bound_lossy`` honest on a bus
        with sustained seeded loss.
    policy / policy_config:
        ``True`` gives every front-end a
        :class:`~repro_torch.service.policy.FailurePolicy` over its own
        catalogue view (evidence arrives via the gossip-merged health
        digests, so a node banned from one front-end's evidence is soon
        banned fleet-wide).  Requires ``obs=True`` (the policy consumes
        health reports).  ``policy_config`` overrides the default
        :class:`~repro_torch.service.policy.PolicyConfig` thresholds.
    single_flight / lease_ttl:
        ``True`` wires a :class:`~repro_torch.fabric.leases.LeaseManager` into
        every front-end: scan intents are announced at submit, duplicate
        scans are adopted from the lease owner's in-flight stream
        (``fabric/leases.py``), and :meth:`step` pumps one bus
        round-trip before dispatching so same-round intents resolve to
        one owner first.  ``lease_ttl`` (bus rounds) overrides
        :func:`~repro_torch.fabric.leases.lease_ttl`'s gossip-bound default.
    l2_path / l2_checkpoint_every:
        Operational L2 persistence: when ``l2_path`` names an existing
        file the shared tier boots from it (post-restart submissions hit
        with zero I/O), and the fleet checkpoints the tier back to the
        path on :meth:`close` plus every ``l2_checkpoint_every``
        :meth:`step` calls (0 = only on close).  Requires
        ``shared_cache=True`` to matter.
    flight:
        ``True`` (or an existing
        :class:`~repro_torch.obs.flight.FlightRecorder`) arms the flight
        recorder: every driver call, bus send outcome/delivery, gossip
        epoch/liveness change, lease transition, policy decision,
        dispatch window and result digest is appended to a causal
        decision log (:attr:`flight`; write it with
        :meth:`save_flight`).  The log replays bit-identically through
        :func:`repro_torch.obs.replay.replay_run`.  Independent of ``obs``
        and, like it, recorded in virtual time only — arming it leaves
        simulated makespans exactly unchanged.
    device:
        Where the store lives and every front-end's scans run (default
        ``"cuda"``), handed to each ``QueryService``.  It is kept out of
        ``service_kwargs`` on purpose: those go into the flight log's
        ``run_header``, and a log must replay in either package on the
        device its caller picks.
    """

    def __init__(self, store: BrickStore, n_frontends: int = 2, *,
                 bus: Optional[MessageBus] = None,
                 shared_cache: bool = True,
                 l1_capacity: int = 256,
                 l2_capacity: int = 4096,
                 registry: Optional[FragmentRegistry] = None,
                 backend: str = "sim",
                 backend_kwargs: Optional[dict] = None,
                 gossip_fanout: Optional[int] = None,
                 scheduler_factory: Optional[
                     Callable[[], QueryScheduler]] = None,
                 service_kwargs: Optional[dict] = None,
                 obs: bool = False,
                 gossip_repair: bool = False,
                 policy: bool = False,
                 policy_config=None,
                 single_flight: bool = False,
                 lease_ttl: Optional[int] = None,
                 l2_path: Optional[Union[str, pathlib.Path]] = None,
                 l2_checkpoint_every: int = 0,
                 flight: Union[bool, flight_lib.FlightRecorder] = False,
                 device: Union[str, torch.device] = "cuda"):
        if n_frontends < 1:
            raise ValueError("need at least one front-end")
        if policy and not obs:
            raise ValueError(
                "policy=True requires obs=True (the failure policy "
                "consumes the health plane's reports)")
        self.store = store
        self.device = store.check_device(device)
        self.bus = bus or MessageBus()
        self.single_flight = single_flight
        self.l2_path = pathlib.Path(l2_path) if l2_path is not None else None
        self.l2_checkpoint_every = l2_checkpoint_every
        self._steps_since_ckpt = 0
        if shared_cache and self.l2_path is not None \
                and self.l2_path.exists():
            # boot from the last checkpoint: results computed before the
            # restart are zero-I/O hits immediately
            self.l2 = SharedCacheTier.load(self.l2_path)
        else:
            self.l2 = SharedCacheTier(l2_capacity) if shared_cache else None
        self.fleet_metrics: Optional[MetricsRegistry] = None
        if obs:
            self.fleet_metrics = MetricsRegistry(origin="fleet")
            self.bus.metrics = self.fleet_metrics
            if self.l2 is not None:
                self.l2.metrics = self.fleet_metrics
        #: the armed FlightRecorder, or None (``flight=`` parameter)
        self.flight: Optional[flight_lib.FlightRecorder] = None
        self._flight_depth = 0   # nested driver ops record only the outer
        self._flight_finals: set = set()  # gtids whose final is recorded
        if flight:
            self.flight = (flight
                           if isinstance(flight, flight_lib.FlightRecorder)
                           else flight_lib.FlightRecorder())
            self.bus.flight = self.flight.scoped("bus")
        self.registry = registry
        self.backend = backend
        self.gossip_fanout = (gossip_fanout if gossip_fanout is not None
                              else adaptive_fanout(n_frontends))
        self.frontends: List[Frontend] = []
        self._tickets: Dict[int, Tuple[int, int]] = {}  # gtid -> (fe, tid)
        self._by_local: Dict[Tuple[int, int], int] = {}  # (fe, tid) -> gtid
        self._next_gtid = 0
        self._rr = 0
        kwargs = dict(service_kwargs or {})
        kwargs.setdefault("backend", backend)
        if backend_kwargs:
            # per-frontend backends share the tuning knobs
            kwargs.setdefault("backend_kwargs", dict(backend_kwargs))
        for i in range(n_frontends):
            node_id = f"fe{i}"
            catalog = MetadataCatalog(store.n_nodes)
            # gossip BEFORE the cache: both register catalogue bump hooks,
            # and on a local bump the gossip hook must credit the version
            # vector first so the cache's hook forwards the already-updated
            # vector to the shared tier
            gossip = GossipNode(node_id, catalog, self.bus,
                                fanout=self.gossip_fanout,
                                repair=gossip_repair)
            cache = TieredResultCache(l1_capacity, catalog=catalog,
                                      l2=self.l2,
                                      vv_source=lambda g=gossip: g.vv)
            fe_obs = Observability(origin=node_id) if obs else None
            if fe_obs is not None:
                # health digests ride the gossip digest; gossip counters
                # land in the front-end's own registry
                gossip.health = fe_obs.health
                gossip.metrics = fe_obs.metrics
            pol = None
            if policy:
                pol = FailurePolicy(catalog, store, obs=fe_obs,
                                    config=policy_config)
            lease_mgr = None
            if single_flight:
                ttl = (lease_ttl if lease_ttl is not None
                       else leases_lib.lease_ttl(n_frontends,
                                                 self.gossip_fanout,
                                                 self.bus.delay))
                lease_mgr = LeaseManager(node_id, self.bus,
                                         lambda g=gossip: g.vv,
                                         ttl=ttl, obs=fe_obs)
            svc = QueryService(
                store, catalog, cache=cache,
                scheduler=scheduler_factory() if scheduler_factory else None,
                registry=registry, frontend_id=node_id, obs=fe_obs,
                policy=pol, leases=lease_mgr, device=self.device,
                **kwargs)
            fanout = StreamFanout(
                node_id, self.bus,
                lambda key, idx=i: self._resolve_stream(key, idx))
            if lease_mgr is not None:
                # adoptees proxy remote lease streams through the same
                # fan-out that serves cross-front-end ticket reads; subs
                # for leases we announced but have not dispatched yet are
                # parked, not aborted (the export is coming)
                lease_mgr.fanout = fanout
                fanout.defer = lease_mgr.intends
            if self.flight is not None:
                scope = self.flight.scoped(node_id)
                gossip.flight = scope
                svc.scheduler.flight = scope
                if pol is not None:
                    pol.flight = scope
                if lease_mgr is not None:
                    lease_mgr.flight = scope
            self.frontends.append(Frontend(i, node_id, svc, catalog,
                                           gossip, fanout, fe_obs,
                                           lease_mgr))
        if self.flight is not None:
            safe_kwargs = {k: v for k, v in (service_kwargs or {}).items()
                           if isinstance(v, (bool, int, float, str,
                                             type(None)))}
            self.flight.record(
                "run_header", origin="fleet",
                n_frontends=n_frontends, backend=backend,
                shared_cache=shared_cache, l1_capacity=l1_capacity,
                l2_capacity=l2_capacity, registry=registry is not None,
                gossip_fanout=self.gossip_fanout,
                gossip_repair=gossip_repair, obs=obs, policy=policy,
                policy_config=policy_config is not None,
                single_flight=single_flight, lease_ttl=lease_ttl,
                scheduler_factory=scheduler_factory is not None,
                l2_path=self.l2_path is not None,
                service_kwargs=safe_kwargs,
                bus_delay=self.bus.delay,
                bus_drop_rate=self.bus.drop_rate)

    # ------------------------------------------------------------------ #
    @property
    def n_frontends(self) -> int:
        """Fleet width."""
        return len(self.frontends)

    @property
    def rounds_bound(self) -> int:
        """Documented gossip propagation bound for this fleet's shape."""
        return rounds_bound(self.n_frontends, self.gossip_fanout)

    def policy_states(self) -> Dict[str, Dict[int, str]]:
        """Per-frontend failure-policy states (``fe id -> {node: state}``);
        empty dict when the fleet was built without ``policy=True``.  Each
        front-end judges independently from its gossip-merged health view,
        so entries can disagree transiently until evidence converges."""
        out: Dict[str, Dict[int, str]] = {}
        for fe in self.frontends:
            pol = fe.service.policy
            if pol is not None:
                out[fe.node_id] = pol.states()
        return out

    def _resolve_stream(self, key: Union[int, str],
                        fe_index: int
                        ) -> Optional[streaming_lib.ResultStream]:
        fe = self.frontends[fe_index]
        if isinstance(key, str):
            # lease keys are strings; integer keys are global ticket ids
            if fe.leases is None:
                return None
            return fe.leases.exports.get(key)
        owner = self._tickets.get(key)
        if owner is None or owner[0] != fe_index:
            return None
        return fe.service.streams.get(owner[1])

    def _owner(self, gtid: int) -> Tuple[Frontend, int]:
        fe_idx, tid = self._tickets[gtid]
        return self.frontends[fe_idx], tid

    def owner_of(self, gtid: int) -> int:
        """Index of the front-end that owns a global ticket (KeyError if
        the id was never issued)."""
        return self._tickets[gtid][0]

    # -------------------------- flight plumbing ----------------------- #
    @contextlib.contextmanager
    def _flight_op(self, op: str, **fields):
        # Record one driver op and make it the causal parent of every
        # record appended while it runs.  Internal nesting (drain->step->
        # pump) records only the OUTERMOST op: replay re-issues driver
        # calls verbatim, so inner calls replay themselves.
        fl = self.flight
        outer = fl is not None and self._flight_depth == 0
        self._flight_depth += 1
        rec = None
        if outer:
            rec = fl.record("op", origin="fleet", op=op, **fields)
            fl.push(rec["eid"])
        try:
            yield rec
        finally:
            if outer:
                fl.pop()
            self._flight_depth -= 1

    def _flight_finalize(self) -> None:
        # Append one "final" digest record per newly resolved ticket, in
        # gtid order — the bit-identity surface replay compares.
        fl = self.flight
        if fl is None:
            return
        for gtid in sorted(self._tickets):
            if gtid in self._flight_finals:
                continue
            fe_idx, tid = self._tickets[gtid]
            t = self.frontends[fe_idx].service.tickets[tid]
            if t.status == QUEUED:
                continue
            self._flight_finals.add(gtid)
            fl.record("final", origin="fleet", gtid=gtid, status=t.status,
                      adopted=t.adopted, cached=t.from_cache,
                      digest=(None if t.result is None
                              else flight_lib.result_digest(t.result)))

    def save_flight(self, path) -> int:
        """Write the flight-recorder log as JSONL (records any
        still-unrecorded finals first); returns records written.
        Raises RuntimeError when the fleet was built without
        ``flight=``."""
        if self.flight is None:
            raise RuntimeError("fleet was built without flight=")
        self._flight_finalize()
        self.flight.save_jsonl(path)
        return len(self.flight.records)

    # ------------------------------------------------------------------ #
    def submit(self, expr: str, *, tenant: str = "default",
               calib_iters: int = 0, stream: bool = False,
               frontend: Optional[int] = None) -> int:
        """Submit to one front-end (round-robin over LIVE front-ends when
        ``frontend`` is None); returns a fleet-global ticket id usable at
        any front-end."""
        with self._flight_op("submit", expr=expr, tenant=tenant,
                             calib_iters=calib_iters, stream=stream,
                             frontend=frontend, gtid=None) as oprec:
            if frontend is None:
                for _ in range(self.n_frontends):
                    idx = self._rr % self.n_frontends
                    self._rr += 1
                    if self.frontends[idx].alive:
                        frontend = idx
                        break
                if frontend is None:
                    raise RuntimeError("no live front-ends")
            fe = self.frontends[frontend]
            tid = fe.service.submit(expr, tenant=tenant,
                                    calib_iters=calib_iters, stream=stream)
            gtid = self._next_gtid
            self._next_gtid += 1
            self._tickets[gtid] = (frontend, tid)
            self._by_local[(frontend, tid)] = gtid
            if oprec is not None:
                # patch in the resolved routing so replay re-targets the
                # same front-end without re-running the round-robin
                oprec["frontend"] = frontend
                oprec["gtid"] = gtid
            if stream and self.flight is not None:
                rs = fe.service.streams.get(tid)
                if rs is not None:
                    fl = self.flight
                    rs.subscribe(lambda snap, g=gtid: fl.record(
                        "stream_snapshot", origin="fleet", gtid=g,
                        seq=snap.seq, final=bool(snap.final),
                        digest=flight_lib.result_digest(snap.result)))
            return gtid

    def result(self, gtid: int) -> Ticket:
        """Ticket lookup routed to the owning front-end (the control
        plane is catalogue-backed, hence visible from any door)."""
        fe, tid = self._owner(gtid)
        return fe.service.result(tid)

    def stream(self, gtid: int, *,
               frontend: Optional[int] = None
               ) -> streaming_lib.ResultStream:
        """The ticket's progressive stream, read from ``frontend`` (the
        owner by default).  A non-owner front-end returns a proxy stream
        fed over the bus — call :meth:`pump` (or :meth:`step`) to move
        snapshots; the proxy honours every local-streaming guarantee (see
        ``fabric/fanout.py``)."""
        fe, tid = self._owner(gtid)
        if frontend is None or frontend == fe.index:
            return fe.service.stream(tid)
        with self._flight_op("stream", gtid=gtid, frontend=frontend):
            # cross-frontend read: the proxy subscription talks over the
            # bus, so the op must be in the log for replay to re-issue it
            return self.frontends[frontend].fanout.proxy(gtid, fe.node_id)

    # ------------------------------------------------------------------ #
    def pump(self, rounds: int = 1) -> None:
        """Advance the fabric ``rounds`` network rounds: every live
        front-end's gossip node pushes its digest (and its lease manager
        re-announces intents, under ``single_flight``), the bus ticks,
        delivered messages are dispatched to their topic handlers, and
        pending stream adoptions are polled.  Dead front-ends
        (:meth:`frontend_leave`) emit nothing; their inboxes are drained
        and discarded so in-flight accounting still quiesces."""
        fl = self.flight
        with self._flight_op("pump", rounds=rounds):
            for _ in range(rounds):
                for fe in self.frontends:
                    if not fe.alive:
                        continue
                    fe.gossip.emit()
                    if fe.leases is not None:
                        fe.leases.emit()
                self.bus.tick()
                for fe in self.frontends:
                    if not fe.alive:
                        self.bus.recv(fe.node_id)  # discard: nobody home
                        continue
                    for env in self.bus.recv(fe.node_id):
                        if fl is not None:
                            # handler effects chain to the delivery that
                            # carried the message, not the pump op
                            fl.push(fl.deliver_cause(env.seq))
                        try:
                            if env.topic == GOSSIP_TOPIC:
                                fe.gossip.on_message(env.payload)
                            elif env.topic == STREAM_TOPIC:
                                fe.fanout.on_message(env.payload)
                            elif env.topic == LEASE_TOPIC \
                                    and fe.leases is not None:
                                fe.leases.on_message(env.payload)
                        finally:
                            if fl is not None:
                                fl.pop()
                for fe in self.frontends:
                    if fe.alive and fe.leases is not None:
                        fe.service.poll_adoptions()

    def step(self, frontend: Optional[int] = None, *,
             failure_script=None, pump_rounds: int = 1) -> List[int]:
        """Run one dispatch window on one (or every live) front-end, then
        pump the fabric; returns the GLOBAL ids of tickets served.  Under
        ``single_flight`` the fabric is pumped one bus round-trip BEFORE
        dispatch, so intents announced at submit time have resolved to
        one owner per duplicated canonical fleet-wide and the losers
        adopt instead of scanning."""
        with self._flight_op("step", frontend=frontend,
                             pump_rounds=pump_rounds,
                             scripted=failure_script is not None):
            if self.single_flight:
                self.pump(1 + self.bus.delay)
            targets = ([self.frontends[frontend]] if frontend is not None
                       else [fe for fe in self.frontends if fe.alive])
            served = []
            for fe in targets:
                for tid in fe.service.step(failure_script=failure_script):
                    served.append(self._by_local[(fe.index, tid)])
            self.pump(pump_rounds)
            if self.l2_checkpoint_every > 0 and self.l2 is not None \
                    and self.l2_path is not None:
                self._steps_since_ckpt += 1
                if self._steps_since_ckpt >= self.l2_checkpoint_every:
                    self._steps_since_ckpt = 0
                    self.l2.save(self.l2_path)
            return served

    def _busy(self) -> bool:
        return any(fe.alive and (fe.service.scheduler.n_pending > 0
                                 or fe.service.adoptions_pending)
                   for fe in self.frontends)

    def drain(self, *, max_windows: int = 10_000) -> None:
        """Dispatch windows on every front-end until no work is pending
        and no adoption is unresolved, pump until the stream fan-out
        traffic quiesces (all snapshots landed), then run one full
        anti-entropy cycle (``rounds_bound`` pumps) so every
        epoch/liveness fact observed before the drain is fleet-wide.
        Quiescence is judged on the stream topic only: every pump emits
        fresh gossip digests, so waiting for a fully idle bus would spin
        forever on a delayed bus.  The outer loop re-enters dispatch when
        the anti-entropy cycle itself creates work — e.g. a lease TTL
        expiry whose fallback requeued a scan."""
        with self._flight_op("drain", max_windows=max_windows):
            for _ in range(max_windows):
                for _ in range(max_windows):
                    if not self._busy():
                        break
                    self.step()
                guard = 0
                while self.bus.in_flight(STREAM_TOPIC) and guard < 1000:
                    self.pump()
                    guard += 1
                self.pump(self.rounds_bound)
                if not self._busy():
                    break
            self._flight_finalize()

    # ------------------------------------------------------------------ #
    def bump_dataset_version(self, frontend: int = 0) -> int:
        """Record a dataset change as observed by one front-end; gossip
        carries it to every peer within :attr:`rounds_bound` pumps."""
        with self._flight_op("bump", frontend=frontend):
            return self.frontends[frontend].catalog.bump_dataset_version()

    def node_leave(self, grid_node: int, *,
                   observed_by: int = 0) -> MigrationPlan:
        """Grid node death observed by one front-end: local failover via
        the ElasticManager, liveness gossip to every peer."""
        with self._flight_op("node_leave", grid_node=grid_node,
                             observed_by=observed_by):
            fe = self.frontends[observed_by]
            plan = ElasticManager(fe.catalog,
                                  self.store).node_leave(grid_node)
            fe.gossip.observe_liveness(grid_node, False)
            return plan

    def node_join(self, grid_node: int, *,
                  observed_by: int = 0) -> MigrationPlan:
        """Grid node (re)join observed by one front-end: local rebalance
        via the ElasticManager, liveness gossip to every peer."""
        with self._flight_op("node_join", grid_node=grid_node,
                             observed_by=observed_by):
            fe = self.frontends[observed_by]
            plan = ElasticManager(fe.catalog,
                                  self.store).node_join(grid_node)
            fe.gossip.observe_liveness(grid_node, True)
            return plan

    def frontend_leave(self, index: int) -> None:
        """Silent FRONT-END crash: the member stops emitting gossip and
        lease refreshes and stops receiving (its inbox is discarded).  No
        message is sent — peers find out the slow way: leases it held
        expire after one TTL, and adoptees of its streams fall back
        (shared cache first, own rescan on a miss).  Its own queued work
        is stranded, as a real crash strands it."""
        with self._flight_op("frontend_leave", index=index):
            self.frontends[index].alive = False

    def ban_frontend(self, index: int, *, by: int = 0) -> None:
        """Policy ban of a front-end (the failure policy's verdict
        applied at the service tier): the member leaves as in
        :meth:`frontend_leave`, AND front-end ``by`` broadcasts a lease
        revocation for it — adoptees fall back on the next pump instead
        of waiting out the TTL (the fast path for *known*-bad owners)."""
        with self._flight_op("ban_frontend", index=index, by=by):
            self.frontend_leave(index)
            observer = self.frontends[by]
            if observer.leases is not None:
                observer.leases.revoke_owner(self.frontends[index].node_id)

    # ------------------------------------------------------------------ #
    def fleet_stats(self) -> dict:
        """Aggregated service/cache counters across the fleet (plus the
        shared tier's own counters when enabled)."""
        agg = {"submitted": 0, "served": 0, "rejected": 0, "cache_hits": 0,
               "l2_hits": 0, "events_scanned": 0, "fragment_evals": 0,
               "adopted": 0, "lease_fallbacks": 0}
        for fe in self.frontends:
            s = fe.service.stats
            agg["submitted"] += s.submitted
            agg["served"] += s.served
            agg["rejected"] += s.rejected
            agg["cache_hits"] += s.cache_hits
            agg["events_scanned"] += s.events_scanned
            agg["fragment_evals"] += s.fragment_evals
            agg["adopted"] += s.adopted
            agg["lease_fallbacks"] += s.lease_fallbacks
            agg["l2_hits"] += fe.service.cache.stats.l2_hits
        agg["hit_rate"] = agg["cache_hits"] / max(1, agg["submitted"])
        if self.l2 is not None:
            agg["l2_entries"] = len(self.l2)
            agg["l2_fragment_puts"] = self.l2.stats.fragment_puts
        return agg

    # ------------------------- observability -------------------------- #
    def metrics_snapshot(self) -> Optional[MetricsSnapshot]:
        """Fleet-merged metrics: every front-end's registry plus the
        fleet-level registry (bus/L2 counters), combined through the same
        ``tree_merge`` machinery the result path uses.  ``None`` when the
        fleet was built without ``obs=True``."""
        snaps = [fe.obs.metrics.snapshot() for fe in self.frontends
                 if fe.obs is not None]
        if self.fleet_metrics is not None:
            snaps.append(self.fleet_metrics.snapshot())
        if not snaps:
            return None
        return merge_snapshots(snaps)

    def trace_records(self) -> List[dict]:
        """All front-ends' span/event records merged and ordered by
        virtual start time — one fleet-wide timeline (span ids stay
        unique per ``process``, which is how the schema scopes them)."""
        recs: List[dict] = []
        for fe in self.frontends:
            if fe.obs is not None:
                recs.extend(fe.obs.tracer.records())
        recs.sort(key=lambda r: (r["t0_virtual"], r["process"],
                                 r["span_id"]))
        return recs

    def save_trace_jsonl(self, path) -> int:
        """Write the fleet-merged JSONL trace; returns records written."""
        recs = self.trace_records()
        trace_lib.save_jsonl(recs, path)
        return len(recs)

    def save_chrome_trace(self, path) -> int:
        """Write the fleet-merged Chrome/Perfetto trace; returns records
        exported."""
        recs = self.trace_records()
        trace_lib.save_chrome(recs, path)
        return len(recs)

    def health_report(self) -> Optional[HealthReport]:
        """Fleet-wide node health: every front-end monitor's digest merged
        into one view (the converged picture gossip drives each member
        toward).  ``None`` without ``obs=True``."""
        monitors = [fe.obs.health for fe in self.frontends
                    if fe.obs is not None]
        if not monitors:
            return None
        agg = HealthMonitor(origin="fleet")
        for m in monitors:
            agg.merge_digest(m.digest())
        return agg.report()

    def close(self) -> None:
        """Shut the fleet down: checkpoint the L2 (when ``l2_path`` is
        configured), close every front-end's service (cache hooks
        detached) and detach every gossip node from its catalogue — a
        long-lived catalogue accumulates no dead hooks."""
        with self._flight_op("close"):
            self._flight_finalize()
            if self.l2 is not None and self.l2_path is not None:
                self.l2.save(self.l2_path)
            for fe in self.frontends:
                fe.service.close()
                fe.gossip.detach()
