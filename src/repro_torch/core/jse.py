"""Job Submission Engine (JSE) — the paper's section 4.2 dataflow:

  user submits job -> meta-data catalogue -> JSE broker picks it up ->
  per-brick tasks dispatched to the nodes owning the data -> per-node
  results -> merged at the JSE -> catalogue updated -> user retrieves.

Two execution realizations share this module's primitives:

- ``run_job_simulated``: an event-driven virtual-time grid simulation over
  the host-level BrickStore.  Compute on each packet is REAL (numpy query
  evaluation on the actual brick slice), time is virtual (node speeds,
  staging overhead, result transfer) — this is what reproduces the paper's
  Fig 7 crossover and exercises straggler mitigation / failover.

- ``spmd_query_step``: the lockstep realization — one step over a
  device-resident event batch (bricks = shards that never move), with the
  merge expressed as reductions on the device.

The service layer does not call either directly anymore: it programs
against the :class:`~repro_torch.core.backend.ExecutionBackend` contract
(``core/backend.py``), whose ``SimulatedBackend`` wraps the simulation
below and whose ``SpmdBackend`` runs the fragment plan as a chunked
streaming scan over the brick shards.  :func:`eval_plan_slice` is the
one compute primitive both backends share, which is what keeps their
per-packet partials bit-identical.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core import merge as merge_lib
from repro_torch.core import query as query_lib
from repro_torch.core.brick import BrickStore
from repro_torch.core.catalog import DONE, FAILED, RUNNING, MetadataCatalog
from repro_torch.core.packets import AdaptivePacketScheduler
from repro_torch.core.replication import failover_owner
from repro_torch.kernels import resolve_device


@dataclasses.dataclass
class TimeModel:
    """Virtual-time constants (calibrated to the paper's fast-Ethernet grid:
    the Fig-7 crossover sits near 2000 events)."""
    t_event_s: float = 2.0e-3          # per-event processing on a 1x node
    stage_overhead_s: float = 1.15     # executable staging (GRAM) per node
    dispatch_latency_s: float = 0.05   # per-packet control round trip
    result_bytes: float = 2.0e5        # per-node result file (per query)
    bandwidth_Bps: float = 12.5e6      # 100 Mbit/s fast Ethernet
    merge_per_node_s: float = 0.02     # JSE merge cost per partial result
    brick_bytes_per_event: float = 2.0e3  # on-disk brick payload per event
    # (re-replication ships whole bricks: n_events x brick_bytes_per_event
    # over the same fast-Ethernet links, charged on BOTH endpoints)

    # A shared scan is read-dominated: evaluating K stacked predicates on a
    # resident slice costs the same sweep as one (the extra FLOPs hide under
    # the HBM/disk read), so per-packet compute is charged once per batch.
    # Only the result files and the JSE merge scale with K.


@dataclasses.dataclass(frozen=True)
class PacketPartial:
    """One packet's partial results, announced the moment the virtual node
    finishes computing them — the unit of streaming result delivery.

    ``partials`` holds one :class:`~repro_torch.core.merge.QueryResult` per plan
    target (per-query roots first, then materialized shared fragments),
    exactly the row the batch path appends to its merge input.  ``seq`` is
    the packet's position in merge order: feeding partials to a
    :class:`~repro_torch.core.merge.MergeAccumulator` in ``seq`` order makes
    every prefix snapshot bit-identical to the final ``tree_merge``.
    ``t_virtual`` is the packet's compute-completion time on the simulated
    grid clock (the same clock as ``JobStats.makespan_s``), and
    ``failures`` the cumulative node deaths observed so far (coverage
    holes; see ``docs/streaming.md``)."""
    seq: int
    brick_id: int
    start: int
    size: int
    node: int
    t_virtual: float
    failures: int
    partials: List[merge_lib.QueryResult]


@dataclasses.dataclass(frozen=True)
class PacketTelemetry:
    """Measured compute for one evaluated packet: events in the slice,
    calibration iterations applied, distinct track aggregates the
    fragment-factored pass swept, the number of plan targets the packet
    evaluated (the whole window rides one measurement — the fitter
    normalizes per target so window width is not an omitted variable),
    and the REAL (wall-clock) evaluation time.  This is the per-packet
    observable the planner's cost-model calibration
    (``planner.fit_cost_weights``) regresses on — virtual time charges a
    flat per-event rate, but the actual tensor compute scales with
    calibration and aggregate depth.

    ``node`` attributes the measurement to the grid node that scanned the
    packet (-1 when unknown) — the observability plane's health monitor
    (``repro_torch.obs.health``) folds these into per-node latency EWMAs."""
    size: int
    calib_iters: int
    n_aggregates: int
    wall_s: float
    n_targets: int = 1
    node: int = -1


@dataclasses.dataclass
class JobStats:
    """Execution telemetry for one (batched) simulated grid job: virtual
    makespan, per-node busy time, packet/failure counts, events swept, and
    the planner's fragment accounting."""
    makespan_s: float = 0.0
    per_node_busy: Dict[int, float] = dataclasses.field(default_factory=dict)
    packets: int = 0
    failures: int = 0
    reassigned: int = 0
    # failure-policy accounting: speculative duplicate executions of
    # straggling packets attempted / won (first-result-wins), and packets
    # the routing policy kept away from banned nodes
    speculated: int = 0
    spec_wins: int = 0
    # virtual seconds of brick-copy traffic charged for proactive
    # re-replication applied to this window (both endpoints busy while the
    # copy streams — data movement is never free)
    rereplication_transfer_s: float = 0.0
    events_scanned: int = 0   # brick events swept (shared across a batch)
    # events whose chunk ran (at least partly) through the fused Pallas
    # kernel sub-batch — 0 on the simulation and on plain-path SPMD windows
    kernel_events: int = 0
    n_queries: int = 1        # queries amortized over that sweep
    # fragment accounting (common-subexpression factoring across the batch)
    fragment_evals: int = 0           # unique-fragment evaluations performed
    fragment_evals_unshared: int = 0  # what K independent compiles would do
    # merged results for materialized shared fragments, keyed by fragment
    # canonical (query_lib.node_key) — fed to the fragment-level cache
    fragment_results: Dict[str, merge_lib.QueryResult] = \
        dataclasses.field(default_factory=dict)
    # per-packet compute observations for cost-model calibration
    packet_telemetry: List[PacketTelemetry] = \
        dataclasses.field(default_factory=list)


def prepare_window(catalog: MetadataCatalog, job_ids: List[int],
                   plan: Optional[query_lib.FragmentPlan] = None):
    """Validate one shared-scan window and mark its jobs RUNNING — the
    common preamble of every backend's ``run_batch``.

    Checks shared-scan compatibility (every job must cover the same
    bricks with the same ``calib_iters``), builds the fragment plan when
    none was passed, and verifies a passed plan's roots align one-to-one
    with the jobs.  Returns ``(rec, plan)`` where ``rec`` is the window's
    representative job record.  Keeping this in ONE place is what keeps
    the backends' preconditions from diverging."""
    recs = [catalog.jobs[j] for j in job_ids]
    if not recs:
        raise ValueError("empty job batch")
    rec = recs[0]
    for r in recs[1:]:
        if r.bricks != rec.bricks or r.calib_iters != rec.calib_iters:
            raise ValueError(
                f"job {r.job_id} incompatible with shared scan "
                f"(bricks/calib_iters differ from job {rec.job_id})")
    for jid in job_ids:
        catalog.update(jid, status=RUNNING, start_time=time.time())
    if plan is None:
        plan = query_lib.build_fragment_plan([r.expr for r in recs])
    elif len(plan.roots) != len(recs):
        raise ValueError(
            f"plan has {len(plan.roots)} roots for {len(recs)} jobs")
    return rec, plan


def eval_plan_slice(store: BrickStore, plan: query_lib.FragmentPlan,
                    brick_id: int, start: int, size: int,
                    calib_iters: int) -> List[merge_lib.QueryResult]:
    """One slice read + one calibration + one fragment-factored pass —
    the shared-scan inner loop every execution backend runs (the slice is
    resident while every in-flight query consumes it).  Returns one
    partial per plan target (per-query roots first, then materialized
    shared fragments).

    This is deliberately the ONLY place a brick slice is turned into
    partials: the simulated and SPMD backends (``core/backend.py``) both
    call it, so a packet covering the same ``[start, start+size)`` range
    of the same brick yields bit-identical partials on either backend.

    The slice is a view of the device-resident brick; the plan runs on
    the brick's device and the masks come back to the host for the numpy
    :func:`~repro_torch.core.merge.from_mask`."""
    batch = store.bricks[brick_id]
    sl = {k: v[start:start + size] for k, v in batch.items()}
    if calib_iters:
        sl = dict(sl, tracks=query_lib.calibrate(sl, calib_iters))
    var = sl["scalars"][:, 0].cpu().numpy()  # e_total summary variable
    ids = sl["event_id"].cpu().numpy()
    masks = plan.evaluate(sl, store.schema)
    return [merge_lib.from_mask(m.cpu().numpy(), var, ids) for m in masks]


class JobSubmissionEngine:
    """The paper's JSE broker: submits jobs to the catalogue, fans each one
    out as per-brick packets to the owning nodes, merges the partials, and
    writes the result back.  ``run_job_batch_simulated`` is the shared-scan
    execution engine the service drives; pass ``on_partial`` to stream
    per-packet partial merges out while the job runs."""

    def __init__(self, catalog: MetadataCatalog, store: BrickStore,
                 time_model: Optional[TimeModel] = None,
                 node_speed: Optional[Dict[int, float]] = None,
                 adaptive_packets: bool = True,
                 packet_ramp: Optional[int] = None,
                 ramp_factor: float = 2.0):
        self.catalog = catalog
        self.store = store
        self.tm = time_model or TimeModel()
        self.node_speed = node_speed or {}
        self.adaptive_packets = adaptive_packets
        # stream-aware sizing: cap early packets at `packet_ramp` events,
        # growing by `ramp_factor` per completed packet (None disables)
        self.packet_ramp = packet_ramp
        self.ramp_factor = ramp_factor
        # observability plane (repro_torch.obs.Observability); None = disabled,
        # and every instrumentation site below is a single `is not None`
        # test on the disabled path
        self.obs = None

    # ------------------------------------------------------------------ #
    def submit(self, expr: str, calib_iters: int = 0) -> int:
        """Register a job over every brick in the store; returns a job id."""
        bricks = tuple(sorted(self.store.bricks))
        return self.catalog.submit(expr, calib_iters, bricks)

    def broker_poll(self, failure_script=None) -> Optional[int]:
        """Pick up the next pending job (the paper's polling broker)."""
        rec = self.catalog.next_pending()
        if rec is None:
            return None
        self.run_job_simulated(rec.job_id, failure_script=failure_script)
        return rec.job_id

    # ------------------------------------------------------------------ #
    def _eval_packet_batch(self, plan: query_lib.FragmentPlan, brick_id: int,
                           start: int, size: int, calib_iters: int
                           ) -> List[merge_lib.QueryResult]:
        """Delegates to :func:`eval_plan_slice` (kept as a method for the
        simulation loop and any external caller)."""
        return eval_plan_slice(self.store, plan, brick_id, start, size,
                               calib_iters)

    def run_job_simulated(self, job_id: int, *,
                          failure_script: Optional[Dict[float, int]] = None,
                          on_partial: Optional[
                              Callable[[PacketPartial], None]] = None
                          ) -> Tuple[merge_lib.QueryResult, JobStats]:
        """Event-driven simulation: nodes pull packets, compute (really),
        and finish after a virtual duration; failures re-queue work on the
        surviving replicas (PROOF-style)."""
        merged, stats = self.run_job_batch_simulated(
            [job_id], failure_script=failure_script, on_partial=on_partial)
        return merged[0], stats

    def run_job_batch_simulated(self, job_ids: List[int], *,
                                failure_script: Optional[Dict[float, int]]
                                = None,
                                plan: Optional[query_lib.FragmentPlan] = None,
                                on_partial: Optional[
                                    Callable[[PacketPartial], None]] = None,
                                packet_ramp: Optional[int] = None,
                                route_avoid: Optional[set] = None,
                                probe_quota: Optional[Dict[int, int]] = None,
                                speculate: bool = False,
                                spec_lead_factor: float = 1.5,
                                rereplicated: Optional[
                                    List[Tuple[int, int, int]]] = None
                                ) -> Tuple[List[merge_lib.QueryResult],
                                           JobStats]:
        """Shared-scan execution of K coalesced jobs: ONE sweep over the
        bricks evaluates every job's predicate on each resident packet, so
        the event-store read is amortized K ways.  The batch is compiled
        through a :class:`~repro_torch.core.query.FragmentPlan` (pass ``plan`` to
        reuse one the service planner already built, e.g. with materialized
        shared fragments), so common subexpressions across the K queries are
        evaluated once per packet.  Scheduling, failure handling and the
        per-query merges are identical to K independent
        ``run_job_simulated`` runs — per-query results are bit-identical.

        Returns ``(merged, stats)`` where ``merged[k]`` is job *k*'s result;
        merged results for any materialized shared fragments are in
        ``stats.fragment_results``.

        ``on_partial``, when given, is invoked once per evaluated packet
        with a :class:`PacketPartial`, in the exact order the batch merge
        consumes partials — the streaming delivery hook.  The callback runs
        synchronously inside the scan loop and must not raise; a truncated
        (FAILED) scan still emits the partials computed before the abort,
        but no DONE result ever follows them.

        ``packet_ramp`` overrides the engine-level stream-aware ramp for
        THIS run only (the service enables it per window when someone is
        streaming); None inherits the engine setting.

        ``route_avoid`` / ``probe_quota`` carry the failure policy's
        routing decision (``service/policy.py``): avoided nodes never
        lease a packet this window unless they hold probe quota, in which
        case they lease at most that many packets.  Replica failover
        prefers non-avoided owners; if avoidance would starve the scan,
        availability wins and the policy is ignored.

        ``rereplicated`` charges the data movement of brick copies the
        failure policy applied before this window (``(brick, src, dst)``
        triples): each copy occupies BOTH endpoints for the brick's
        transfer time on the virtual clock before either node leases its
        first packet, and the total lands in
        ``JobStats.rereplication_transfer_s`` — re-replication buys
        resilience with real bandwidth, not for free.

        ``speculate`` enables straggler mitigation: when a node goes idle
        with the queue drained, it re-executes the slowest unresolved
        in-flight packet (first-result-wins).  Because
        :func:`eval_plan_slice` is pure, the duplicate partials are
        bit-identical to the originals and are structurally discarded —
        speculation can only lower a packet's ``t_virtual`` completion,
        never change the merged result.  In this mode partial emission is
        deferred to virtual completion order (stamps stay honest), and
        ``makespan_s`` covers the straggler tail."""
        rec, plan = prepare_window(self.catalog, job_ids, plan)
        failure_script = dict(failure_script or {})

        ramp = packet_ramp if packet_ramp is not None else self.packet_ramp
        sched = AdaptivePacketScheduler(self.catalog, ramp_start=ramp,
                                        ramp_factor=self.ramp_factor)
        if not self.adaptive_packets:
            sched.min = sched.max = sched.base
        dead = self.catalog.dead_nodes()
        # routing policy: banned nodes never lease; probing nodes lease at
        # most their probe quota.  Availability beats policy — if avoidance
        # would leave no usable node, it is ignored wholesale.
        avoid = set(route_avoid or ()) - set(dead)
        quota = dict(probe_quota or {})
        alive_all = self.catalog.alive_nodes()
        usable = [n for n in alive_all
                  if n not in avoid or quota.get(n, 0) > 0]
        if not usable:
            avoid, quota = set(), {}
            usable = list(alive_all)
        banned = {n for n in avoid if quota.get(n, 0) <= 0}
        n_alive = max(1, len(usable))
        total_events = sum(self.store.specs[b].n_events for b in rec.bricks)
        if self.adaptive_packets:
            # PROOF base sizing: ~8 packets per node over the job, adapted
            # per node by throughput and shrunk as the queue drains
            sched.base = max(sched.min, total_events // (4 * n_alive))
        brick_node: Dict[int, int] = {}
        lost = []
        unavailable = set(dead) | banned
        for bid in rec.bricks:
            # replica-aware re-targeting: prefer an owner that is neither
            # dead nor banned; fall back to any live owner rather than
            # declare the brick lost (availability over policy)
            owner = failover_owner(self.store.owners(bid), unavailable)
            if owner < 0:
                owner = failover_owner(self.store.owners(bid), dead)
            if owner < 0:
                lost.append(bid)
                continue
            brick_node[bid] = owner
            sched.add_work(bid, self.store.specs[bid].n_events)

        if lost:
            for jid in job_ids:
                self.catalog.update(jid, status=FAILED,
                                    note=f"bricks lost (no replica): {lost}")
            return ([merge_lib.QueryResult() for _ in job_ids],
                    JobStats(n_queries=len(job_ids)))

        obs = self.obs
        stats = JobStats(n_queries=len(job_ids))
        plan_aggs = query_lib.unique_aggregates(plan.targets())
        results: List[List[merge_lib.QueryResult]] = []
        # re-replication transfer charge: each applied copy streams one
        # whole brick src -> dst, occupying both endpoints before they can
        # lease packets (the window pays for the policy's data movement)
        busy0: Dict[int, float] = {}
        for bid, src, dst in (rereplicated or ()):
            spec = self.store.specs.get(bid)
            if spec is None:
                continue
            xfer = (spec.n_events * self.tm.brick_bytes_per_event
                    / self.tm.bandwidth_Bps)
            busy0[src] = busy0.get(src, 0.0) + xfer
            busy0[dst] = busy0.get(dst, 0.0) + xfer
            stats.rereplication_transfer_s += xfer
        # virtual clock: heap of (t_free, node); staging charged on first use
        now = 0.0
        free_at: Dict[int, float] = {n: busy0.get(n, 0.0) for n in usable}
        heap = [(free_at[n], n) for n in usable]
        heapq.heapify(heap)
        staged: set = set()
        deadlines = sorted(failure_script)  # virtual times at which nodes die

        def push(t: float, n: int) -> None:
            # `free_at` names each node's live heap entry, so a speculation
            # win can cancel the loser by re-pushing it earlier (the stale
            # entry is skipped at pop time)
            free_at[n] = t
            heapq.heappush(heap, (t, n))

        def speed(n):
            return self.node_speed.get(n, 1.0)

        # speculation state: per-seq virtual completion of in-flight
        # packets; spec mode defers partial emission to completion order
        spec_open: Dict[int, dict] = {}
        emit_buf: Dict[int, PacketPartial] = {}
        emit_next = 0

        def flush_partials(t_now: Optional[float]) -> None:
            # emit buffered partials in seq order once the packet's virtual
            # completion has passed (t_now=None flushes everything)
            nonlocal emit_next
            while emit_next in emit_buf:
                info = spec_open.get(emit_next)
                if t_now is not None and info is not None \
                        and info["t_done"] > t_now:
                    break
                pp = emit_buf.pop(emit_next)
                if info is not None:
                    pp = dataclasses.replace(pp, t_virtual=info["t_done"],
                                             node=info["node"])
                    spec_open.pop(emit_next)
                if on_partial is not None:
                    on_partial(pp)
                emit_next += 1

        def spec_pending() -> bool:
            # unresolved, not-yet-duplicated in-flight completions: what
            # keeps the loop alive after the queue drains in spec mode so
            # idle nodes get their chance to re-execute the stragglers
            return any(i["t_done"] > now and not i["spec"]
                       for i in spec_open.values())

        while not sched.exhausted or (speculate and heap and spec_pending()):
            if not heap:
                live = self.catalog.alive_nodes()
                if avoid and live:
                    # the routing policy starved the scan (every routable
                    # node out of budget): availability wins, re-admit all
                    avoid, quota = set(), {}
                    for n in live:
                        push(now, n)
                    continue
                break
            t_free, node = heapq.heappop(heap)
            if free_at.get(node, t_free) != t_free:
                continue  # superseded by a speculation cancel/re-push
            now = max(now, t_free)
            if speculate:
                flush_partials(now)
            # failure injection
            while deadlines and deadlines[0] <= now:
                t_kill = deadlines.pop(0)
                victim = failure_script[t_kill]
                if self.catalog.node(victim).alive:
                    self.catalog.mark_dead(victim)
                    sched.requeue_node(victim)
                    stats.failures += 1
                    stats.reassigned += 1
                    if obs is not None:
                        obs.tracer.event(
                            "node_death",
                            t_virtual=obs.tracer.virtual_base + now,
                            node=victim)
                        obs.metrics.counter("grid.node_deaths").inc()
                        obs.health.observe_failure(victim)
            if not self.catalog.node(node).alive:
                continue
            if node in avoid and quota.get(node, 0) <= 0:
                continue  # probe budget exhausted: out of this window
            pkt = sched.next_packet(node)
            if pkt is None:
                if speculate:
                    cand = [(info["t_done"], -seq, seq, info)
                            for seq, info in spec_open.items()
                            if info["t_done"] > now and not info["spec"]
                            and info["node"] != node]
                    if cand:
                        _, _, seq, info = max(cand)
                        dur2 = (self.tm.dispatch_latency_s
                                + info["size"] * self.tm.t_event_s
                                / speed(node))
                        if node not in staged:
                            dur2 += self.tm.stage_overhead_s
                        if info["t_done"] - now > spec_lead_factor * dur2:
                            # duplicate execution of the straggling slice:
                            # eval_plan_slice is pure, so the duplicate is
                            # bit-identical to the row already appended at
                            # lease time and is discarded — structural
                            # first-result-wins, no double merge possible
                            dup = self._eval_packet_batch(
                                plan, info["brick"], info["start"],
                                info["size"], rec.calib_iters)
                            identical = all(
                                merge_lib.results_identical(a, b)
                                for a, b in zip(results[seq], dup))
                            staged.add(node)
                            info["spec"] = True
                            stats.speculated += 1
                            t_spec = now + dur2
                            win = t_spec < info["t_done"]
                            if obs is not None:
                                obs.tracer.event(
                                    "speculate",
                                    t_virtual=obs.tracer.virtual_base + now,
                                    seq=seq, node=node,
                                    origin_node=info["node"], win=win,
                                    identical=identical)
                                obs.metrics.counter(
                                    "policy.speculations").inc()
                            if win:
                                stats.spec_wins += 1
                                if obs is not None:
                                    obs.metrics.counter(
                                        "policy.spec_wins").inc()
                                loser = info["node"]
                                info["node"] = node
                                info["t_done"] = t_spec
                                # first result wins: the loser is cancelled
                                # and frees when the winner completes
                                push(t_spec, loser)
                                stats.per_node_busy[node] = \
                                    stats.per_node_busy.get(node, 0) + dur2
                                push(t_spec, node)
                            else:
                                # the original finishes first; the
                                # speculating node abandons at that moment
                                stats.per_node_busy[node] = \
                                    stats.per_node_busy.get(node, 0) \
                                    + (info["t_done"] - now)
                                push(info["t_done"], node)
                            continue
                if sched.inflight:
                    push(now + 0.01, node)
                continue
            pkt_span = None
            if obs is not None:
                pkt_span = obs.tracer.begin(
                    "packet", t_virtual=obs.tracer.virtual_base + now,
                    seq=len(results), brick=pkt.brick_id, start=pkt.start,
                    size=pkt.size, node=node)
            t_wall = time.perf_counter()
            res = self._eval_packet_batch(plan, pkt.brick_id,
                                          pkt.start, pkt.size,
                                          rec.calib_iters)
            wall_s = time.perf_counter() - t_wall
            stats.packet_telemetry.append(PacketTelemetry(
                size=pkt.size, calib_iters=rec.calib_iters,
                n_aggregates=plan_aggs, wall_s=wall_s,
                n_targets=len(plan.targets()), node=node))
            results.append(res)
            stats.events_scanned += pkt.size
            stats.fragment_evals += plan.evals_per_batch
            stats.fragment_evals_unshared += plan.unshared_evals
            compute = pkt.size * self.tm.t_event_s / speed(node)
            dur = self.tm.dispatch_latency_s + compute
            if node not in staged:
                dur += self.tm.stage_overhead_s
                staged.add(node)
            if obs is not None:
                obs.tracer.end(
                    pkt_span,
                    t_virtual=obs.tracer.virtual_base + now + dur)
                obs.metrics.counter("packet.count").inc()
                obs.metrics.histogram("packet.latency_s").observe(wall_s)
                obs.metrics.histogram("packet.events").observe(pkt.size)
                obs.health.observe_packet(node, pkt.size, wall_s)
            seq = len(results) - 1
            if speculate:
                spec_open[seq] = {"node": node, "t_done": now + dur,
                                  "brick": pkt.brick_id, "start": pkt.start,
                                  "size": pkt.size, "spec": False}
                if on_partial is not None:
                    emit_buf[seq] = PacketPartial(
                        seq=seq, brick_id=pkt.brick_id, start=pkt.start,
                        size=pkt.size, node=node, t_virtual=now + dur,
                        failures=stats.failures, partials=res)
            elif on_partial is not None:
                on_partial(PacketPartial(
                    seq=seq, brick_id=pkt.brick_id,
                    start=pkt.start, size=pkt.size, node=node,
                    t_virtual=now + dur, failures=stats.failures,
                    partials=res))
            # throughput telemetry sees compute only — staging/dispatch in
            # the EMA would shrink every node's packets (GRIS reports CPU
            # rate, not control-plane latency)
            sched.complete(pkt.packet_id, pkt.size, compute)
            stats.per_node_busy[node] = stats.per_node_busy.get(node, 0) + dur
            stats.packets += 1
            if node in avoid:
                quota[node] = quota.get(node, 0) - 1
            push(now + dur, node)

        if speculate:
            # the virtual clock stops at the last LEASE; the straggler tail
            # (unresolved completions) is exactly what speculation shortens,
            # so spec-mode makespan accounts for it before flushing
            now = max([i["t_done"] for i in spec_open.values()] + [now])
            flush_partials(None)

        if not sched.exhausted:
            # every node died with work outstanding: the scan is truncated,
            # never a DONE result (a cached partial would poison repeats)
            for jid in job_ids:
                self.catalog.update(jid, status=FAILED,
                                    note="scan aborted: all nodes dead "
                                         "with packets outstanding")
            return ([merge_lib.QueryResult() for _ in job_ids], stats)

        # result transfer + JSE merge (both scale with the batch width)
        k = len(job_ids)
        n_active = len(stats.per_node_busy)
        transfer = k * self.tm.result_bytes / self.tm.bandwidth_Bps
        merged = (merge_lib.merge_batch(results) if results
                  else [merge_lib.QueryResult()
                        for _ in range(len(plan.targets()))])
        # plan targets are roots first, then materialized shared fragments
        stats.fragment_results = dict(
            zip(plan.materialize_keys(), merged[k:]))
        merged = merged[:k]
        makespan = now + transfer + k * n_active * self.tm.merge_per_node_s
        stats.makespan_s = makespan

        end = time.time()
        for jid, m in zip(job_ids, merged):
            self.catalog.update(
                jid, status=DONE, end_time=end,
                events_processed=m.n_processed, failures=stats.failures,
                result={
                    "n_selected": m.n_selected,
                    "n_processed": m.n_processed,
                    "sum_var": m.sum_var,
                    "makespan_s": makespan,
                })
        return merged, stats

    def single_node_time(self, n_events: int, calib_iters: int = 0,
                         node_speed: float = 1.0) -> float:
        """The paper's 'running only on hobbit' baseline (tightly coupled:
        no staging to remote nodes, no result transfer)."""
        return n_events * self.tm.t_event_s / node_speed


# --------------------------------------------------------------------------- #
# SPMD realization: the whole grid job as ONE lockstep step on the device
# --------------------------------------------------------------------------- #
def _step_batch(batch, device: torch.device) -> dict:
    """The step's input on its device (numpy arrays or tensors)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _hist_index(var: torch.Tensor) -> torch.Tensor:
    """Histogram bin of each event's summary variable (int64)."""
    lo, hi = merge_lib.HIST_RANGE
    width = (hi - lo) / merge_lib.HIST_BINS
    return torch.clamp(((var - lo) / width).to(torch.int32), 0,
                       merge_lib.HIST_BINS - 1).long()


def spmd_query_step(expr: str, schema: ev.EventSchema, calib_iters: int = 0,
                    use_pallas: bool = False,
                    device: Union[str, torch.device] = "cuda") -> Callable:
    """Returns fn(batch)->dict of merged results, computed on ``device``.

    The per-event compute (predicate + calibration) and the merge (sums
    over the event axis) both run where the batch lives; ``use_pallas``
    sends the canonical hot family through the fused event-filter kernel
    (the plain version on a CPU device).  All sums are float32."""
    dev = resolve_device(device)

    def step(batch):
        batch = _step_batch(batch, dev)
        if use_pallas:
            # the kernel fuses calibration with the reduction: raw batch in
            from repro_torch.kernels.event_filter import ops as ef_ops
            mask, var = ef_ops.filter_and_summarize(
                expr, schema, batch, calib_iters=calib_iters)
        else:
            pred = query_lib.compile_query(expr, schema)
            b = batch
            if calib_iters:
                b = dict(b, tracks=query_lib.calibrate(b, calib_iters))
            mask = pred(b)
            var = b["scalars"][:, 0]
        maskf = (mask != 0).float()
        onehot = torch.nn.functional.one_hot(
            _hist_index(var), merge_lib.HIST_BINS).float()
        hist = torch.sum(onehot * maskf[:, None], dim=0)
        return {
            "n_selected": torch.sum(maskf),
            "n_processed": torch.tensor(float(maskf.shape[0]),
                                        device=dev),
            "sum_var": torch.sum(var * maskf),
            "hist": hist,
        }

    return step


def spmd_query_batch_step(exprs: List[str], schema: ev.EventSchema,
                          calib_iters: int = 0,
                          use_pallas: bool = False,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Callable:
    """Batched twin of ``spmd_query_step``: ONE lockstep pass over the
    device-resident event batch evaluates K queries, returning a dict
    whose leaves carry a leading K axis.  The event read (and the
    calibration pass) is done once and amortized over every query — the
    lockstep realization of the service's shared scan.

    The two products below run in full float32: TF32 would round ``var``
    in ``maskf @ var``.  They go through :func:`_matmul_fp32`, which turns
    TF32 off for the call whatever the process-wide setting."""
    dev = resolve_device(device)

    def step(batch):
        batch = _step_batch(batch, dev)
        if use_pallas:
            from repro_torch.kernels.event_filter import ops as ef_ops
            masks, var = ef_ops.filter_and_summarize_batch(
                exprs, schema, batch, calib_iters=calib_iters)
        else:
            bpred = query_lib.compile_query_batch(exprs, schema)
            b = batch
            if calib_iters:
                b = dict(b, tracks=query_lib.calibrate(b, calib_iters))
            masks = bpred(b)                      # (K, N)
            var = b["scalars"][:, 0]
        # one memory layout on both paths: a product's summation order may
        # follow its operands' strides, and the kernel's var is contiguous
        var = var.contiguous()
        maskf = (masks != 0).float()              # (K, N)
        onehot = torch.nn.functional.one_hot(
            _hist_index(var), merge_lib.HIST_BINS).float()
        return {
            "n_selected": torch.sum(maskf, dim=-1),
            "n_processed": torch.full((maskf.shape[0],),
                                      float(maskf.shape[1]),
                                      dtype=torch.float32, device=dev),
            "sum_var": _matmul_fp32(maskf, var),
            "hist": _matmul_fp32(maskf, onehot),  # (K, HIST_BINS)
        }

    return step


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 (no TF32), restoring the caller's
    setting afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
