"""Failure policy engine: the RSS-style *acting* half of failure handling.

The paper names node failure as the Grid-Brick design's biggest
disadvantage, with replication as the workaround.  The health plane is
the *seeing* half — per-node latency/failure EWMAs gossiped fleet-wide
(``obs/health.py``).  This module turns that evidence into action, the
shape DIRAC's Resource Status System gives it: an explicit per-node
state machine driving routing, mitigation, and recovery.

State machine (one transition per decision window, hysteresis counters
so it cannot oscillate)::

            unhealthy x degrade_after      suspect x ban_after
      ok ────────────────────────▶ degraded ────────────────▶ banned
       ▲                            │    ▲                      │
       │   healthy x recover_after  │    │ (probe fails)        │ dwell
       └────────────────────────────┘    │                      │ probe_after
       ▲                                 │                      ▼
       └──────── clean x probe_packets ──┴───────────────── probing

- **ok → degraded**: ``degrade_after`` consecutive windows of unhealthy
  evidence (degraded or suspect classification from the
  :class:`~repro_torch.obs.health.HealthReport`).
- **degraded → ok**: ``recover_after`` consecutive clean windows — the
  hysteresis band that stops a borderline node from flapping.
- **degraded → banned**: ``ban_after`` consecutive *suspect* windows.
  Banned nodes are excluded from packet routing entirely.
- **banned → probing**: after ``probe_after`` windows of dwell the node
  gets ``probe_packets`` of probe quota per window — it leases at most
  that many packets, so a still-sick node damages one probe, not a scan.
- **probing → ok**: ``probe_packets`` clean probe packets observed.  The
  probes themselves are the fresh evidence: each clean packet also decays
  the node's failure EWMA in the health monitor, so by the time the probe
  budget clears, the stale verdict that banned the node has decayed too.
- Dead nodes (catalogue liveness) are forced to **banned**, so a later
  rejoin re-enters service through probing, never straight to ok.

Routing consumes the decision three ways: the engine's pull heap skips
avoided nodes (``route_avoid`` / ``probe_quota`` on
``run_job_batch_simulated``), brick failover prefers owners that are
neither dead nor banned (:func:`~repro_torch.core.replication.failover_owner`
over ``dead | banned``), and the :class:`~repro_torch.service.scheduler
.QueryScheduler` narrows admission windows by the routable fraction.
Availability always beats policy: if avoidance would starve a scan the
engine ignores it wholesale.

Sustained degradation (``rereplicate_after`` consecutive unhealthy
windows) triggers proactive re-replication: the policy treats the sick
node as already lost, runs
:func:`~repro_torch.core.replication.rereplication_plan`, and applies the
copies to the store — so when the node *does* die, failover finds a
fresh replica instead of a hole.

Speculative re-execution of straggler packets rides the same decision
(``speculate`` / ``spec_lead_factor`` pass through to the engine);
see ``docs/policy.md`` for the first-result-wins correctness argument.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.brick import BrickStore
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.core.replication import rereplication_plan
from repro_torch.obs.health import (HEALTH_OK, HEALTH_SUSPECT, HealthReport)

POLICY_OK = "ok"
POLICY_DEGRADED = "degraded"
POLICY_PROBING = "probing"
POLICY_BANNED = "banned"
POLICY_STATES = (POLICY_OK, POLICY_DEGRADED, POLICY_PROBING, POLICY_BANNED)


@dataclasses.dataclass
class PolicyConfig:
    """Hysteresis thresholds and mitigation knobs (all counted in
    decision windows, i.e. calls to :meth:`FailurePolicy.decide`).

    ``rate_evidence`` gates the relative-rate classifications from the
    health report; with it off only failure-EWMA evidence (node deaths)
    counts — deterministic regardless of host wall-clock noise, which is
    what the scenario matrix runs with."""
    degrade_after: int = 2       # unhealthy windows before ok -> degraded
    recover_after: int = 2       # clean windows before degraded -> ok
    ban_after: int = 3           # suspect windows before degraded -> banned
    probe_after: int = 4         # banned dwell windows before probing
    probe_packets: int = 3       # probe quota per window / clean probes to ok
    rereplicate_after: int = 3   # unhealthy windows before re-replication
    failure_threshold: float = 0.3   # failure EWMA that reads as suspect
    rate_evidence: bool = True   # trust relative-rate classifications
    speculate: bool = True       # straggler speculative re-execution
    spec_lead_factor: float = 1.5    # min remaining/duplicate time ratio


@dataclasses.dataclass
class NodeState:
    """One node's position in the state machine plus its hysteresis
    counters (consecutive-window streaks, probe/ban bookkeeping)."""
    node: int
    state: str = POLICY_OK
    unhealthy: int = 0       # consecutive unhealthy windows (in ok)
    healthy: int = 0         # consecutive clean windows (in degraded)
    suspect_streak: int = 0  # consecutive suspect windows (in degraded)
    banned_for: int = 0      # dwell windows since ban
    probe_ok: int = 0        # clean probe packets observed
    degraded_run: int = 0    # windows spent not-ok (re-replication clock)
    rereplicated: bool = False   # this sickness episode already re-replicated


@dataclasses.dataclass
class PolicyDecision:
    """One window's routing verdict: nodes to avoid, per-node probe
    quotas, the transitions taken, and re-replication copies applied."""
    avoid: set = dataclasses.field(default_factory=set)
    probe_quota: Dict[int, int] = dataclasses.field(default_factory=dict)
    transitions: List[Tuple[int, str, str]] = \
        dataclasses.field(default_factory=list)
    rereplicated: List[Tuple[int, int, int]] = \
        dataclasses.field(default_factory=list)
    speculate: bool = False
    spec_lead_factor: float = 1.5

    def backend_kwargs(self) -> Dict:
        """Keyword arguments for a routing-capable backend's
        ``run_batch`` (``SimulatedBackend.supports_routing_policy``)."""
        return {"route_avoid": set(self.avoid),
                "probe_quota": dict(self.probe_quota),
                "speculate": self.speculate,
                "spec_lead_factor": self.spec_lead_factor,
                "rereplicated": list(self.rereplicated)}


class FailurePolicy:
    """Per-node state machine over health evidence, one decision per
    dispatch window.

    Drive it with :meth:`decide` (before ``run_batch``, feeding the
    current :class:`~repro_torch.obs.health.HealthReport`) and
    :meth:`observe_window` (after, feeding the window's
    :class:`~repro_torch.core.jse.JobStats` so probe outcomes resolve).  The
    service (:class:`~repro_torch.service.frontend.QueryService`) does both
    when constructed with ``policy=``."""

    def __init__(self, catalog: MetadataCatalog, store: BrickStore, *,
                 obs=None, config: Optional[PolicyConfig] = None):
        self.catalog = catalog
        self.store = store
        self.obs = obs
        self.config = config or PolicyConfig()
        self.nodes: Dict[int, NodeState] = {
            n: NodeState(node=n) for n in range(store.n_nodes)}
        self.rereplications = 0
        # flight-recorder scope (repro_torch.obs.flight.FlightScope); None =
        # off.  Records transitions, re-replication and decisions.
        self.flight = None

    # --------------------------- transitions -------------------------- #
    def _transition(self, st: NodeState, new: str,
                    decision: Optional[PolicyDecision] = None):
        old = st.state
        if old == new:
            return
        st.state = new
        st.unhealthy = st.healthy = st.suspect_streak = 0
        if new == POLICY_BANNED:
            st.banned_for = 0
        if new == POLICY_PROBING:
            st.probe_ok = 0
        if new == POLICY_OK:
            st.degraded_run = 0
            st.rereplicated = False
        if decision is not None:
            decision.transitions.append((st.node, old, new))
        if self.flight is not None:
            self.flight.record("policy_transition", node=st.node,
                               old=old, new=new)
        if self.obs is not None:
            self.obs.tracer.event(
                "policy_transition",
                t_virtual=self.obs.tracer.virtual_base,
                node=st.node, old=old, new=new)
            self.obs.metrics.counter(f"policy.to_{new}").inc()

    def _evidence(self, node: int, report: Optional[HealthReport]) -> str:
        """Map the report onto this node: suspect on failure evidence
        over threshold always; rate classifications only when trusted."""
        if report is None:
            return HEALTH_OK
        if report.failures.get(node, 0.0) >= self.config.failure_threshold:
            return HEALTH_SUSPECT
        if self.config.rate_evidence:
            return report.states.get(node, HEALTH_OK)
        return HEALTH_OK

    def _rereplicate(self, st: NodeState, decision: PolicyDecision):
        """Proactively restore the replication factor as if ``st.node``
        were already lost (its healthy copies remain valid sources)."""
        dead = set(self.catalog.dead_nodes()) | {st.node}
        copies = rereplication_plan(self.store.specs, dead,
                                    self.store.n_nodes)
        applied = []
        for bid, src, dst in copies:
            spec = self.store.specs[bid]
            if dst not in spec.replicas and dst != spec.node:
                spec.replicas = spec.replicas + (dst,)
                applied.append((bid, src, dst))
        st.rereplicated = True
        if applied:
            self.rereplications += 1
            decision.rereplicated.extend(applied)
            if self.flight is not None:
                self.flight.record("rereplicate", node=st.node,
                                   copies=len(applied))
            if self.obs is not None:
                self.obs.tracer.event(
                    "rereplicate",
                    t_virtual=self.obs.tracer.virtual_base,
                    node=st.node, copies=len(applied))
                self.obs.metrics.counter(
                    "policy.rereplications").inc(len(applied))

    # ----------------------------- driving ---------------------------- #
    def decide(self, report: Optional[HealthReport]) -> PolicyDecision:
        """Advance every node's state machine one window and return the
        routing decision (at most one transition per node per window —
        the hysteresis granularity)."""
        cfg = self.config
        decision = PolicyDecision(speculate=cfg.speculate,
                                  spec_lead_factor=cfg.spec_lead_factor)
        dead = set(self.catalog.dead_nodes())
        for node in sorted(self.nodes):
            st = self.nodes[node]
            if node in dead:
                # liveness is authoritative: a dead node is banned, so a
                # rejoin re-enters service through probing
                self._transition(st, POLICY_BANNED, decision)
                st.degraded_run += 1
                continue
            ev = self._evidence(node, report)
            if st.state == POLICY_OK:
                if ev == HEALTH_OK:
                    st.unhealthy = 0
                else:
                    st.unhealthy += 1
                    if st.unhealthy >= cfg.degrade_after:
                        self._transition(st, POLICY_DEGRADED, decision)
            elif st.state == POLICY_DEGRADED:
                st.degraded_run += 1
                if ev == HEALTH_SUSPECT:
                    st.suspect_streak += 1
                    st.healthy = 0
                    if st.suspect_streak >= cfg.ban_after:
                        self._transition(st, POLICY_BANNED, decision)
                elif ev == HEALTH_OK:
                    st.healthy += 1
                    st.suspect_streak = 0
                    if st.healthy >= cfg.recover_after:
                        self._transition(st, POLICY_OK, decision)
                else:
                    st.healthy = 0
            elif st.state == POLICY_BANNED:
                st.degraded_run += 1
                st.banned_for += 1
                if st.banned_for >= cfg.probe_after:
                    self._transition(st, POLICY_PROBING, decision)
            elif st.state == POLICY_PROBING:
                # the stale report that banned the node is ignored here:
                # probe outcomes (observe_window) are the only jury
                st.degraded_run += 1
            if st.state in (POLICY_DEGRADED, POLICY_BANNED) \
                    and st.degraded_run >= cfg.rereplicate_after \
                    and not st.rereplicated:
                self._rereplicate(st, decision)
        for node, st in self.nodes.items():
            if st.state == POLICY_BANNED:
                decision.avoid.add(node)
            elif st.state == POLICY_PROBING:
                decision.avoid.add(node)
                decision.probe_quota[node] = cfg.probe_packets
        if self.flight is not None and (decision.avoid
                                        or decision.transitions
                                        or decision.rereplicated):
            self.flight.record("policy_decide",
                               avoid=sorted(decision.avoid),
                               probes=sorted(decision.probe_quota),
                               speculate=decision.speculate)
        return decision

    def observe_window(self, stats) -> None:
        """Resolve probe outcomes from a window's execution telemetry:
        ``probe_packets`` clean packets on a probing node clear it."""
        by_node: Dict[int, int] = {}
        for t in getattr(stats, "packet_telemetry", ()):
            n = getattr(t, "node", -1)
            if n >= 0:
                by_node[n] = by_node.get(n, 0) + 1
        for node, st in self.nodes.items():
            if st.state != POLICY_PROBING:
                continue
            st.probe_ok += by_node.get(node, 0)
            if st.probe_ok >= self.config.probe_packets:
                self._transition(st, POLICY_OK)

    # ---------------------------- inspection -------------------------- #
    def states(self) -> Dict[int, str]:
        """Snapshot of every node's policy state."""
        return {n: st.state for n, st in sorted(self.nodes.items())}

    def routable_fraction(self) -> float:
        """Fraction of alive nodes the policy will route to (probing
        counts as routable — it holds quota)."""
        alive = self.catalog.alive_nodes()
        if not alive:
            return 1.0
        usable = [n for n in alive
                  if self.nodes[n].state != POLICY_BANNED]
        return len(usable) / len(alive)
