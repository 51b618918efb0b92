"""Per-node health telemetry: rolling latency/failure EWMAs and the
ok/degraded/suspect report the scheduler consumes.

The paper names node failure as the grid's biggest weakness; before any
resource-status policy (ROADMAP item 4) can *act* on sick nodes, the
service has to *see* them.  A :class:`HealthMonitor` folds the
per-packet telemetry the engine already produces
(:class:`~repro_torch.core.jse.PacketTelemetry`, now node-attributed) into a
per-node scan-rate EWMA (seconds per event — size-normalized so packet
ramping doesn't masquerade as slowness) and a failure EWMA (decays on
every healthy packet, jumps on a node death).

Fleet aggregation rides the existing gossip path: a monitor's
:meth:`digest` piggybacks on the epoch gossip digest, and
:meth:`merge_digest` folds remote observations in.  Entries are keyed
``(node, origin)`` and carry a per-origin monotonic ``stamp``, so merge
is idempotent and order-free (newest evidence per origin wins — the
version-vector discipline the fabric already uses for epochs); a
front-end never overwrites its own observations with hearsay.

The :class:`HealthReport` classifies each node *relative to the fleet
median* scan rate: > ``degraded_factor`` x median is ``degraded``,
> ``suspect_factor`` x median — or a failure EWMA over threshold — is
``suspect``.  Relative thresholds make the report portable across
machines and workloads (absolute rates are not).  Consumption is
advisory and flag-gated in
:class:`~repro_torch.service.scheduler.QueryScheduler` (``health_gate``):
a degraded fleet gets narrower dispatch windows so sick nodes see less
concurrent work.  This is deliberately the *hook*, not the policy —
RSS-style routing plugs in here later.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

HEALTH_OK, HEALTH_DEGRADED, HEALTH_SUSPECT = "ok", "degraded", "suspect"
HEALTH_STATES = (HEALTH_OK, HEALTH_DEGRADED, HEALTH_SUSPECT)


@dataclasses.dataclass
class NodeHealth:
    """One origin's rolling view of one node: packet count, scan-rate
    EWMA (s/event), failure EWMA in [0, 1], and a per-origin monotonic
    ``stamp`` used as merge precedence."""
    node: int
    origin: str
    packets: int = 0
    rate_ewma: float = 0.0
    failure_ewma: float = 0.0
    stamp: int = 0

    def to_dict(self) -> Dict:
        """Wire form for the gossip digest."""
        return {"node": self.node, "origin": self.origin,
                "packets": self.packets, "rate_ewma": self.rate_ewma,
                "failure_ewma": self.failure_ewma, "stamp": self.stamp}

    @staticmethod
    def from_dict(d: Dict) -> "NodeHealth":
        """Rebuild an entry from its wire form."""
        return NodeHealth(node=int(d["node"]), origin=d["origin"],
                          packets=int(d["packets"]),
                          rate_ewma=float(d["rate_ewma"]),
                          failure_ewma=float(d["failure_ewma"]),
                          stamp=int(d["stamp"]))


@dataclasses.dataclass
class HealthReport:
    """Point-in-time fleet health: per-node state plus the combined
    rate/failure evidence behind it."""
    states: Dict[int, str]
    rates: Dict[int, float]
    failures: Dict[int, float]
    median_rate: float = 0.0

    @property
    def suspects(self) -> List[int]:
        """Nodes classified suspect, sorted."""
        return sorted(n for n, s in self.states.items()
                      if s == HEALTH_SUSPECT)

    @property
    def degraded(self) -> List[int]:
        """Nodes classified degraded, sorted."""
        return sorted(n for n, s in self.states.items()
                      if s == HEALTH_DEGRADED)

    @property
    def healthy_fraction(self) -> float:
        """Fraction of observed nodes in state ``ok`` (1.0 when nothing
        has been observed — no evidence is not a verdict)."""
        if not self.states:
            return 1.0
        ok = sum(1 for s in self.states.values() if s == HEALTH_OK)
        return ok / len(self.states)

    def to_dict(self) -> Dict:
        """JSON-friendly dump (string node keys)."""
        return {"states": {str(n): s for n, s in self.states.items()},
                "rates": {str(n): r for n, r in self.rates.items()},
                "failures": {str(n): f for n, f in self.failures.items()},
                "median_rate": self.median_rate}


class HealthMonitor:
    """Rolling per-node health, locally observed and gossip-merged.

    Parameters tune the EWMAs and classification: ``alpha`` is the EWMA
    weight of a new observation; ``min_packets`` is the evidence floor
    below which a node is reported ``ok`` (insufficient data is not
    sickness); the factors set the degraded/suspect rate thresholds
    relative to the fleet-median rate; ``failure_threshold`` is the
    failure-EWMA level that makes a node suspect outright."""

    def __init__(self, origin: str = "fe0", *, alpha: float = 0.25,
                 min_packets: int = 3, degraded_factor: float = 2.0,
                 suspect_factor: float = 4.0,
                 failure_threshold: float = 0.3):
        self.origin = origin
        self.alpha = alpha
        self.min_packets = min_packets
        self.degraded_factor = degraded_factor
        self.suspect_factor = suspect_factor
        self.failure_threshold = failure_threshold
        # (node -> origin -> entry); own origin's entries are authoritative
        self._entries: Dict[int, Dict[str, NodeHealth]] = {}

    # --------------------------- observation -------------------------- #
    def _own(self, node: int) -> NodeHealth:
        ent = self._entries.setdefault(node, {}).get(self.origin)
        if ent is None:
            ent = NodeHealth(node=node, origin=self.origin)
            self._entries[node][self.origin] = ent
        return ent

    def observe_packet(self, node: int, size: int, wall_s: float):
        """Fold one scanned packet into the node's EWMAs (healthy
        evidence: the failure EWMA decays)."""
        if node < 0 or size <= 0:
            return
        rate = wall_s / size
        ent = self._own(node)
        if ent.packets == 0:
            ent.rate_ewma = rate
        else:
            ent.rate_ewma += self.alpha * (rate - ent.rate_ewma)
        ent.failure_ewma *= (1.0 - self.alpha)
        ent.packets += 1
        ent.stamp += 1

    def observe_failure(self, node: int):
        """Fold one node death / packet failure into the failure EWMA."""
        ent = self._own(node)
        ent.failure_ewma += self.alpha * (1.0 - ent.failure_ewma)
        ent.stamp += 1

    def observe_stats(self, stats):
        """Convenience: fold a whole :class:`~repro_torch.core.jse.JobStats`
        worth of node-attributed packet telemetry."""
        for t in getattr(stats, "packet_telemetry", ()):
            self.observe_packet(getattr(t, "node", -1), t.size, t.wall_s)

    # ------------------------- fleet aggregation ---------------------- #
    def digest(self) -> Dict:
        """JSON-able dump of every known entry (own + learned), suitable
        for piggybacking on a gossip digest."""
        return {"origin": self.origin,
                "entries": [ent.to_dict()
                            for node in sorted(self._entries)
                            for _, ent in sorted(
                                self._entries[node].items())]}

    def merge_digest(self, payload: Optional[Dict]):
        """Fold a remote digest in: per ``(node, origin)``, the higher
        ``stamp`` wins (idempotent, order-free); own-origin entries are
        never overwritten by hearsay."""
        if not payload:
            return
        for d in payload.get("entries", ()):
            ent = NodeHealth.from_dict(d)
            if ent.origin == self.origin:
                continue
            cur = self._entries.setdefault(ent.node, {}).get(ent.origin)
            if cur is None or ent.stamp > cur.stamp:
                self._entries[ent.node][ent.origin] = ent

    # ----------------------------- report ----------------------------- #
    def _combined(self, node: int) -> NodeHealth:
        """Packet-weighted combination of every origin's view of a node
        (failure takes the max: one origin seeing deaths is enough)."""
        ents = list(self._entries.get(node, {}).values())
        total = sum(e.packets for e in ents)
        out = NodeHealth(node=node, origin="*", packets=total)
        if total > 0:
            out.rate_ewma = sum(e.rate_ewma * e.packets
                                for e in ents) / total
        if ents:
            out.failure_ewma = max(e.failure_ewma for e in ents)
        return out

    def report(self) -> HealthReport:
        """Classify every observed node against the fleet-median rate."""
        combined = {n: self._combined(n) for n in sorted(self._entries)}
        rates = sorted(c.rate_ewma for c in combined.values()
                       if c.packets >= self.min_packets)
        median = rates[len(rates) // 2] if rates else 0.0
        states: Dict[int, str] = {}
        for n, c in combined.items():
            if c.failure_ewma >= self.failure_threshold:
                states[n] = HEALTH_SUSPECT
            elif c.packets < self.min_packets or median <= 0.0:
                states[n] = HEALTH_OK
            elif c.rate_ewma > self.suspect_factor * median:
                states[n] = HEALTH_SUSPECT
            elif c.rate_ewma > self.degraded_factor * median:
                states[n] = HEALTH_DEGRADED
            else:
                states[n] = HEALTH_OK
        return HealthReport(
            states=states,
            rates={n: c.rate_ewma for n, c in combined.items()},
            failures={n: c.failure_ewma for n, c in combined.items()},
            median_rate=median)
