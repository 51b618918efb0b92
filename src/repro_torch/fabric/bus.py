"""Deterministic in-process message bus — the simulated inter-frontend
network of the coherence fabric.

Every fleet experiment needs the same three network behaviours the real
deployment would see — latency, loss, and partitions — without giving up
reproducibility.  The bus delivers in discrete *rounds* (the fabric's
coarse network clock): a message sent during round ``r`` becomes visible
in the destination inbox at round ``r + 1 + delay``.  Within one round,
deliveries are ordered by a global send sequence number, so two runs with
the same seed and the same send pattern drain identically.  With a
constant per-link delay the bus is FIFO per (src, dst) link, which is the
ordering contract the stream fan-out layer relies on (it additionally
guards against reordering with per-snapshot sequence numbers).

Faults are injected deterministically: ``drop_rate`` uses a seeded RNG,
and :meth:`MessageBus.partition` splits the fleet into groups whose
cross-group messages are silently lost until :meth:`MessageBus.heal` —
exactly the scenario the gossip layer's anti-entropy reconciliation
(``fabric/gossip.py``) has to recover from.
"""
from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Envelope:
    """One message in flight: source/destination fabric node ids, a topic
    string the receiver dispatches on, an arbitrary payload (treated as
    immutable by convention — the simulated network never copies), the
    send round, and the round at which it becomes deliverable."""
    seq: int
    src: str
    dst: str
    topic: str
    payload: Any
    sent_round: int
    deliver_round: int


@dataclasses.dataclass
class BusStats:
    """Monotonic bus counters: messages sent, delivered, dropped by the
    seeded loss process, and blocked by an active partition."""
    sent: int = 0
    delivered: int = 0
    dropped: int = 0
    partitioned: int = 0


class MessageBus:
    """Round-based deterministic message fabric between fleet front-ends.

    Parameters
    ----------
    delay:
        Extra delivery rounds per message beyond the minimum of one (a
        message can never be read in the round it was sent — the fabric
        has no zero-latency links).
    drop_rate:
        Probability in [0, 1) that a message is lost, drawn from a
        dedicated ``random.Random(seed)`` so loss patterns replay
        identically run to run.
    seed:
        Seed for the loss process.
    """

    def __init__(self, *, delay: int = 0, drop_rate: float = 0.0,
                 seed: int = 0):
        if delay < 0:
            raise ValueError("delay must be >= 0")
        if not (0.0 <= drop_rate < 1.0):
            raise ValueError("drop_rate must be in [0, 1)")
        self.delay = delay
        self.drop_rate = drop_rate
        self.round = 0
        self.stats = BusStats()
        # observability metrics registry (repro_torch.obs.MetricsRegistry);
        # None = disabled.  The fleet installs its fleet-level registry
        # here — the bus is shared infrastructure, not per-frontend.
        self.metrics = None
        # flight-recorder scope (repro_torch.obs.flight.FlightScope); None =
        # disabled.  Records every send outcome and delivery.
        self.flight = None
        self._rng = random.Random(seed)
        self._inboxes: Dict[str, Deque[Envelope]] = {}
        self._inflight: List[Envelope] = []
        self._groups: Optional[List[set]] = None
        self._link_loss: Dict[Tuple[str, str], float] = {}
        self._seq = 0

    def set_link_loss(self, src: str, dst: str, rate: float) -> None:
        """Override the loss rate for ONE directed link (0 restores the
        bus-wide ``drop_rate``) — the lossy-link scenario the gossip
        ack/repair protocol exists for.  Draws come from the same seeded
        RNG as global loss, so runs stay reproducible."""
        if not (0.0 <= rate < 1.0):
            raise ValueError("rate must be in [0, 1)")
        if rate == 0.0:
            self._link_loss.pop((src, dst), None)
        else:
            self._link_loss[(src, dst)] = rate

    # ------------------------------------------------------------------ #
    def register(self, node_id: str) -> None:
        """Create the inbox for a fabric node (idempotent)."""
        self._inboxes.setdefault(node_id, deque())

    @property
    def nodes(self) -> List[str]:
        """Registered fabric node ids, sorted (the gossip peer list)."""
        return sorted(self._inboxes)

    # ------------------------------------------------------------------ #
    def _same_side(self, a: str, b: str) -> bool:
        if self._groups is None:
            return True
        for g in self._groups:
            if a in g:
                return b in g
        return False  # unknown nodes are isolated while partitioned

    def partition(self, *groups) -> None:
        """Split the fleet: messages between different ``groups`` (iterables
        of node ids) are lost until :meth:`heal`.  Nodes not named in any
        group are isolated from everyone."""
        self._groups = [set(g) for g in groups]

    def heal(self) -> None:
        """Remove the partition; traffic sent *after* healing flows again
        (messages lost during the partition stay lost — recovering their
        information is the gossip layer's anti-entropy job)."""
        self._groups = None

    # ------------------------------------------------------------------ #
    def _send_outcome(self, src: str, dst: str, topic: str) -> str:
        # The single nondeterminism-relevant decision point of the bus:
        # "partitioned" | "dropped" | "delivered".  The replay engine
        # (repro_torch.obs.replay.ReplayBus) overrides exactly this method to
        # substitute recorded outcomes, which also covers partitions and
        # per-link loss without re-driving partition()/set_link_loss().
        if not self._same_side(src, dst):
            return "partitioned"
        loss = self._link_loss.get((src, dst), self.drop_rate)
        if loss and self._rng.random() < loss:
            return "dropped"
        return "delivered"

    def send(self, src: str, dst: str, topic: str, payload: Any) -> bool:
        """Queue one message; returns False when the loss process or an
        active partition ate it (callers never retry — the fabric's
        protocols are periodic and idempotent instead)."""
        if dst not in self._inboxes:
            raise KeyError(f"unknown fabric node {dst!r}")
        self.stats.sent += 1
        if self.metrics is not None:
            self.metrics.counter("bus.sent").inc()
        outcome = self._send_outcome(src, dst, topic)
        if outcome != "delivered":
            if outcome == "partitioned":
                self.stats.partitioned += 1
            else:
                self.stats.dropped += 1
            if self.metrics is not None:
                self.metrics.counter(f"bus.{outcome}").inc()
            if self.flight is not None:
                self.flight.record("bus_send", n=self.stats.sent, src=src,
                                   dst=dst, topic=topic, outcome=outcome,
                                   round=self.round)
            return False
        env = Envelope(self._seq, src, dst, topic, payload, self.round,
                       self.round + 1 + self.delay)
        self._seq += 1
        self._inflight.append(env)
        if self.flight is not None:
            rec = self.flight.record(
                "bus_send", n=self.stats.sent, src=src, dst=dst,
                topic=topic, outcome=outcome, round=self.round,
                seq=env.seq, deliver_round=env.deliver_round)
            self.flight.note_send(env.seq, rec["eid"])
        return True

    def broadcast(self, src: str, topic: str, payload: Any) -> int:
        """Send to every registered node except ``src``; returns the number
        of messages that survived loss/partition."""
        return sum(self.send(src, dst, topic, payload)
                   for dst in self.nodes if dst != src)

    def tick(self) -> int:
        """Advance one network round: deliver every due message into its
        destination inbox in global send order; returns deliveries made."""
        self.round += 1
        due = [e for e in self._inflight if e.deliver_round <= self.round]
        self._inflight = [e for e in self._inflight
                          if e.deliver_round > self.round]
        due.sort(key=lambda e: e.seq)
        for env in due:
            self._inboxes[env.dst].append(env)
            if self.flight is not None:
                rec = self.flight.record(
                    "bus_deliver", seq=env.seq, src=env.src, dst=env.dst,
                    topic=env.topic, round=self.round,
                    cause=self.flight.send_cause(env.seq))
                self.flight.note_deliver(env.seq, rec["eid"])
        self.stats.delivered += len(due)
        if self.metrics is not None and due:
            self.metrics.counter("bus.delivered").inc(len(due))
        return len(due)

    def recv(self, node_id: str) -> List[Envelope]:
        """Drain and return the node's inbox (delivery order)."""
        box = self._inboxes[node_id]
        out = list(box)
        box.clear()
        return out

    def pending(self, node_id: str) -> int:
        """Messages currently waiting in a node's inbox."""
        return len(self._inboxes[node_id])

    @property
    def idle(self) -> bool:
        """True when nothing is in flight and every inbox is empty."""
        return not self._inflight and all(
            not b for b in self._inboxes.values())

    def in_flight(self, topic: Optional[str] = None) -> int:
        """Messages not yet drained by their destination (in flight or
        sitting in an inbox), optionally filtered by topic.  Lets a
        caller wait for quiescence of ONE protocol (e.g. stream fan-out)
        without being fooled by periodic traffic (gossip emits every
        round, so the bus as a whole is almost never idle)."""
        envs = list(self._inflight)
        for box in self._inboxes.values():
            envs.extend(box)
        if topic is None:
            return len(envs)
        return sum(1 for e in envs if e.topic == topic)
