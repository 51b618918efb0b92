"""Epoch gossip + anti-entropy: fleet-wide cache invalidation with a
bounded propagation delay.

The single-process service invalidates its cache through the catalogue's
``bump_dataset_version()`` hook.  In a fleet, each front-end has its own
catalogue *view*, so a bump observed on one front-end must reach every
peer — otherwise a sibling keeps serving results computed over the old
dataset forever.  This module closes that loop with the classic
interactive-grid recipe (DIAL's shared metadata tier, Grid-enabled
database lessons): a small, periodic, idempotent digest exchange.

**Version vectors.**  Each front-end keeps a vector ``{origin: bumps}``
counting how many dataset bumps each fleet member has *originated*.  The
effective dataset epoch is the SUM of the vector's entries.  Summing (not
max-ing) is what makes reconciliation after a partition correct: if both
sides of a split bump once, the healed vector merges to both entries and
the effective epoch exceeds *each* side's partition-era epoch, so every
entry cached during the split is invalidated on every member.

**Propagation bound.**  Every gossip round, the node at index ``i`` of
the sorted peer list pushes its full digest to peers ``i+1 .. i+fanout``
(mod n).  Information therefore advances at least ``fanout`` ring
positions per round, giving the documented bound
:func:`rounds_bound` ``= ceil((n-1)/fanout)`` rounds from any bump to
fleet-wide visibility (loss-free bus; message drops only delay
convergence because digests are cumulative and idempotent).  The default
fanout is **adaptive to fleet size**: :func:`adaptive_fanout` ``=
max(1, ceil(log2(n)))``, so the bound scales as ``O(n / log n)`` rounds
while per-round traffic stays ``O(n log n)`` messages — a fixed constant
either floods small fleets or crawls on large ones.

**Anti-entropy.**  Digests always carry the full vector and the full
liveness map, never deltas.  A front-end that was partitioned needs no
special recovery path: the first digest it receives after healing carries
everything it missed, and :func:`rounds_bound` applies again from the
heal.

The same digest piggybacks grid-node liveness (a per-node monotonic
``(version, origin)`` stamp — highest wins, origin id breaking ties
between concurrent observations), so a ``node_leave`` observed by one
front-end reaches every peer's catalogue and redirects their packet
scheduling to surviving replicas within the same bound.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.catalog import MetadataCatalog
from repro_torch.fabric.bus import MessageBus

GOSSIP_TOPIC = "gossip"

VersionVector = Dict[str, int]


def effective_epoch(vv: VersionVector) -> int:
    """Dataset epoch implied by a version vector: the sum of per-origin
    bump counts (see module docstring for why sum, not max)."""
    return sum(vv.values())


def merge_vv(mine: VersionVector, theirs: VersionVector) -> bool:
    """Element-wise max merge of ``theirs`` into ``mine`` (in place);
    returns True when ``mine`` changed."""
    changed = False
    for origin, n in theirs.items():
        if n > mine.get(origin, 0):
            mine[origin] = n
            changed = True
    return changed


def adaptive_fanout(n_frontends: int) -> int:
    """Default gossip fanout for a fleet of ``n``: ``max(1, ceil(log2(n)))``.

    Scales push width with fleet size so the propagation bound stays
    ``O(n / log n)`` rounds without flooding small fleets: n<=2 -> 1,
    3..4 -> 2, 5..8 -> 3, 9..16 -> 4, ...  Used whenever a fanout of
    ``None`` is passed (GossipNode, Fleet, :func:`rounds_bound`)."""
    if n_frontends <= 2:
        return 1
    return max(1, math.ceil(math.log2(n_frontends)))


def rounds_bound(n_frontends: int, fanout: Optional[int] = None) -> int:
    """Worst-case gossip rounds from a bump on any member to fleet-wide
    visibility on a loss-free bus: ``ceil((n-1)/fanout)``.

    ``fanout=None`` means the adaptive default
    (:func:`adaptive_fanout`), matching what a Fleet built without an
    explicit ``gossip_fanout`` actually pushes — e.g. n=16 gossips at
    fanout 4 and is fleet-wide within ``ceil(15/4) = 4`` rounds."""
    if n_frontends <= 1:
        return 0
    if fanout is None:
        fanout = adaptive_fanout(n_frontends)
    return math.ceil((n_frontends - 1) / max(1, fanout))


def rounds_bound_lossy(n_frontends: int, fanout: Optional[int] = None, *,
                       drop_rate: float = 0.0,
                       confidence: float = 0.999) -> int:
    """Probabilistic propagation bound under sustained i.i.d. message
    loss: rounds after which a bump is fleet-wide with probability at
    least ``confidence``.

    Derivation: on the loss-free bus information crosses the ring in
    ``R = rounds_bound(n, fanout)`` sequential hops.  Digests are
    cumulative and re-pushed every round (and the ack/repair variant
    additionally resends unacknowledged digests), so a hop that needs
    ``m`` rounds to land a message fails with probability
    ``drop_rate**m`` — each round is an independent Bernoulli trial.
    Choosing ``m = ceil(log((1-confidence)/R) / log(drop_rate))`` makes
    each hop's failure probability at most ``(1-confidence)/R``; a union
    bound over the ``R`` sequential hops caps the total failure
    probability at ``1-confidence``.  The bound is ``R * m`` rounds —
    loss multiplies the loss-free bound by a log factor, it does not
    break convergence (the anti-entropy property the test matrix
    seeds loss to verify)."""
    base = rounds_bound(n_frontends, fanout)
    if base == 0 or drop_rate <= 0.0:
        return base
    if not (0.0 < drop_rate < 1.0):
        raise ValueError("drop_rate must be in [0, 1)")
    if not (0.0 < confidence < 1.0):
        raise ValueError("confidence must be in (0, 1)")
    fail_per_hop = (1.0 - confidence) / base
    m = math.ceil(math.log(fail_per_hop) / math.log(drop_rate))
    return base * max(1, m)


@dataclasses.dataclass
class GossipStats:
    """Monotonic gossip counters: digests sent/received, digests that
    changed local state, and epoch/liveness updates applied."""
    digests_sent: int = 0
    digests_received: int = 0
    digests_stale: int = 0       # received digests that taught us nothing
    epoch_updates: int = 0       # catalog epochs advanced by gossip
    liveness_updates: int = 0    # node alive/dead flips applied by gossip
    # ack/repair protocol (GossipNode(repair=True)):
    acks_sent: int = 0           # acks returned for want_ack digests
    acks_received: int = 0       # our digests confirmed delivered
    repairs: int = 0             # unacked digests re-pushed after timeout
    replies_sent: int = 0        # push-pull replies to stale senders


class GossipNode:
    """One front-end's membership in the epoch-gossip protocol.

    Attaches to the front-end's catalogue: a local
    ``bump_dataset_version()`` (from any code path) is credited to this
    node's entry of the version vector via the catalogue's bump hook, and
    remote digests that advance the vector are applied back to the
    catalogue with ``set_dataset_epoch`` — which fires the same hook
    chain, so the front-end's result cache invalidates exactly as it
    would for a local bump.

    Call :meth:`emit` once per gossip round (the Fleet does this inside
    ``pump``), and :meth:`on_message` for every received digest.
    """

    def __init__(self, node_id: str, catalog: MetadataCatalog,
                 bus: MessageBus, *, fanout: Optional[int] = None,
                 repair: bool = False, ack_rounds: int = 2):
        self.node_id = node_id
        self.catalog = catalog
        self.bus = bus
        # None = adaptive: resolved from the registered ring size at each
        # emit, so late-joining fabric nodes widen the push automatically
        self.fanout = max(1, fanout) if fanout is not None else None
        # ack/repair hardening (off by default — the plain protocol's
        # counters stay untouched): digests carry a sequence number and
        # want an ack; a digest unacked after ``ack_rounds`` emits is
        # re-pushed once (repair), and an ack from a peer whose digest
        # shows it is stale carries our full digest back (push-pull) —
        # what keeps rounds_bound_lossy honest under sustained loss
        self.repair = repair
        self.ack_rounds = max(1, ack_rounds)
        self._round = 0
        self._next_seq = 0
        self._unacked: Dict[Tuple[str, int], int] = {}  # (dst, seq) -> round
        self.vv: VersionVector = {}
        # grid node liveness: node -> (version, origin, alive).  Highest
        # (version, origin) wins — the origin id breaks ties between
        # concurrent equal-version observations on different front-ends,
        # so conflicting join/leave reports still converge fleet-wide
        # instead of each observer keeping its own view forever.
        self.liveness: Dict[int, Tuple[int, str, bool]] = {}
        self.stats = GossipStats()
        # optional observability handles (installed by the Fleet):
        # ``health`` is a repro_torch.obs.HealthMonitor whose digest piggybacks
        # on the gossip digest (anti-entropy carries health for free),
        # ``metrics`` a MetricsRegistry for gossip counters.  None = off.
        self.health = None
        self.metrics = None
        # flight-recorder scope (repro_torch.obs.flight.FlightScope); None =
        # off.  Records epoch advances and liveness flips.
        self.flight = None
        bus.register(node_id)
        catalog.on_dataset_bump(self._on_local_bump)

    # ------------------------------------------------------------------ #
    def _on_local_bump(self, epoch: int) -> None:
        """Catalogue bump hook: credit locally originated bumps to our own
        version-vector entry.  When the epoch change came from gossip
        itself (``set_dataset_epoch`` after a merge) the vector already
        accounts for it and the delta is zero."""
        known = effective_epoch(self.vv)
        if epoch > known:
            self.vv[self.node_id] = \
                self.vv.get(self.node_id, 0) + (epoch - known)
            if self.flight is not None:
                self.flight.record("gossip_epoch", epoch=epoch, via="local")

    def observe_liveness(self, grid_node: int, alive: bool) -> None:
        """Record a locally observed grid-node join/leave and stamp it
        with a fresh (version, origin) so gossip propagates it to every
        peer and concurrent observations resolve deterministically.  The
        caller is responsible for the local catalogue mark (the
        ElasticManager already did it)."""
        ver = self.liveness.get(grid_node, (0, "", True))[0]
        self.liveness[grid_node] = (ver + 1, self.node_id, alive)
        if self.flight is not None:
            self.flight.record("gossip_liveness", grid_node=grid_node,
                               alive=alive, version=ver + 1, via="local")

    # ------------------------------------------------------------------ #
    def digest(self) -> dict:
        """The full anti-entropy digest this node pushes every round.
        When a health monitor is attached its digest rides along, so
        node-health telemetry converges fleet-wide under the same
        :func:`rounds_bound` as epochs and liveness."""
        out = {
            "vv": dict(self.vv),
            "live": {n: list(v) for n, v in self.liveness.items()},
        }
        if self.health is not None:
            out["health"] = self.health.digest()
        return out

    def targets(self) -> List[str]:
        """This round's push targets: the next ``fanout`` peers after us
        on the sorted ring of registered fabric nodes (adaptive
        ``max(1, ceil(log2(ring)))`` when no fanout was fixed)."""
        ring = self.bus.nodes
        if len(ring) <= 1:
            return []
        fanout = (self.fanout if self.fanout is not None
                  else adaptive_fanout(len(ring)))
        i = ring.index(self.node_id)
        return [ring[(i + 1 + k) % len(ring)]
                for k in range(min(fanout, len(ring) - 1))]

    def _send_digest(self, dst: str, payload: dict) -> None:
        body = payload
        if self.repair:
            seq = self._next_seq
            self._next_seq += 1
            body = dict(payload, seq=seq, src=self.node_id, want_ack=True)
            self._unacked[(dst, seq)] = self._round
        self.bus.send(self.node_id, dst, GOSSIP_TOPIC, body)
        self.stats.digests_sent += 1
        if self.metrics is not None:
            self.metrics.counter("gossip.digests_sent").inc()

    def emit(self) -> None:
        """Push the digest to this round's ring targets; in repair mode,
        additionally re-push to peers whose previous digest went unacked
        for ``ack_rounds`` emits (the bus ate it — send a fresh one)."""
        payload = self.digest()
        targets = self.targets()
        overdue: List[str] = []
        if self.repair:
            self._round += 1
            for (dst, seq), sent_round in list(self._unacked.items()):
                if self._round - sent_round >= self.ack_rounds:
                    del self._unacked[(dst, seq)]
                    overdue.append(dst)
        for dst in targets:
            self._send_digest(dst, payload)
        for dst in overdue:
            if dst not in targets:
                self._send_digest(dst, payload)
            self.stats.repairs += 1
            if self.metrics is not None:
                self.metrics.counter("gossip.repairs").inc()

    # ------------------------------------------------------------------ #
    def _apply_digest(self, payload: dict) -> Tuple[bool, bool]:
        """Merge a digest body into local state; returns (epoch changed,
        liveness changed)."""
        if self.health is not None and "health" in payload:
            self.health.merge_digest(payload["health"])
        changed = merge_vv(self.vv, payload.get("vv", {}))
        if changed:
            self.catalog.set_dataset_epoch(effective_epoch(self.vv))
            self.stats.epoch_updates += 1
            if self.flight is not None:
                self.flight.record("gossip_epoch",
                                   epoch=effective_epoch(self.vv),
                                   via="gossip")
        live_changed = False
        for node, (ver, origin, alive) in payload.get("live", {}).items():
            node = int(node)
            cur = self.liveness.get(node, (0, "", True))
            if (ver, origin) > (cur[0], cur[1]):
                self.liveness[node] = (ver, origin, alive)
                if alive:
                    self.catalog.mark_alive(node)
                else:
                    self.catalog.mark_dead(node)
                self.stats.liveness_updates += 1
                live_changed = True
                if self.flight is not None:
                    self.flight.record("gossip_liveness", grid_node=node,
                                       alive=alive, version=ver,
                                       via="gossip")
        return changed, live_changed

    def _sender_stale(self, payload: dict) -> bool:
        """Does the sender's digest show it is missing something we
        know?  (The push-pull trigger: loss is bidirectional, so an ack
        is the cheapest place to carry the missing state back.)"""
        theirs_vv = payload.get("vv", {})
        if any(n > theirs_vv.get(origin, 0)
               for origin, n in self.vv.items()):
            return True
        theirs_live = payload.get("live", {})
        for node, mine in self.liveness.items():
            t = theirs_live.get(node, theirs_live.get(str(node)))
            if t is None or (mine[0], mine[1]) > (t[0], t[1]):
                return True
        return False

    def on_message(self, payload: dict) -> None:
        """Merge one received digest into local state, applying epoch and
        liveness changes to the catalogue (which fans out to the caches
        through the ordinary bump-hook chain).  In repair mode this also
        handles protocol messages: acks (confirming our digests, possibly
        carrying a push-pull reply) and digests wanting an ack."""
        if "ack" in payload:
            self.stats.acks_received += 1
            self._unacked.pop((payload.get("src", ""), payload["ack"]),
                              None)
            reply = payload.get("reply")
            if reply:
                self._apply_digest(reply)
            return
        self.stats.digests_received += 1
        if self.metrics is not None:
            self.metrics.counter("gossip.digests_received").inc()
        changed, live_changed = self._apply_digest(payload)
        if not changed and not live_changed:
            self.stats.digests_stale += 1
        elif self.metrics is not None:
            self.metrics.counter("gossip.updates_applied").inc()
        if self.repair and payload.get("want_ack") \
                and payload.get("src") in self.bus.nodes:
            ack = {"ack": payload.get("seq"), "src": self.node_id}
            if self._sender_stale(payload):
                ack["reply"] = self.digest()
                self.stats.replies_sent += 1
            self.bus.send(self.node_id, payload["src"], GOSSIP_TOPIC, ack)
            self.stats.acks_sent += 1
            if self.metrics is not None:
                self.metrics.counter("gossip.acks_sent").inc()

    def detach(self) -> None:
        """Unhook from the catalogue (shutdown path — a long-lived
        catalogue must not accumulate dead gossip hooks)."""
        self.catalog.off_dataset_bump(self._on_local_bump)
