"""Fleet-wide single-flight execution: scan-intent leases over the bus.

The fabric dedups *results* (the shared L2) but not *work*: two
front-ends holding the same canonical query in the same dispatch window
each run a full scan and only then discover the duplicate in the cache.
Under DIAL-style near-duplicate interactive traffic that is the largest
remaining waste at the service tier.  This module closes it with a
single-flight protocol:

- Before dispatching a scan, a front-end **announces a scan intent** on
  the bus (topic :data:`LEASE_TOPIC`), keyed on the SAME canonical
  expression + dataset-epoch keyspace as L1/L2 — the key embeds the
  version-vector fingerprint (``shared_cache.py`` hygiene), so intents
  from different dataset epochs can never collide.
- Every front-end folds received intents into a lease table keyed by
  announcement **priority** ``(bus round, node id)``: the earliest
  announcement wins, and the deterministic bus order (node ids) breaks
  same-round ties — so N simultaneous duplicate submissions resolve to
  exactly ONE lease owner with no extra round trips.
- At dispatch time a front-end that would run an equal scan but sees a
  fresh remote lease **adopts** the owner's in-flight
  :class:`~repro_torch.service.streaming.ResultStream` instead, via the
  existing ``fanout.py`` buffered-prefix replay — a bit-identical
  stream with zero brick I/O.  The owner exports one lease stream per
  won key (whole queries AND materialized fragments, so a lease on a
  shared conjunct turns sibling queries equal to it into fragment
  adoptions).
- Intents are **re-announced every fabric round** (cumulative and
  idempotent, like gossip digests), so drops and healed partitions only
  delay convergence.  A lease therefore carries a **TTL in bus rounds
  tied to the gossip propagation bound** (:func:`lease_ttl`): an owner
  that dies or is banned (failure policy) stops refreshing, the lease
  expires, and the adoptee falls back to the shared cache first (the
  owner's completed result is reachable in-process even when the bus is
  partitioned) and to its own scan only on a miss — never losing a
  final, never surfacing an adopted partial as one.

All lease traffic emits ``lease.*`` metrics and ``lease_adopt`` /
``lease_fallback`` trace events through the observability plane when one
is installed (``obs=None`` disables the whole plane, as everywhere).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.fabric.bus import MessageBus
from repro_torch.fabric.gossip import VersionVector, rounds_bound

LEASE_TOPIC = "lease"


def lease_ttl(n_frontends: int, fanout: Optional[int] = None,
              delay: int = 0) -> int:
    """Default lease TTL in bus rounds for a fleet of ``n_frontends``.

    An alive owner refreshes its intents every fabric round, so a lease
    only expires when refreshes stop arriving.  The TTL must ride out
    one full anti-entropy cycle plus the bus latency (re-announcements
    sent at round ``r`` land at ``r + 1 + delay``), with one extra cycle
    of slack for seeded drops: ``2 * rounds_bound + 2 * (1 + delay)``.
    Shorter values make failover snappier but risk expiring a healthy
    owner on a lossy bus; longer values only delay fallback."""
    return 2 * rounds_bound(n_frontends, fanout) + 2 * (1 + delay)


def lease_key(canonical: str, calib_iters: int, vv: VersionVector) -> str:
    """The fleet-wide lease key: canonical expression + calibration +
    version-vector fingerprint (the L1/L2 keyspace, epoch-disambiguated
    the way ``SharedCacheTier`` keys are).  Two front-ends build the
    same key only when they agree on BOTH the query structure and the
    dataset epoch vector, so an adopted stream can never cross epochs."""
    fp = ",".join(f"{o}:{int(n)}" for o, n in sorted(vv.items()) if n)
    return f"lease:{canonical}|c{int(calib_iters)}|{fp}"


@dataclasses.dataclass
class LeaseRecord:
    """One entry of a front-end's lease table: the winning announcement
    for a key.  ``round`` is the announcement's ORIGINAL bus round (the
    priority — re-announcements never improve it), ``last_seen`` the
    round the owner's latest refresh was observed (freshness for the
    TTL), and ``fp`` the owner's version-vector fingerprint at announce
    time (stale-epoch guard)."""
    key: str
    owner: str
    round: int
    last_seen: int
    fp: str

    @property
    def priority(self) -> Tuple[int, str]:
        """Total order over competing announcements: earliest round
        first, deterministic node-id order breaking same-round ties."""
        return (self.round, self.owner)


@dataclasses.dataclass
class LeaseStats:
    """Monotonic per-front-end lease counters: intents announced, leases
    won (export streams created), remote leases adopted, releases sent,
    records expired by TTL, revocations applied, and adoptions that fell
    back (cache re-probe or rescan)."""
    announced: int = 0
    acquired: int = 0
    adopted: int = 0
    released: int = 0
    expired: int = 0
    revoked: int = 0
    fallbacks: int = 0


class LeaseManager:
    """One front-end's lease endpoint: intent announcer, lease table,
    and export registry for streams this front-end serves to adoptees.

    The Fleet wires one manager per front-end (``single_flight=True``),
    shares the gossip node's version vector via ``vv_source``, injects
    the front-end's :class:`~repro_torch.fabric.fanout.StreamFanout` on
    :attr:`fanout` (adoptees proxy through it), and dispatches
    :data:`LEASE_TOPIC` bus messages to :meth:`on_message` while calling
    :meth:`emit` every fabric round.  The :class:`QueryService` consumes
    the manager at submit time (:meth:`announce`), dispatch time
    (:meth:`holder` / :meth:`export`) and resolution time
    (:meth:`release`)."""

    def __init__(self, node_id: str, bus: MessageBus,
                 vv_source: Callable[[], VersionVector], *,
                 ttl: int = 8, obs=None):
        if ttl < 1:
            raise ValueError("ttl must be at least one bus round")
        self.node_id = node_id
        self.bus = bus
        self.vv_source = vv_source
        self.ttl = ttl
        self.obs = obs
        self.stats = LeaseStats()
        #: the front-end's StreamFanout (Fleet-wired); adoptions proxy
        #: remote lease streams through it
        self.fanout = None
        #: flight-recorder scope (repro_torch.obs.flight.FlightScope); None =
        #: off.  Records announce/grant/expire/release/revoke and the
        #: front-end's adopt/fallback transitions.
        self.flight = None
        #: streams this front-end exports for keys it won, readable by
        #: any adoptee through the fan-out resolve hook
        self.exports: Dict[str, object] = {}
        self._table: Dict[str, LeaseRecord] = {}
        self._intents: Dict[str, LeaseRecord] = {}
        self._released: Dict[str, int] = {}  # own: key -> release round
        self._peer_released: Dict[str, int] = {}  # peers': key -> round

    # --------------------------- keyspace ------------------------------ #
    def current_fp(self) -> str:
        """Fingerprint of this front-end's current epoch version vector
        (the stale-lease guard compares records against it)."""
        vv = self.vv_source()
        return ",".join(f"{o}:{int(n)}" for o, n in sorted(vv.items())
                        if n)

    def key_for(self, canonical: str, calib_iters: int) -> str:
        """The lease key of one canonical query at the CURRENT epoch."""
        return lease_key(canonical, calib_iters, self.vv_source())

    # --------------------------- announcer ----------------------------- #
    def announce(self, canonical: str, calib_iters: int) -> str:
        """Announce (idempotently) a scan intent for one canonical query
        at the current epoch; returns the lease key.  The intent is
        broadcast now and re-broadcast every :meth:`emit` until
        withdrawn or released, so drops only delay propagation."""
        key = self.key_for(canonical, calib_iters)
        if key in self._intents:
            return key
        rec = LeaseRecord(key=key, owner=self.node_id,
                          round=self.bus.round, last_seen=self.bus.round,
                          fp=self.current_fp())
        self._intents[key] = rec
        if self.flight is not None:
            self.flight.record("lease_announce", key=key,
                               round=self.bus.round)
        self._merge(rec)
        self._broadcast_intent(rec)
        self.stats.announced += 1
        if self.obs is not None:
            self.obs.metrics.counter("lease.announced").inc()
        return key

    def intends(self, key: str) -> bool:
        """True while this front-end has an active intent for ``key`` —
        the fan-out's ``defer`` predicate: an adoptee's sub arriving
        before our window dispatches is parked, not aborted (the export
        is coming)."""
        return key in self._intents

    def withdraw(self, key: str) -> None:
        """Stop re-announcing an intent (the loser's move on adopting a
        remote lease).  The local table keeps the winner's record; no
        message is needed — peers only ever treated the winner as the
        holder."""
        self._intents.pop(key, None)

    def emit(self) -> None:
        """One fabric round of lease anti-entropy: refresh and
        re-broadcast every active intent (cumulative, idempotent — the
        gossip-digest discipline), drop own intents announced under a
        superseded epoch fingerprint (peers' ``holder`` ignores them
        anyway — keeping them would re-broadcast dead keys forever), and
        garbage-collect exports whose lease was released more than one
        TTL ago (late adoptees past that point fall back to the shared
        cache)."""
        fp_now = self.current_fp()
        for key in [k for k, r in self._intents.items()
                    if r.fp != fp_now]:
            self._intents.pop(key, None)
            rec = self._table.get(key)
            if rec is not None and rec.owner == self.node_id:
                del self._table[key]
        for rec in self._intents.values():
            rec.last_seen = self.bus.round
            mine = self._table.get(rec.key)
            if mine is not None and mine.owner == self.node_id:
                mine.last_seen = self.bus.round
            self._broadcast_intent(rec)
        for key, rnd in list(self._released.items()):
            if self.bus.round - rnd > self.ttl:
                self._released.pop(key, None)
                self.exports.pop(key, None)
        for key, rnd in list(self._peer_released.items()):
            if self.bus.round - rnd > self.ttl:
                self._peer_released.pop(key, None)

    def _broadcast_intent(self, rec: LeaseRecord) -> None:
        self.bus.broadcast(self.node_id, LEASE_TOPIC,
                           {"kind": "intent", "key": rec.key,
                            "owner": rec.owner, "round": rec.round,
                            "fp": rec.fp})

    # ----------------------------- table ------------------------------- #
    def _merge(self, rec: LeaseRecord) -> None:
        cur = self._table.get(rec.key)
        if cur is None or rec.priority < cur.priority:
            self._table[rec.key] = rec
            if self.flight is not None and (cur is None
                                            or cur.owner != rec.owner):
                self.flight.record("lease_grant", key=rec.key,
                                   owner=rec.owner, round=rec.round)
        elif rec.owner == cur.owner:
            cur.last_seen = max(cur.last_seen, rec.last_seen)

    def holder(self, key: str) -> Optional[str]:
        """The node id currently holding the lease on ``key``, or None.

        A record is usable only while FRESH (refreshed within
        :attr:`ttl` bus rounds — a dead owner stops refreshing and the
        lease expires here) and CURRENT (announced under this
        front-end's present epoch fingerprint — a dataset bump makes
        pre-bump leases invisible, so an adoptee can never attach to a
        stale-epoch stream)."""
        rec = self._table.get(key)
        if rec is None:
            return None
        if self.bus.round - rec.last_seen > self.ttl:
            del self._table[key]
            self._intents.pop(key, None)
            self.stats.expired += 1
            if self.flight is not None:
                self.flight.record("lease_expire", key=key,
                                   owner=rec.owner, round=self.bus.round)
            if self.obs is not None:
                self.obs.metrics.counter("lease.expired").inc()
            return None
        if rec.fp != self.current_fp():
            return None
        return rec.owner

    def remote_holder(self, canonical: str,
                      calib_iters: int) -> Optional[str]:
        """The OTHER front-end holding a fresh lease on this canonical
        query at the current epoch, or None (no lease, expired, stale,
        or held by this front-end).  The scheduler's window-cost
        bounding uses this: a submission another front-end is already
        scanning costs ~0 against the window budget."""
        owner = self.holder(self.key_for(canonical, calib_iters))
        return owner if owner is not None and owner != self.node_id \
            else None

    def released_recently(self, key: str) -> bool:
        """True within one TTL of observing a peer's release of ``key``.
        A release means the owner COMPLETED the scan — the adoptee keeps
        waiting for the in-flight (or re-requested) final instead of
        falling back; past the TTL the marker expires and an adoption
        still incomplete falls back to the shared cache, where a
        completed owner's result is guaranteed to be."""
        rnd = self._peer_released.get(key)
        return rnd is not None and self.bus.round - rnd <= self.ttl

    def fp_current(self, fp: str) -> bool:
        """True while ``fp`` matches this front-end's present epoch
        fingerprint (resolution-time guard: an adoption whose epoch was
        bumped mid-stream must fall back, never serve)."""
        return fp == self.current_fp()

    # --------------------------- owner side ---------------------------- #
    def export(self, key: str, stream) -> None:
        """Register the :class:`~repro_torch.service.streaming.ResultStream`
        this front-end serves for a lease it won; adoptees' ``sub``
        requests resolve to it through the fan-out (subs that arrived
        early and were parked are flushed now — they follow the scan
        live from its first packet)."""
        self.exports[key] = stream
        self.stats.acquired += 1
        if self.obs is not None:
            self.obs.metrics.counter("lease.acquired").inc()
        if self.fanout is not None:
            self.fanout.flush(key)

    def release(self, key: str) -> None:
        """Release one lease (the window that held it resolved): stop
        re-announcing, drop the table record, and broadcast the release
        so adoptees-in-waiting fall back promptly instead of waiting out
        the TTL.  The export stays readable for one TTL (late ``sub``
        requests still get the buffered replay + final) and is then
        garbage-collected by :meth:`emit`."""
        self._intents.pop(key, None)
        rec = self._table.get(key)
        if rec is not None and rec.owner == self.node_id:
            del self._table[key]
        if key in self.exports:
            self._released[key] = self.bus.round
        if self.flight is not None:
            self.flight.record("lease_release", key=key,
                               round=self.bus.round)
        self.bus.broadcast(self.node_id, LEASE_TOPIC,
                           {"kind": "release", "key": key,
                            "owner": self.node_id})
        self.stats.released += 1
        if self.obs is not None:
            self.obs.metrics.counter("lease.released").inc()

    def revoke_owner(self, owner: str) -> int:
        """Revoke every lease held by ``owner`` — the failure
        policy's consumption point: banning a front-end drops its leases
        fleet-wide immediately instead of waiting out the TTL.  Applies
        locally and broadcasts; returns the number of local records
        dropped."""
        dropped = self._apply_revoke(owner)
        self.bus.broadcast(self.node_id, LEASE_TOPIC,
                           {"kind": "revoke", "owner": owner})
        return dropped

    def _apply_revoke(self, owner: str) -> int:
        stale = [k for k, r in self._table.items() if r.owner == owner]
        for k in stale:
            del self._table[k]
        if stale:
            if self.flight is not None:
                self.flight.record("lease_revoke", owner=owner,
                                   dropped=len(stale))
            self.stats.revoked += len(stale)
            if self.obs is not None:
                self.obs.metrics.counter("lease.revoked").inc(len(stale))
        return len(stale)

    # --------------------------- dispatch ------------------------------ #
    def on_message(self, payload: dict) -> None:
        """Handle one :data:`LEASE_TOPIC` bus message (``intent``,
        ``release`` or ``revoke`` — see the module docstring for the
        protocol)."""
        kind = payload["kind"]
        if kind == "intent":
            self._merge(LeaseRecord(
                key=payload["key"], owner=payload["owner"],
                round=payload["round"], last_seen=self.bus.round,
                fp=payload["fp"]))
        elif kind == "release":
            rec = self._table.get(payload["key"])
            if rec is not None and rec.owner == payload["owner"]:
                del self._table[payload["key"]]
            # remember the release for one TTL: an adoptee seeing it
            # knows the owner FINISHED (its replayed final is in
            # flight), which is grounds to wait, not to fall back
            self._peer_released[payload["key"]] = self.bus.round
        elif kind == "revoke":
            self._apply_revoke(payload["owner"])

    def table(self) -> Dict[str, Tuple[str, int]]:
        """Read-only view of the lease table for tests and operators:
        ``key -> (owner, announce round)``."""
        return {k: (r.owner, r.round) for k, r in self._table.items()}

    def intents(self) -> List[str]:
        """The keys this front-end is currently announcing (own active
        scan intents, re-broadcast every :meth:`emit`)."""
        return sorted(self._intents)
