"""Cross-front-end stream fan-out: ticket routing for progressive
results.

The streaming layer binds a ticket's
:class:`~repro_torch.service.streaming.ResultStream` to the front-end that runs
its scan.  In a fleet, the tenant that submitted on front-end A may be
load-balanced to front-end B for reads — DIAL's "any door" interactive
rule — so B must be able to serve A's stream with the *same* delivery
guarantees as local streaming:

- snapshots arrive in publish order and are the same objects the local
  stream published (bit-identical progressive results);
- a remote reader that attaches mid-scan sees exactly what a local
  late reader would: the currently buffered snapshots, then live ones;
- ``final=True`` is forwarded only for the owner's final snapshot, and an
  owner-side abort arrives as an abort — a partial is NEVER surfaced as
  final, no matter what the bus dropped (a lost final leaves the proxy
  OPEN/incomplete rather than wrongly complete).

Protocol (all over the fabric bus, topic ``stream``): the reader's
front-end sends ``sub`` to the owner; the owner replays the buffered
prefix and subscribes the bus to future publishes, forwarding ``snap``
messages and a ``close`` on finish/abort.  The proxy is an ordinary
:class:`~repro_torch.service.streaming.ResultStream`, so tenant code
(``poll``/``latest``/``subscribe``/iteration) is identical either way.
Out-of-order or duplicated snapshots (possible under exotic per-link
delays) are guarded by per-snapshot sequence numbers on the proxy side.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.fabric.bus import MessageBus
from repro_torch.service import streaming as streaming_lib

STREAM_TOPIC = "stream"


@dataclasses.dataclass
class FanoutStats:
    """Monotonic fan-out counters per front-end: subscriptions served,
    snapshots forwarded/received, closes forwarded, and out-of-order
    snapshots discarded by a proxy."""
    subs_served: int = 0
    snaps_sent: int = 0
    snaps_received: int = 0
    closes_sent: int = 0
    stale_dropped: int = 0


class StreamFanout:
    """One front-end's fan-out endpoint: exporter for locally owned
    streams, proxy factory for remotely owned ones.

    ``resolve`` maps a fleet-level stream key to the local
    :class:`~repro_torch.service.streaming.ResultStream` (or None), supplied by
    the Fleet; everything else is self-contained.
    """

    def __init__(self, node_id: str, bus: MessageBus,
                 resolve: Callable[[int],
                                   Optional[streaming_lib.ResultStream]],
                 *, proxy_capacity: int = 64):
        self.node_id = node_id
        self.bus = bus
        self.resolve = resolve
        self.proxy_capacity = proxy_capacity
        self.stats = FanoutStats()
        #: optional predicate over keys: True defers an unresolvable
        #: ``sub`` instead of aborting it (the stream is EXPECTED to
        #: appear — e.g. a lease this front-end announced but whose
        #: window has not dispatched yet); :meth:`flush` serves the
        #: parked subs once the stream exists
        self.defer: Optional[Callable[[object], bool]] = None
        self._proxies: Dict[int, streaming_lib.ResultStream] = {}
        self._proxy_seq: Dict[int, int] = {}  # last seq applied per proxy
        self._exports: Dict[Tuple[int, str], bool] = {}  # dedup subs
        self._pending_subs: Dict[int, List[str]] = {}  # key -> readers
        bus.register(node_id)

    # ---------------------------- reader side -------------------------- #
    def proxy(self, key: int, owner: str) -> streaming_lib.ResultStream:
        """Return (creating on first use) the local proxy stream for a
        ticket owned by ``owner``, and send the subscription request.  The
        proxy fills as bus rounds deliver; re-calls reuse one proxy."""
        if key in self._proxies:
            return self._proxies[key]
        proxy = streaming_lib.ResultStream(key,
                                           capacity=self.proxy_capacity)
        self._proxies[key] = proxy
        self._proxy_seq[key] = -1
        self.bus.send(self.node_id, owner, STREAM_TOPIC,
                      {"kind": "sub", "key": key, "reader": self.node_id})
        return proxy

    def resubscribe(self, key: int, owner: str) -> None:
        """Re-send the subscription for an existing proxy — the healing
        move when a partition/drop may have swallowed snapshots (or the
        original ``sub``) mid-adoption.  The owner replays its buffered
        prefix (and the final, if the stream already finished); the
        proxy's sequence guard discards whatever it already has, so
        re-subscribing is always safe."""
        if key in self._proxies:
            self.bus.send(self.node_id, owner, STREAM_TOPIC,
                          {"kind": "sub", "key": key,
                           "reader": self.node_id})

    # ---------------------------- owner side --------------------------- #
    def _export(self, key: int, reader: str) -> None:
        stream = self.resolve(key)
        if stream is None:
            if self.defer is not None and self.defer(key):
                # the stream is expected (an announced-but-undispatched
                # lease): park the sub; flush() serves it — live from
                # the first packet — once the export registers
                readers = self._pending_subs.setdefault(key, [])
                if reader not in readers:
                    readers.append(reader)
                return
            self.bus.send(self.node_id, reader, STREAM_TOPIC,
                          {"kind": "close", "key": key, "state": "ABORTED",
                           "note": f"no stream for ticket {key} on "
                                   f"{self.node_id}"})
            self.stats.closes_sent += 1
            return
        self.stats.subs_served += 1

        def forward(snap: streaming_lib.StreamSnapshot) -> None:
            self.bus.send(self.node_id, reader, STREAM_TOPIC,
                          {"kind": "snap", "key": key, "snap": snap})
            self.stats.snaps_sent += 1

        def closed(s: streaming_lib.ResultStream) -> None:
            self.bus.send(self.node_id, reader, STREAM_TOPIC,
                          {"kind": "close", "key": key, "state": s.state,
                           "note": s.note})
            self.stats.closes_sent += 1

        # ALWAYS replay what a local late reader would drain (a reader
        # that released its proxy and re-subscribed starts from seq -1
        # again, so it needs the prefix; a still-attached reader's proxy
        # discards the duplicates by sequence number), then follow live
        # publishes — but register the live listeners only once per
        # (ticket, reader) or every re-subscribe would duplicate them
        replayed = stream.buffered()
        for snap in replayed:
            forward(snap)
        if stream.closed:
            if (stream.done and not any(s.final for s in replayed)
                    and stream.latest() is not None):
                # local tenant already drained the final from the buffer;
                # a DONE stream must still hand the remote reader its final
                forward(stream.latest())
            closed(stream)
            return
        if not self._exports.get((key, reader)):
            self._exports[(key, reader)] = True
            stream.subscribe(forward)
            stream.on_close(closed)

    def flush(self, key: int) -> None:
        """Serve every sub parked on ``key`` (call when the key's stream
        has become resolvable): deferred readers subscribe live from the
        stream's first publish, exactly as if the sub had arrived after
        the export."""
        for reader in self._pending_subs.pop(key, []):
            self._export(key, reader)

    # ---------------------------- dispatch ----------------------------- #
    def on_message(self, payload: dict) -> None:
        """Handle one ``stream``-topic bus message (both directions)."""
        kind, key = payload["kind"], payload["key"]
        if kind == "sub":
            self._export(key, payload["reader"])
            return
        proxy = self._proxies.get(key)
        if proxy is None:
            return  # reader released the proxy; drop silently
        if kind == "snap":
            snap = payload["snap"]
            self.stats.snaps_received += 1
            if snap.seq <= self._proxy_seq[key] and not snap.final:
                self.stats.stale_dropped += 1  # reordered duplicate
                return
            self._proxy_seq[key] = max(self._proxy_seq[key], snap.seq)
            if snap.final:
                proxy.finish(snap)  # the ONLY path that closes as DONE
            else:
                proxy.publish(snap)
        elif kind == "close":
            if payload["state"] == streaming_lib.ABORTED:
                proxy.abort(payload.get("note", "owner aborted"))
            # a DONE close needs no action: finish() already ran when the
            # final snapshot arrived; if the final was lost in transit the
            # proxy deliberately stays OPEN (never fabricate a final)

    def release(self, key: int) -> None:
        """Drop a proxy (reader done); later messages for it are ignored."""
        self._proxies.pop(key, None)
        self._proxy_seq.pop(key, None)
