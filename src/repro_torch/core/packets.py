"""PROOF-style adaptive packet scheduler (straggler mitigation).

From the paper's related work: "The master server distributes the event
data packets to every slave server, carefully adjusting the packet size
such that the slower slave servers get smaller data packets than faster
slave servers ... in case a slave failed then remaining slaves can
reprocess its packets."  GEPS lists load balancing toward the best nodes
as future work; we build both mechanisms here:

- packet size proportional to each node's throughput EMA (catalog/GRIS),
- a central work queue: packets leased to nodes, re-queued on failure or
  timeout (work stealing covers stragglers *and* dead nodes).

The same scheduler feeds per-host microbatch sizing in the training data
pipeline (data/pipeline.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.catalog import MetadataCatalog

#: bounded exponent for the geometric stream ramp, so
#: ``ramp_factor ** n`` stays finite on arbitrarily long scans
RAMP_EXP_CAP = 64


def ramp_cap(n_done: int, ramp_start: int, ramp_factor: float) -> float:
    """Stream-aware packet-size cap after ``n_done`` completed packets:
    ``ramp_start * ramp_factor ** n_done`` with the exponent bounded by
    :data:`RAMP_EXP_CAP`.  The ONE place the ramp rule lives — both the
    simulated scheduler (:class:`AdaptivePacketScheduler`) and the SPMD
    backend's chunked scan (``core/backend.py``) size their early
    packets from it, which is what keeps their matched-packetization
    equivalence intact when the ramp is tuned."""
    return ramp_start * ramp_factor ** min(n_done, RAMP_EXP_CAP)


@dataclasses.dataclass
class Packet:
    """A leased unit of work: a contiguous event range of one brick,
    currently assigned to (at most) one node."""
    packet_id: int
    brick_id: int
    start: int         # offset within the brick
    size: int
    lease: Optional[int] = None  # node currently processing it
    attempts: int = 0


class AdaptivePacketScheduler:
    """Central work queue with PROOF-rule packet sizing: slower nodes get
    smaller packets, packets shrink as the queue drains, and failed or
    dead-node packets re-queue at the front for recovery-first service.

    ``ramp_start`` enables the *stream-aware* sizing mode: the first
    packets are capped at ``ramp_start`` events and the cap grows by
    ``ramp_factor`` per completed packet until the PROOF size takes over.
    Streaming delivery wants the first exact prefix on the wire as early
    as possible, which is exactly what PROOF's up-front ~queue/(4·nodes)
    packets pessimize; the ramp keeps time-to-first-partial small while
    converging to adaptive sizing for the bulk of the scan (so the
    makespan cost of streaming stays negligible)."""

    def __init__(self, catalog: MetadataCatalog, *, base_packet: int = 64,
                 min_packet: int = 8, max_packet: int = 1024,
                 max_attempts: int = 5, ramp_start: Optional[int] = None,
                 ramp_factor: float = 2.0):
        if ramp_start is not None and ramp_start <= 0:
            raise ValueError("ramp_start must be positive")
        if ramp_factor <= 1.0:
            raise ValueError("ramp_factor must be > 1")
        self.catalog = catalog
        self.base = base_packet
        self.min = min_packet
        self.max = max_packet
        self.max_attempts = max_attempts
        self.ramp_start = ramp_start
        self.ramp_factor = ramp_factor
        self.queue: deque = deque()   # (brick_id, start, remaining)
        self.inflight: Dict[int, Packet] = {}
        self.done: List[Packet] = []
        self._next_pid = 0

    # ------------------------------------------------------------------ #
    def add_work(self, brick_id: int, n_events: int):
        """Enqueue one brick's events as packetizable work."""
        self.queue.append([brick_id, 0, n_events])

    def packet_size_for(self, node: int) -> int:
        """Slower nodes get smaller packets, and packets shrink as the
        queue drains so no node holds a large tail packet (PROOF rule)."""
        alive = self.catalog.alive_nodes()
        infos = [self.catalog.node(n) for n in alive]
        if not infos:
            return self.base
        mean = sum(i.throughput_ema for i in infos) / len(infos)
        mine = self.catalog.node(node).throughput_ema
        size = int(self.base * (mine / mean if mean > 0 else 1.0))
        remaining = sum(w[2] for w in self.queue)
        drain_cap = max(self.min, remaining // max(1, len(alive)))
        size = max(self.min, min(self.max, size, drain_cap))
        if self.ramp_start is not None:
            # stream-aware ramp: small early packets, growing geometrically
            # with scan progress until PROOF sizing dominates (int() runs
            # only on a value known to be < size)
            cap = ramp_cap(len(self.done), self.ramp_start,
                           self.ramp_factor)
            if cap < size:
                size = max(1, int(cap))
        return size

    def next_packet(self, node: int) -> Optional[Packet]:
        """Lease the next packet to ``node`` (None when queue drained)."""
        if not self.catalog.node(node).alive:
            return None
        if not self.queue:
            return None
        size = self.packet_size_for(node)
        brick_id, start, remaining = self.queue[0]
        take = min(size, remaining)
        pkt = Packet(self._next_pid, brick_id, start, take, lease=node)
        self._next_pid += 1
        if take == remaining:
            self.queue.popleft()
        else:
            self.queue[0][1] += take
            self.queue[0][2] -= take
        self.inflight[pkt.packet_id] = pkt
        return pkt

    def complete(self, packet_id: int, events: int, seconds: float):
        """Acknowledge a finished packet and feed the node's rate EMA."""
        pkt = self.inflight.pop(packet_id)
        self.catalog.node(pkt.lease).observe(events, seconds)
        self.done.append(pkt)

    def fail(self, packet_id: int, *, node_dead: bool = False):
        """Re-queue a failed packet (PROOF reassignment)."""
        pkt = self.inflight.pop(packet_id)
        pkt.attempts += 1
        if node_dead:
            self.catalog.mark_dead(pkt.lease)
        pkt.lease = None
        if pkt.attempts >= self.max_attempts:
            raise RuntimeError(
                f"packet {pkt.packet_id} failed {pkt.attempts} times")
        # re-queue at the FRONT so recovery work finishes first
        self.queue.appendleft([pkt.brick_id, pkt.start, pkt.size])

    def requeue_node(self, node: int):
        """Return all packets leased to a (dead) node to the queue."""
        for pid in [p for p, pkt in self.inflight.items()
                    if pkt.lease == node]:
            self.fail(pid, node_dead=True)

    @property
    def exhausted(self) -> bool:
        """True when no work is queued or in flight (the job swept)."""
        return not self.queue and not self.inflight
