"""Metadata catalogue + node information service.

Plays the roles of the paper's PostgreSQL meta-data catalogue (job tuples,
raw-data distribution, results) and of GRIS/LDAP in MDS (per-node resource
info: processors, bandwidth, liveness).  The JSE broker polls this object
exactly as the paper's broker "searches from time to time into the
Meta-data catalogue".

Persisted as JSON so a restarted JSE recovers job state (checkpoint/restart
at the control plane).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

PENDING, RUNNING, DONE, FAILED = "PENDING", "RUNNING", "DONE", "FAILED"


@dataclasses.dataclass
class NodeInfo:
    """Per-node resource record (the paper's GRIS/LDAP entry): liveness,
    nominal capacity, and the PROOF-style throughput EMA the adaptive
    packet scheduler sizes packets from."""
    node_id: int
    n_cpus: int = 8
    bandwidth_mbps: float = 100.0  # paper: fast Ethernet
    alive: bool = True
    throughput_ema: float = 1.0    # events/s, PROOF-style speed estimate
    packets_done: int = 0

    def observe(self, events: int, seconds: float, decay: float = 0.7):
        """Fold one completed packet's measured rate into the EMA."""
        if seconds <= 0:
            return
        rate = events / seconds
        self.throughput_ema = decay * self.throughput_ema + (1 - decay) * rate
        self.packets_done += 1


@dataclasses.dataclass
class JobRecord:
    """One job tuple in the catalogue: expression, lifecycle status and
    timestamps, target bricks, and the merged result summary."""
    job_id: int
    expr: str
    calib_iters: int
    status: str = PENDING
    submit_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0
    bricks: Tuple[int, ...] = ()
    result: Optional[dict] = None
    events_processed: int = 0
    failures: int = 0
    note: str = ""
    tenant: str = ""       # multi-tenant service: submitting tenant
    batch_id: int = -1     # shared-scan batch this job was coalesced into


class MetadataCatalog:
    """The paper's PostgreSQL meta-data catalogue + GRIS in one object:
    job tuples, per-node resource info, dataset versioning (epoch hooks
    drive cache invalidation), and JSON persistence."""

    def __init__(self, n_nodes: int = 0):
        self.jobs: Dict[int, JobRecord] = {}
        self.nodes: Dict[int, NodeInfo] = {
            i: NodeInfo(i) for i in range(n_nodes)}
        self._next_job = 0
        # dataset version: bumped whenever the raw-data distribution
        # changes (new run appended, brick recalibrated, ...) — consumers
        # (the service result cache) subscribe to invalidate stale results
        self.dataset_epoch = 0
        self._epoch_hooks: List[Callable[[int], None]] = []

    # ------------------------- job tuples --------------------------- #
    def submit(self, expr: str, calib_iters: int = 4,
               bricks: Tuple[int, ...] = (), *, tenant: str = "",
               batch_id: int = -1) -> int:
        """Insert a PENDING job tuple; returns the new job id."""
        jid = self._next_job
        self._next_job += 1
        self.jobs[jid] = JobRecord(jid, expr, calib_iters,
                                   submit_time=time.time(), bricks=bricks,
                                   tenant=tenant, batch_id=batch_id)
        return jid

    # ------------------------- dataset versioning ------------------- #
    def on_dataset_bump(self, hook: Callable[[int], None]):
        """Register a callback fired with the new epoch on every bump."""
        self._epoch_hooks.append(hook)

    def off_dataset_bump(self, hook: Callable[[int], None]):
        """Remove a previously registered bump callback (no-op if absent)."""
        try:
            self._epoch_hooks.remove(hook)
        except ValueError:
            pass

    def bump_dataset_version(self) -> int:
        """Record a change to the raw-data distribution (paper: the
        catalogue tracks where the data lives; here also *which version*)."""
        self.dataset_epoch += 1
        for hook in self._epoch_hooks:
            hook(self.dataset_epoch)
        return self.dataset_epoch

    def set_dataset_epoch(self, epoch: int) -> int:
        """Adopt an externally reconciled dataset epoch (the fabric's
        gossip layer merges version vectors and pushes the result here).
        Epochs only move forward — a stale digest can never roll the
        catalogue back — and an actual advance fires the same bump hooks
        as a local ``bump_dataset_version`` so caches invalidate
        identically either way.  Returns the (possibly unchanged) epoch."""
        if epoch > self.dataset_epoch:
            self.dataset_epoch = epoch
            for hook in self._epoch_hooks:
                hook(self.dataset_epoch)
        return self.dataset_epoch

    def next_pending(self) -> Optional[JobRecord]:
        """Oldest PENDING job, or None (what the polling broker picks up)."""
        for jid in sorted(self.jobs):
            if self.jobs[jid].status == PENDING:
                return self.jobs[jid]
        return None

    def update(self, jid: int, **fields):
        """Set fields on a job tuple (status transitions, results, ...)."""
        rec = self.jobs[jid]
        for k, v in fields.items():
            setattr(rec, k, v)

    # ------------------------- node info (GRIS) --------------------- #
    def node(self, node_id: int) -> NodeInfo:
        """NodeInfo for ``node_id`` (created on first reference)."""
        return self.nodes.setdefault(node_id, NodeInfo(node_id))

    def mark_dead(self, node_id: int):
        """Record a node death (failover and re-queue consult this)."""
        self.node(node_id).alive = False

    def mark_alive(self, node_id: int):
        """Bring a node back (rejoin after repair/elastic scale-up)."""
        self.node(node_id).alive = True

    def alive_nodes(self) -> List[int]:
        """Sorted ids of nodes currently marked alive."""
        return sorted(n for n, info in self.nodes.items() if info.alive)

    def dead_nodes(self) -> set:
        """Ids of nodes currently marked dead."""
        return {n for n, info in self.nodes.items() if not info.alive}

    def grid_info(self, node_id: int) -> dict:
        """The paper's 'query properties of the grid nodes' (LDAP port 2135)."""
        info = self.node(node_id)
        return dataclasses.asdict(info)

    # ------------------------- persistence -------------------------- #
    def to_json(self) -> str:
        """Serialize the whole catalogue (jobs, nodes, epoch) to JSON."""
        return json.dumps({
            "jobs": {k: dataclasses.asdict(v) for k, v in self.jobs.items()},
            "nodes": {k: dataclasses.asdict(v) for k, v in self.nodes.items()},
            "next_job": self._next_job,
            "dataset_epoch": self.dataset_epoch,
        })

    @classmethod
    def from_json(cls, text: str) -> "MetadataCatalog":
        """Rebuild a catalogue from :meth:`to_json` output (JSE restart
        recovery at the control plane)."""
        data = json.loads(text)
        cat = cls()
        for k, v in data["jobs"].items():
            v["bricks"] = tuple(v["bricks"])
            cat.jobs[int(k)] = JobRecord(**v)
        for k, v in data["nodes"].items():
            cat.nodes[int(k)] = NodeInfo(**v)
        cat._next_job = data["next_job"]
        cat.dataset_epoch = data.get("dataset_epoch", 0)
        return cat
