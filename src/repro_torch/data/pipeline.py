"""Brick-resident training data pipeline (port of ``data/pipeline.py``).

GEPS rule: "data should not be moved when applying for a job submission" —
each host feeds the SPMD batch exclusively from bricks it owns.  The
packet scheduler (core/packets.py) decides which brick range each host
reads next, so slow hosts automatically contribute from smaller ranges and
a dead host's pending ranges fail over to replica owners (PROOF rule).

Token bricks are synthetic deterministic streams (seeded per brick) so any
replica produces byte-identical data — the property that makes failover
exact.

The port keeps the reference's numpy token streams and packet scheduling
(``core/{catalog,packets,replication}.py``); ``next_device_batch`` puts
the tokens on the trainer's device as ``int64``, the index type
``embed_lookup`` takes, where the reference places them on its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

import numpy as np
import torch

from repro_torch.core.catalog import MetadataCatalog
from repro_torch.core.packets import AdaptivePacketScheduler
from repro_torch.core.replication import failover_owner, place_replicas
from repro_torch.obs import trace


@dataclasses.dataclass
class TokenBrickSpec:
    brick_id: int
    node: int
    replicas: tuple
    n_sequences: int


class TokenBrickStore:
    """Deterministic synthetic token shards ("bricks") per node."""

    def __init__(self, *, vocab_size: int, seq_len: int, n_bricks: int,
                 seqs_per_brick: int, n_nodes: int, replication: int = 2,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.specs: Dict[int, TokenBrickSpec] = {}
        for bid in range(n_bricks):
            node = bid % n_nodes
            self.specs[bid] = TokenBrickSpec(
                bid, node, place_replicas(bid, node, n_nodes, replication),
                seqs_per_brick)
        self.n_nodes = n_nodes

    def read(self, brick_id: int, start: int, count: int) -> np.ndarray:
        """(count, seq_len) int32 — identical from any replica (seeded)."""
        spec = self.specs[brick_id]
        if not (0 <= start and start + count <= spec.n_sequences):
            raise ValueError(f"rows [{start}, {start + count}) outside brick "
                             f"{brick_id}'s {spec.n_sequences}")
        # deterministic per-row: regenerate row-by-row seeds for exactness
        rows = []
        for r in range(start, start + count):
            rrng = np.random.default_rng((self.seed, brick_id, r))
            rows.append(rrng.integers(0, self.vocab_size,
                                      size=self.seq_len, dtype=np.int32))
        return np.stack(rows)

    def owners(self, brick_id: int) -> List[int]:
        spec = self.specs[brick_id]
        return [spec.node, *spec.replicas]


class BrickDataPipeline:
    """Yields fixed-size global batches assembled brick-locally.

    Each global batch of B sequences is split into per-host quotas; hosts
    fill their quota from packets over their OWN bricks.  On failure the
    scheduler re-leases the dead host's packets to replica owners, so the
    global batch content is unchanged (deterministic bricks) — training is
    bitwise reproducible across failures."""

    def __init__(self, store: TokenBrickStore, catalog: MetadataCatalog,
                 *, global_batch: int,
                 device: Union[str, torch.device] = "cuda"):
        from repro_torch.kernels import resolve_device
        self.store = store
        self.catalog = catalog
        self.global_batch = global_batch
        self.device = resolve_device(device)
        self.sched = AdaptivePacketScheduler(
            catalog, base_packet=max(1, global_batch // max(
                1, len(catalog.alive_nodes()))),
            min_packet=1, max_packet=global_batch)
        self._work: List[tuple] = []  # (brick_id, cursor)
        for bid in sorted(store.specs):
            self._work.append([bid, 0])
        self._wi = 0

    def _refill(self, needed: int):
        added = 0
        while added < needed and self._work:
            bid, cursor = self._work[self._wi % len(self._work)]
            spec = self.store.specs[bid]
            room = spec.n_sequences - cursor
            take = min(room, needed - added)
            if take > 0:
                self.sched.add_work(bid, take)
                self._work[self._wi % len(self._work)][1] += take
                added += take
            if self._work[self._wi % len(self._work)][1] >= spec.n_sequences:
                # brick exhausted this epoch: reset cursor (infinite stream)
                self._work[self._wi % len(self._work)][1] = 0
            self._wi += 1
        return added

    def next_batch(self) -> np.ndarray:
        """(global_batch, seq_len) int32 assembled via packet leases."""
        self._refill(self.global_batch)
        rows = []
        alive = self.catalog.alive_nodes()
        if not alive:
            raise RuntimeError("no alive nodes to feed the batch")
        ni = 0
        while len(rows) < self.global_batch:
            node = alive[ni % len(alive)]
            ni += 1
            pkt = self.sched.next_packet(node)
            if pkt is None:
                if self.sched.exhausted:
                    self._refill(self.global_batch - len(rows))
                continue
            owners = self.store.owners(pkt.brick_id)
            dead = self.catalog.dead_nodes()
            owner = failover_owner(owners, dead)
            if owner < 0:
                raise RuntimeError(f"brick {pkt.brick_id} lost")
            data = self.store.read(pkt.brick_id, pkt.start, pkt.size)
            self.sched.complete(pkt.packet_id, pkt.size, 1e-3 * pkt.size)
            rows.append(data)
        batch = np.concatenate(rows, axis=0)[:self.global_batch]
        return batch

    def next_device_batch(self) -> dict:
        """The next batch as int64 tokens (and labels, the same tensor) on
        the pipeline's device; while ``torch.profiler`` records, a
        ``data.fetch`` span of the step tracer (``obs/trace.py``) around
        ``data.read`` (the packets read on the host) and ``data.copy``."""
        with trace.step_root("data.fetch", self.device,
                             rows=self.global_batch) as span:
            with trace.step_span("data.read"):
                batch = self.next_batch()
            with trace.step_span("data.copy"):
                tokens = torch.from_numpy(batch).to(device=self.device,
                                                    dtype=torch.int64)
            if span is not None:
                span.attrs["bytes"] = batch.nbytes
        return {"tokens": tokens, "labels": tokens}
