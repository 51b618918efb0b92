"""Grid bricks: the paper's core storage organization.

"The data storage is split among all grid nodes having each one a piece of
the whole information" (abstract).  A *brick* is a fixed-size slice of the
event store pinned to one node's local disk; jobs ship to bricks, results
ship back — bricks never move at job time.

In the port a brick is a dict of torch tensors resident on the store's
``device``: the data is generated on the host (numpy, byte-equal to the
JAX package's store for the same seed), moved to the device once, and
every scan reads views of it in place.  The JAX package's mesh placement
(``batch_sharding`` / ``shard_to_mesh``) becomes plain device placement
(:func:`to_device`) on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.replication import place_replicas
from repro_torch.kernels import resolve_device


@dataclasses.dataclass
class BrickSpec:
    """Catalogue entry for one brick: primary owner, replica owners, and
    the global event-id range the brick covers."""
    brick_id: int
    node: int                       # primary owner
    replicas: Tuple[int, ...]       # replica owners (paper section 7)
    n_events: int
    id_range: Tuple[int, int]       # [start, end) global event ids


@dataclasses.dataclass
class BrickStore:
    """The brick-sharded event store: per-brick EventBatches of tensors
    on ``device`` plus the placement/replication map the JSE simulation
    schedules against."""
    schema: ev.EventSchema
    bricks: Dict[int, dict]                 # brick_id -> EventBatch (tensors)
    specs: Dict[int, BrickSpec]
    n_nodes: int
    device: torch.device = torch.device("cpu")

    @property
    def n_events(self) -> int:
        """Total events across every brick in the store."""
        return sum(s.n_events for s in self.specs.values())

    def bricks_on_node(self, node: int, include_replicas=False) -> List[int]:
        """Brick ids whose primary (optionally: any replica) is ``node``."""
        out = []
        for bid, spec in self.specs.items():
            if spec.node == node or (include_replicas and node in spec.replicas):
                out.append(bid)
        return sorted(out)

    def owners(self, brick_id: int) -> List[int]:
        """Every node holding the brick, primary first (failover order)."""
        spec = self.specs[brick_id]
        return [spec.node, *spec.replicas]

    def check_device(self, device: Union[str, torch.device]) -> torch.device:
        """Resolve ``device`` and require the store to live there (a
        backend never copies bricks at job time)."""
        dev = resolve_device(device)
        if dev != self.device:
            raise ValueError(f"brick store lives on {self.device}, "
                             f"not on the requested device {dev}")
        return dev


def to_device(batch: dict, device: Union[str, torch.device]) -> dict:
    """Place an EventBatch (numpy arrays or tensors) on ``device`` — the
    one-card twin of the JAX package's ``shard_to_mesh``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def create_store(schema: ev.EventSchema, *, n_events: int, n_nodes: int,
                 events_per_brick: int, replication: int = 2,
                 seed: int = 0,
                 device: Union[str, torch.device] = "cuda") -> BrickStore:
    """Distribute a synthetic event dataset over n_nodes as bricks, each
    generated on the host and moved to ``device`` once."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bricks, specs = {}, {}
    brick_id, offset = 0, 0
    while offset < n_events:
        n = min(events_per_brick, n_events - offset)
        batch = ev.host_events(rng, schema, n, id_offset=offset)
        node = brick_id % n_nodes
        replicas = place_replicas(brick_id, node, n_nodes, replication)
        specs[brick_id] = BrickSpec(brick_id, node, replicas, n,
                                    (offset, offset + n))
        bricks[brick_id] = to_device(batch, dev)
        offset += n
        brick_id += 1
    return BrickStore(schema, bricks, specs, n_nodes, dev)


def store_from_reference(ref_store, device: Union[str, torch.device] = "cuda"
                         ) -> BrickStore:
    """The port's store for a JAX-package ``BrickStore``, read through its
    attributes only (``schema`` dims, numpy ``bricks``, ``specs``,
    ``n_nodes``): byte-equal bricks and equal specs on ``device``."""
    dev = resolve_device(device)
    s = ref_store.schema
    schema = ev.EventSchema(s.n_scalars, s.max_tracks, s.track_vars)
    bricks = {bid: to_device({k: np.asarray(v) for k, v in b.items()}, dev)
              for bid, b in ref_store.bricks.items()}
    specs = {bid: BrickSpec(sp.brick_id, sp.node, tuple(sp.replicas),
                            sp.n_events, tuple(sp.id_range))
             for bid, sp in ref_store.specs.items()}
    return BrickStore(schema, bricks, specs, ref_store.n_nodes, dev)


def gather_store(store: BrickStore, brick_ids: Optional[List[int]] = None):
    """Concatenate bricks in id order (on the store's device) — for
    oracles/tests."""
    ids = sorted(brick_ids if brick_ids is not None else store.bricks)
    parts = [store.bricks[i] for i in ids]
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
