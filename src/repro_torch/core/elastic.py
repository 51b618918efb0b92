"""Elastic scaling: "the scalability of GEPS can be easily obtained through
freely adding into or removing any grid computing and storage node"
(paper section 4).

Host level: node join/leave updates the catalogue, fails bricks over to
replicas, and produces migration / re-replication plans.

Mesh level: ``elastic_mesh_shape`` picks the largest runnable mesh for
the surviving host count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.brick import BrickStore
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.core.replication import failover_owner, rereplication_plan


@dataclasses.dataclass
class MigrationPlan:
    """Outcome of a node join/leave: primary reassignments, replica
    copies to schedule, and bricks with no surviving copy."""
    reassign_primary: List[Tuple[int, int, int]]  # (brick, old, new)
    copies: List[Tuple[int, int, int]]            # (brick, src, dst)
    lost_bricks: List[int]


class ElasticManager:
    """Applies node join/leave to the catalogue + brick store and emits
    the :class:`MigrationPlan` a control plane would execute."""

    def __init__(self, catalog: MetadataCatalog, store: BrickStore):
        self.catalog = catalog
        self.store = store

    def node_leave(self, node: int) -> MigrationPlan:
        """Fail ``node``'s bricks over to replicas; plan re-replication."""
        self.catalog.mark_dead(node)
        dead = self.catalog.dead_nodes()
        reassign, lost = [], []
        for bid, spec in sorted(self.store.specs.items()):
            if spec.node in dead:
                new_owner = failover_owner(self.store.owners(bid), dead)
                if new_owner < 0:
                    lost.append(bid)
                else:
                    reassign.append((bid, spec.node, new_owner))
                    spec.node = new_owner
                    spec.replicas = tuple(
                        r for r in spec.replicas if r != new_owner)
        copies = rereplication_plan(self.store.specs, dead,
                                    self.store.n_nodes)
        return MigrationPlan(reassign, copies, lost)

    def node_join(self, node: int) -> MigrationPlan:
        """Re-balance: move bricks from the most-loaded nodes to the joiner."""
        self.catalog.mark_alive(node)
        loads: Dict[int, List[int]] = {}
        for bid, spec in self.store.specs.items():
            loads.setdefault(spec.node, []).append(bid)
        total = len(self.store.specs)
        alive = self.catalog.alive_nodes()
        target = max(1, total // max(1, len(alive)))
        moves = []
        have = len(loads.get(node, []))
        donors = sorted(loads.items(), key=lambda kv: -len(kv[1]))
        for donor, bricks in donors:
            if donor == node:
                continue
            while have < target and len(bricks) > target:
                bid = bricks.pop()
                moves.append((bid, donor, node))
                self.store.specs[bid].node = node
                have += 1
        return MigrationPlan(moves, [], [])

    def apply_copies(self, plan: MigrationPlan):
        """Execute re-replication copies in the host store (restores the
        replication factor after failures)."""
        for bid, src, dst in plan.copies:
            spec = self.store.specs[bid]
            if dst not in spec.replicas and dst != spec.node:
                spec.replicas = spec.replicas + (dst,)


# --------------------------------------------------------------------------- #
def elastic_mesh_shape(n_hosts_alive: int, *, model_parallel: int = 16,
                       pods: int = 1) -> Optional[Tuple[int, ...]]:
    """Largest (data, model) mesh runnable on the surviving chips: keep TP
    fixed (model weights layout unchanged), shrink the data/brick axis to
    the largest power of two that fits.  Returns None if nothing fits."""
    chips = n_hosts_alive
    data = chips // (model_parallel * pods)
    if data < 1:
        return None
    # largest power of two <= data keeps batch divisibility simple
    p = 1
    while p * 2 <= data:
        p *= 2
    return (pods, p, model_parallel) if pods > 1 else (p, model_parallel)
