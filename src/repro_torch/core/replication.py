"""Replica placement and failover — the paper's section-7 future work
("create a redundancy mechanism to recover from a malfunction in the
nodes"), built as a first-class feature.

Placement is ring-offset: replicas of a brick owned by node n go to
n + N//r, n + 2N//r, ... (mod N) — spreading load so a single node failure
scatters its recovery reads across the ring instead of hammering one peer.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple


def place_replicas(brick_id: int, node: int, n_nodes: int,
                   replication: int) -> Tuple[int, ...]:
    """Replica owners for a brick (excluding the primary)."""
    r = max(0, min(replication - 1, n_nodes - 1))
    if r == 0:
        return ()
    stride = max(1, n_nodes // (r + 1))
    return tuple((node + (i + 1) * stride) % n_nodes for i in range(r))


def failover_owner(owners: List[int], dead: Set[int]) -> int:
    """First alive owner, or -1 if the brick is lost (paper's acknowledged
    worst case when running without replication)."""
    for n in owners:
        if n not in dead:
            return n
    return -1


def rereplication_plan(specs: Dict[int, "object"], dead: Set[int],
                       n_nodes: int) -> List[Tuple[int, int, int]]:
    """(brick_id, src_node, dst_node) copies needed to restore the
    replication factor after failures."""
    plan = []
    alive = [n for n in range(n_nodes) if n not in dead]
    if not alive:
        return plan
    rr = 0
    for bid, spec in sorted(specs.items()):
        owners = [spec.node, *spec.replicas]
        alive_owners = [n for n in owners if n not in dead]
        lost = len(owners) - len(alive_owners)
        if lost == 0 or not alive_owners:
            continue
        src = alive_owners[0]
        for _ in range(lost):
            while alive[rr % len(alive)] in owners:
                rr += 1
            dst = alive[rr % len(alive)]
            rr += 1
            plan.append((bid, src, dst))
    return plan
