"""Query-result cache for the multi-tenant service.

At interactive scale the dominant cost is re-reading brick-resident events
for queries the grid has already answered (the LHC operational lesson:
cache and amortize, don't re-scan).  Entries are keyed on

    (canonical expression, calib_iters, dataset epoch)

so textually different but identical queries share one slot, and a
``MetadataCatalog.bump_dataset_version()`` (new run appended, brick
recalibrated) makes every older entry unreachable; a registered
invalidation hook also purges them eagerly to free memory.  Eviction is
plain LRU.

Entries come in at two granularities sharing one keyspace: whole-query
results (``put``) and *fragment-level* results (``put_fragment``) — shared
boolean subexpressions the planner materialized during a shared scan.  A
fragment's key is its canonical form (``query_lib.node_key``), which is
exactly what a future submission of that expression canonicalizes to, so
fragment entries are hit by the ordinary ``get`` path with zero brick I/O.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

from repro_torch.core import merge as merge_lib
from repro_torch.core import query as query_lib


@dataclasses.dataclass
class CacheStats:
    """Monotonic cache counters (hits/misses/evictions/invalidations and
    planner-installed fragment entries)."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidated: int = 0
    fragment_puts: int = 0  # fragment-level entries installed by the planner
    # hits satisfied by the fleet's shared L2 tier (always 0 for a plain
    # per-process cache; see repro_torch.fabric.shared_cache.TieredResultCache)
    l2_hits: int = 0


class ResultCache:
    """LRU result cache keyed on (canonical expr, calib_iters, dataset
    epoch), holding whole-query and fragment-level entries in one
    keyspace; a catalogue dataset bump purges stale epochs eagerly."""

    def __init__(self, capacity: int = 256, catalog=None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple, merge_lib.QueryResult]" = \
            OrderedDict()
        self.stats = CacheStats()
        self._catalog = catalog
        if catalog is not None:
            catalog.on_dataset_bump(self._on_dataset_bump)

    def detach(self):
        """Unhook from the catalog (a long-lived catalog would otherwise
        keep every cache ever attached alive through its hook list)."""
        if self._catalog is not None:
            self._catalog.off_dataset_bump(self._on_dataset_bump)
            self._catalog = None

    @staticmethod
    def key(expr: str, calib_iters: int, epoch: int,
            canonical: Optional[str] = None) -> Tuple:
        """Cache key for a query under one dataset epoch."""
        # pass `canonical` when the caller already canonicalized (the
        # service does at admission) to avoid re-parsing the expression
        if canonical is None:
            canonical = query_lib.canonical_expr(expr)
        return (canonical, int(calib_iters), int(epoch))

    def get(self, expr: str, calib_iters: int, epoch: int, *,
            canonical: Optional[str] = None
            ) -> Optional[merge_lib.QueryResult]:
        """Probe the cache (None on miss); hits refresh LRU recency."""
        k = self.key(expr, calib_iters, epoch, canonical)
        hit = self._entries.get(k)
        if hit is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(k)
        self.stats.hits += 1
        return hit

    def put(self, expr: str, calib_iters: int, epoch: int,
            result: merge_lib.QueryResult, *,
            canonical: Optional[str] = None):
        """Install a whole-query result (canonicalizes ``expr`` unless the
        caller already did); evicts LRU entries over capacity."""
        k = self.key(expr, calib_iters, epoch, canonical)
        self._entries[k] = result
        self._entries.move_to_end(k)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def put_fragment(self, fragment_key: str, calib_iters: int, epoch: int,
                     result: merge_lib.QueryResult):
        """Install a fragment-level result under its canonical fragment key
        (already canonical — produced by ``query_lib.node_key``; no
        re-parse).  Future queries equal to the fragment hit via ``get``."""
        self.put(fragment_key, calib_iters, epoch, result,
                 canonical=fragment_key)
        self.stats.fragment_puts += 1

    def _on_dataset_bump(self, epoch: int):
        stale = [k for k in self._entries if k[2] != epoch]
        for k in stale:
            del self._entries[k]
        self.stats.invalidated += len(stale)

    def clear(self):
        """Drop every entry (counted as invalidations)."""
        self.stats.invalidated += len(self._entries)
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)
