"""Fleet-wide shared cache tier: the catalog-backed L2 under every
front-end's private L1.

The per-process :class:`~repro_torch.service.cache.ResultCache` dies with its
front-end and is invisible to siblings, so a fleet re-scans queries a
peer already answered — the exact failure mode the LHC-databases-on-the-
Grid experience warns about.  The fabric adds a second tier:

- **L1** — the existing per-front-end ``ResultCache``, unchanged
  semantics, hit with zero coordination.
- **L2** — :class:`SharedCacheTier`, one logical store for the whole
  fleet (in deployment: a results table next to the paper's PostgreSQL
  metadata catalogue; here: one in-process object every front-end
  holds a handle to).  Keyed on the SAME canonical keyspace as L1 —
  ``(canonical expression, calib_iters, dataset epoch)`` — so whole-query
  results *and* fragment-level entries produced as scan by-products on
  one front-end are zero-I/O hits on all others, with no key
  translation anywhere.

:class:`TieredResultCache` is the composition the fleet installs into
each ``QueryService``: an L1 that fills misses from L2 and write-throughs
puts, so the service layer above needs no fleet awareness at all.  The
tier persists to JSON (``save``/``load``), so the fleet's L2 survives
restarts the way the fragment registry and the metadata catalogue do.

**Epoch safety.**  Scalar epochs are ambiguous in a fleet: two
*different* front-ends' first bumps both produce effective epoch 1 while
denoting different dataset states, so the shared tier keys and guards on
the full **version vector** (as a sorted fingerprint), not the scalar
sum.  L2 maintains the join (element-wise max) of every vector any
front-end has mentioned — on get, put, or the bump hook — and refuses
gets and puts whose vector differs from the join: a probe that is
missing bumps someone else knows about is stale, and two incomparable
vectors (concurrent independent bumps) refuse EACH OTHER until gossip
reconciles them, which is the safe direction.  A front-end that has not
yet heard a bump can therefore serve from L2 only until ANY member
mentions the newer vector — after that the tier is closed to stale
traffic fleet-wide.  Combined with the gossip bound
(``fabric/gossip.py``), staleness is bounded by
``rounds_bound(n, fanout)`` gossip rounds after a bump.  Standalone use
(no fleet) passes scalar epochs, which degrade to the single-origin
vector ``{"": epoch}`` with identical semantics to a plain watermark.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core import merge as merge_lib
from repro_torch.core import query as query_lib
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.service.cache import ResultCache


@dataclasses.dataclass
class SharedCacheStats:
    """Monotonic L2 counters: hits/misses, installs (whole-query and
    fragment), entries purged by epoch advance, and stale-epoch gets/puts
    refused."""
    hits: int = 0
    misses: int = 0
    puts: int = 0
    fragment_puts: int = 0
    evictions: int = 0
    invalidated: int = 0
    stale_refused: int = 0


class SharedCacheTier:
    """The fleet-shared L2: LRU over the canonical L1 keyspace with
    version-vector hygiene (see module docstring)."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.stats = SharedCacheStats()
        # observability metrics registry (repro_torch.obs.MetricsRegistry);
        # None = disabled.  Fleet-level like the bus: one tier serves
        # every front-end, so its counters live in the fleet registry.
        self.metrics = None
        self._join: Dict[str, int] = {}  # element-wise max of seen vectors
        self._entries: "OrderedDict[Tuple, merge_lib.QueryResult]" = \
            OrderedDict()

    @staticmethod
    def _fp(vv: Dict[str, int]) -> Tuple:
        """Canonical fingerprint of a version vector (zero entries are
        identity and dropped, so ``{}`` and ``{"fe0": 0}`` agree)."""
        return tuple(sorted((o, int(n)) for o, n in vv.items() if n))

    @property
    def max_epoch(self) -> int:
        """Scalar effective epoch of the join of every observed vector
        (reporting only — hygiene decisions use the full vector)."""
        return sum(self._join.values())

    def _resolve(self, epoch: int,
                 vv: Optional[Dict[str, int]]) -> Dict[str, int]:
        return dict(vv) if vv is not None else ({"": int(epoch)} if epoch
                                                else {})

    # ------------------------------------------------------------------ #
    def observe_vv(self, vv: Dict[str, int]) -> None:
        """Merge one member's version vector into the join; if the join
        advanced, purge every entry keyed under a different vector (they
        are unreachable for any converged member — purging just frees the
        memory eagerly)."""
        changed = False
        for origin, n in vv.items():
            if n > self._join.get(origin, 0):
                self._join[origin] = n
                changed = True
        if not changed:
            return
        fp = self._fp(self._join)
        stale = [k for k in self._entries if k[2] != fp]
        for k in stale:
            del self._entries[k]
        self.stats.invalidated += len(stale)

    def observe_epoch(self, epoch: int) -> None:
        """Scalar-epoch convenience for standalone (non-fleet) use: the
        epoch becomes the single-origin vector ``{"": epoch}``."""
        self.observe_vv({"": int(epoch)})

    def _current(self, vv: Dict[str, int]) -> bool:
        """Merge ``vv`` and report whether it matches the join — i.e. the
        caller knows every bump the fleet has mentioned so far."""
        self.observe_vv(vv)
        return self._fp(vv) == self._fp(self._join)

    def get(self, canonical: str, calib_iters: int, epoch: int, *,
            vv: Optional[Dict[str, int]] = None
            ) -> Optional[merge_lib.QueryResult]:
        """Probe the shared tier (``canonical`` must already be canonical
        — the L1 layer canonicalized).  A get whose epoch vector differs
        from the join of all observed vectors is refused as stale."""
        vv = self._resolve(epoch, vv)
        if not self._current(vv):
            self.stats.stale_refused += 1
            if self.metrics is not None:
                self.metrics.counter("l2.stale_refused").inc()
            return None
        k = (canonical, int(calib_iters), self._fp(vv))
        hit = self._entries.get(k)
        if hit is None:
            self.stats.misses += 1
            if self.metrics is not None:
                self.metrics.counter("l2.misses").inc()
            return None
        self._entries.move_to_end(k)
        self.stats.hits += 1
        if self.metrics is not None:
            self.metrics.counter("l2.hits").inc()
        return hit

    def put(self, canonical: str, calib_iters: int, epoch: int,
            result: merge_lib.QueryResult, *, fragment: bool = False,
            vv: Optional[Dict[str, int]] = None):
        """Install one result under the canonical keyspace.  A put whose
        epoch vector differs from the join is refused — a slow front-end
        that finished a scan after a bump (or before hearing one) must
        not install data the fleet could mistake for current."""
        vv = self._resolve(epoch, vv)
        if not self._current(vv):
            self.stats.stale_refused += 1
            if self.metrics is not None:
                self.metrics.counter("l2.stale_refused").inc()
            return
        k = (canonical, int(calib_iters), self._fp(vv))
        self._entries[k] = result
        self._entries.move_to_end(k)
        self.stats.puts += 1
        if self.metrics is not None:
            self.metrics.counter("l2.puts").inc()
        if fragment:
            self.stats.fragment_puts += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    # --------------------------- persistence -------------------------- #
    def to_json(self) -> str:
        """Serialize the tier (capacity, version-vector join, entries in
        LRU order) to JSON — restart survival for the fleet's L2, like
        the fragment registry and the metadata catalogue.  Entry keys
        round-trip exactly (canonical string, calib_iters, vv
        fingerprint) and results round-trip bit-identically
        (:meth:`~repro_torch.core.merge.QueryResult.to_dict`); stats are
        runtime counters and start fresh on load."""
        return json.dumps({
            "capacity": self.capacity,
            "join": dict(self._join),
            "entries": [
                {"canonical": k[0], "calib_iters": k[1],
                 "vv": [list(p) for p in k[2]],
                 "result": v.to_dict()}
                for k, v in self._entries.items()],
        })

    @classmethod
    def from_json(cls, text: str) -> "SharedCacheTier":
        """Rebuild a tier from :meth:`to_json` output.  Entries keyed
        under vectors older than the persisted join were already purged
        at save time; the rebuilt tier re-applies the join so any
        straggler is purged again on load."""
        data = json.loads(text)
        tier = cls(data.get("capacity", 4096))
        for e in data.get("entries", []):
            fp = tuple(tuple(p) for p in e["vv"])
            tier._entries[(e["canonical"], int(e["calib_iters"]), fp)] = \
                merge_lib.QueryResult.from_dict(e["result"])
        tier.observe_vv({o: int(n) for o, n in
                         data.get("join", {}).items()})
        return tier

    def save(self, path: Union[str, pathlib.Path]) -> None:
        """Persist the tier to ``path`` (see :meth:`to_json`)."""
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "SharedCacheTier":
        """Load a tier persisted by :meth:`save`."""
        return cls.from_json(pathlib.Path(path).read_text())


class TieredResultCache(ResultCache):
    """A front-end's L1 backed by the fleet's shared L2.

    Drop-in for :class:`~repro_torch.service.cache.ResultCache` (the
    ``QueryService`` is fleet-unaware): misses fall through to L2 and
    hits are promoted into L1; puts (whole-query and fragment) write
    through so scan by-products become fleet-visible immediately.  L2
    hits count as ordinary cache hits in ``stats`` plus ``stats.l2_hits``
    for attribution.  A catalogue dataset bump purges L1 (inherited) and
    forwards the new epoch vector to L2's hygiene join.

    ``vv_source`` supplies this front-end's current epoch version vector
    (the Fleet wires it to the gossip node) so L2 traffic is tagged with
    the unambiguous vector rather than the scalar epoch; without one
    (standalone use) the scalar-epoch degradation applies."""

    def __init__(self, capacity: int = 256,
                 catalog: Optional[MetadataCatalog] = None,
                 l2: Optional[SharedCacheTier] = None,
                 vv_source: Optional[Callable[[], Dict[str, int]]] = None):
        super().__init__(capacity, catalog)
        self.l2 = l2
        self.vv_source = vv_source

    def _vv(self) -> Optional[Dict[str, int]]:
        return dict(self.vv_source()) if self.vv_source is not None \
            else None

    def get(self, expr: str, calib_iters: int, epoch: int, *,
            canonical: Optional[str] = None
            ) -> Optional[merge_lib.QueryResult]:
        """L1 probe, then L2 on miss (promoting the hit into L1)."""
        if canonical is None:
            canonical = query_lib.canonical_expr(expr)
        hit = super().get(expr, calib_iters, epoch, canonical=canonical)
        if hit is not None or self.l2 is None:
            return hit
        remote = self.l2.get(canonical, calib_iters, epoch, vv=self._vv())
        if remote is None:
            return None
        # promote: future probes hit L1 directly; reclassify the miss
        super().put(expr, calib_iters, epoch, remote, canonical=canonical)
        self.stats.misses -= 1
        self.stats.hits += 1
        self.stats.l2_hits += 1
        return remote

    def put(self, expr: str, calib_iters: int, epoch: int,
            result: merge_lib.QueryResult, *,
            canonical: Optional[str] = None):
        """Install in L1 and write through to the shared tier."""
        if canonical is None:
            canonical = query_lib.canonical_expr(expr)
        super().put(expr, calib_iters, epoch, result, canonical=canonical)
        if self.l2 is not None:
            self.l2.put(canonical, calib_iters, epoch, result,
                        vv=self._vv())

    def put_fragment(self, fragment_key: str, calib_iters: int, epoch: int,
                     result: merge_lib.QueryResult):
        """Install a fragment-level scan by-product in both tiers (the
        shared tier is what makes it a zero-I/O hit on sibling
        front-ends)."""
        before = self.l2.stats.puts if self.l2 is not None else 0
        super().put_fragment(fragment_key, calib_iters, epoch, result)
        if self.l2 is not None and self.l2.stats.puts > before:
            # the L1 super() call wrote the entry through `put`; when the
            # tier actually accepted it (not refused as stale) reclassify
            # it as a fragment install in the L2 stats
            self.l2.stats.fragment_puts += 1

    def _on_dataset_bump(self, epoch: int):
        super()._on_dataset_bump(epoch)
        if self.l2 is not None:
            vv = self._vv()
            if vv is not None:
                self.l2.observe_vv(vv)
            else:
                self.l2.observe_epoch(epoch)
