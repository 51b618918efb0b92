"""Process-local metrics registry with fleet-mergeable snapshots.

Counters, gauges and fixed-bucket histograms for the quantities the
benchmarks used to print ad hoc: cache hits by tier, dispatch-window
sizes, per-packet scan latencies, gossip traffic, stream backpressure
conflations, bus drops.  Two design rules:

1. **Get-or-create by name.**  Instrumented layers call
   ``registry.counter("cache.hits_l1").inc()`` — no central metric
   enumeration to keep in sync; the catalog lives in
   ``docs/observability.md``.
2. **Snapshots are mergeable.**  :func:`merge2` combines two
   :class:`MetricsSnapshot` values (counters add, gauges take max,
   histograms add bucket-wise) and is associative + commutative, so a
   fleet-wide view is just the existing
   :func:`repro_torch.core.merge.tree_merge` machinery applied to per-frontend
   snapshots — the same reduction shape the grid uses for query results.

Histogram bucket edges are part of a metric's identity: merging two
histograms with different edges is an error, not a resample.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import merge as merge_lib

# default latency edges (seconds): 10us .. 30s, roughly x3 per step
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
    0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
)
# default size edges (events / queries): powers of 4
DEFAULT_SIZE_BUCKETS = (1, 4, 16, 64, 256, 1024, 4096, 16384, 65536)


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        """Add ``n`` (default 1)."""
        self.value += n


class Gauge:
    """Last-set value; fleet merge takes the max (the only associative,
    commutative, idempotent choice that needs no per-origin bookkeeping)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        """Record the latest value."""
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: ``edges`` are upper bounds (a value lands
    in the first bucket whose edge is >= it; one overflow bucket past the
    last edge), plus running ``sum`` and ``count`` for means."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        """Record one sample."""
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def to_dict(self) -> Dict[str, Any]:
        """The snapshot payload for this histogram alone."""
        return {"type": "histogram", "edges": list(self.edges),
                "counts": list(self.counts), "sum": self.sum,
                "count": self.count}


@dataclasses.dataclass
class MetricsSnapshot:
    """Immutable-by-convention dump of a registry: metric name ->
    ``{"type": ..., ...}`` payload, plus the origins that contributed
    (one for a fresh snapshot, several after fleet merges).  This is the
    unit that flows through :func:`merge2` / ``tree_merge``."""
    metrics: Dict[str, Dict[str, Any]]
    origins: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, Any]:
        """JSON-friendly dump (``serve.py --metrics-dump`` format)."""
        return {"origins": list(self.origins), "metrics": self.metrics}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MetricsSnapshot":
        """Rebuild a snapshot from :meth:`to_dict` output."""
        return MetricsSnapshot(metrics=dict(d["metrics"]),
                               origins=tuple(d.get("origins", ())))

    def value(self, name: str, default: float = 0.0) -> float:
        """Counter/gauge value by name (histograms: use ``hist``)."""
        m = self.metrics.get(name)
        return default if m is None else float(m.get("value", default))

    def hist(self, name: str) -> Optional[Dict[str, Any]]:
        """Histogram payload by name (``edges``/``counts``/``sum``/
        ``count``) or None."""
        m = self.metrics.get(name)
        return m if m is not None and m["type"] == "histogram" else None

    def to_prom_text(self) -> str:
        """The snapshot in Prometheus text exposition format (what
        ``serve.py --metrics-dump out.prom`` writes): dotted metric
        names sanitized to underscores, counters/gauges as a single
        sample, histograms as cumulative ``_bucket{le=...}`` series plus
        ``_sum`` and ``_count`` — scrape-ready for a pushgateway or a
        textfile collector."""
        def sane(name: str) -> str:
            return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

        lines: List[str] = []
        for name in sorted(self.metrics):
            m, pname = self.metrics[name], sane(name)
            if m["type"] in ("counter", "gauge"):
                lines.append(f"# TYPE {pname} {m['type']}")
                lines.append(f"{pname} {m['value']}")
                continue
            lines.append(f"# TYPE {pname} histogram")
            acc = 0
            for edge, count in zip(m["edges"], m["counts"]):
                acc += count
                lines.append(f'{pname}_bucket{{le="{edge}"}} {acc}')
            acc += m["counts"][-1]
            lines.append(f'{pname}_bucket{{le="+Inf"}} {acc}')
            lines.append(f"{pname}_sum {m['sum']}")
            lines.append(f"{pname}_count {m['count']}")
        return "\n".join(lines) + "\n"


def merge2(a: MetricsSnapshot, b: MetricsSnapshot) -> MetricsSnapshot:
    """Combine two snapshots: counters add, gauges max, histograms add
    bucket-wise (edges must match — a mismatch is a config error, not a
    resample).  Associative and commutative, so snapshots reduce through
    :func:`repro_torch.core.merge.tree_merge` like query results do."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(set(a.metrics) | set(b.metrics)):
        ma, mb = a.metrics.get(name), b.metrics.get(name)
        if ma is None or mb is None:
            src = ma if mb is None else mb
            out[name] = {k: (list(v) if isinstance(v, list) else v)
                         for k, v in src.items()}
            continue
        if ma["type"] != mb["type"]:
            raise ValueError(
                f"metric {name!r}: type mismatch "
                f"{ma['type']!r} vs {mb['type']!r}")
        if ma["type"] == "counter":
            out[name] = {"type": "counter",
                         "value": ma["value"] + mb["value"]}
        elif ma["type"] == "gauge":
            out[name] = {"type": "gauge",
                         "value": max(ma["value"], mb["value"])}
        else:
            if list(ma["edges"]) != list(mb["edges"]):
                raise ValueError(f"metric {name!r}: bucket edges differ")
            out[name] = {
                "type": "histogram",
                "edges": list(ma["edges"]),
                "counts": [x + y for x, y in zip(ma["counts"],
                                                 mb["counts"])],
                "sum": ma["sum"] + mb["sum"],
                "count": ma["count"] + mb["count"],
            }
    return MetricsSnapshot(metrics=out,
                           origins=tuple(sorted(set(a.origins)
                                                | set(b.origins))))


def merge_snapshots(snaps: Sequence[MetricsSnapshot]) -> MetricsSnapshot:
    """Fleet reduction of per-frontend snapshots via the grid's
    ``tree_merge`` (pairwise balanced tree, same machinery as query
    results)."""
    if not snaps:
        return MetricsSnapshot(metrics={})
    return merge_lib.tree_merge(snaps, merge_fn=merge2)


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms.

    One per process (front-end); the fleet view is
    :func:`merge_snapshots` over every registry's :meth:`snapshot`.
    Re-requesting a histogram with different edges is an error — edges
    are part of the metric's identity."""

    def __init__(self, origin: str = ""):
        self.origin = origin
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(*args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}")
        return m

    def counter(self, name: str) -> Counter:
        """Get-or-create the named counter."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the named gauge."""
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create a histogram.  ``edges`` applies (and is checked)
        only when passed explicitly; omitting it fetches whatever edges
        the metric was first registered with (latency default on
        create) — so hot call sites need not re-state bucket config."""
        h = self._get(name, Histogram,
                      DEFAULT_LATENCY_BUCKETS if edges is None else edges)
        if edges is not None and h.edges != tuple(float(e) for e in edges):
            raise ValueError(f"histogram {name!r} edges differ from "
                             "first registration")
        return h

    def value(self, name: str, default: float = 0.0) -> float:
        """Current counter/gauge value (0 default if never touched)."""
        m = self._metrics.get(name)
        return default if m is None else float(m.value)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> MetricsSnapshot:
        """Serialize the registry for export / fleet merging."""
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value}
            else:
                out[name] = {"type": "histogram",
                             "edges": list(m.edges),
                             "counts": list(m.counts),
                             "sum": m.sum, "count": m.count}
        origins = (self.origin,) if self.origin else ()
        return MetricsSnapshot(metrics=out, origins=origins)
