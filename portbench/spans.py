"""The program's step spans of a traced window, for the per-layer
readers: the records of the port's step tracer (``obs/trace.py`` in
``repro_torch``), which the program fills while ``torch.profiler``
records, drained once a run (after the window's last unit has
synchronized, so each span's ``device_ms`` is resolved) and kept on the
run.  A program without a step tracer gives none, and the readers that
need spans read nothing.

Wall stamps are seconds since the Unix epoch, the clock of the device
trace's events (``trace.Trace``), so a reader lays spans beside the
device intervals and the host's runtime calls.  The first drain writes a
summary to standard error: each root's count and mean device ms, and the
share of it its direct children cover.
"""
from __future__ import annotations

import collections
import heapq
import sys


def of(run) -> list:
    """The step spans' records of ``run``'s traced window ([] where there
    are none)."""
    if run.trace is None:
        return []
    if not hasattr(run, "_step_spans"):
        from repro_torch.obs import trace
        drain = getattr(trace, "drain_steps", None)
        run._step_spans = [] if drain is None else drain()
        _summary(run._step_spans)
    return run._step_spans


def named(records, name: str) -> list:
    return [r for r in records if r["name"] == name]


def device_ms(record) -> float:
    return record["attrs"]["device_ms"]


def host_ms(record) -> float:
    return (record["t1_wall"] - record["t0_wall"]) * 1e3


def roots_of(records) -> dict:
    """span id -> the name of the root span it belongs to."""
    by_id = {r["span_id"]: r for r in records}
    out = {}
    for r in records:
        top = r
        while top["parent_id"] is not None:
            top = by_id[top["parent_id"]]
        out[r["span_id"]] = top["name"]
    return out


def per_root(records, name: str, root: str, ms=device_ms):
    """The ``ms`` of the spans named ``name`` inside roots named ``root``,
    summed, over the number of those roots; None where either is
    absent."""
    roots = named(records, root)
    root_of = roots_of(records)
    inside = [r for r in named(records, name)
              if root_of[r["span_id"]] == root]
    if not roots or not inside:
        return None
    return sum(ms(r) for r in inside) / len(roots)


def innermost(records, times) -> list:
    """The record of the innermost span open at each of ``times`` (the
    latest started of those that contain it), or None."""
    spans = sorted(records, key=lambda r: r["t0_wall"])
    order = sorted(range(len(times)), key=lambda j: times[j])
    out = [None] * len(times)
    heap, i = [], 0
    for j in order:
        when = times[j]
        while i < len(spans) and spans[i]["t0_wall"] <= when:
            heapq.heappush(heap, (-spans[i]["t0_wall"], i))
            i += 1
        while heap and spans[heap[0][1]]["t1_wall"] < when:
            heapq.heappop(heap)
        if heap:
            out[j] = spans[heap[0][1]]
    return out


def log(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def _summary(records) -> None:
    children = collections.defaultdict(float)
    for r in records:
        if r["parent_id"] is not None:
            children[r["parent_id"]] += device_ms(r)
    for name in sorted({r["name"] for r in records
                        if r["parent_id"] is None}):
        roots = named(records, name)
        total = sum(device_ms(r) for r in roots)
        covered = sum(children[r["span_id"]] for r in roots)
        log(f"spans: {len(roots)} {name}, {total / len(roots):.3f} device "
            f"ms each, {100 * covered / max(total, 1e-12):.2f} % of it in "
            f"their children")
