"""Fleet-wide observability plane: ticket tracing, metrics, node health.

Zero-dependency (stdlib + numpy-free) instrumentation threaded through
every layer of the stack behind one convention: each instrumented object
carries an ``obs`` attribute that defaults to ``None``, and every
instrumentation site is guarded by ``if obs is not None`` — the disabled
path costs one attribute test and allocates nothing.  Enabling is one
constructor argument: pass an :class:`Observability` bundle to
``QueryService`` (which installs it on its backend/engine) or let
``Fleet(obs=True)`` build one per front-end.

See ``docs/observability.md`` for the span taxonomy, metric catalog,
health-state semantics, trace-file format, and the flight-recorder /
replay contract (:mod:`repro_torch.obs.flight`, :mod:`repro_torch.obs.replay`).
"""
from __future__ import annotations

from repro_torch.obs.flight import (FLIGHT_KINDS, FLIGHT_SCHEMA_VERSION,
                                    FlightRecorder, FlightScope, load_flight,
                                    result_digest, save_flight,
                                    validate_flight)
from repro_torch.obs.health import (HEALTH_DEGRADED, HEALTH_OK,
                                    HEALTH_STATES, HEALTH_SUSPECT,
                                    HealthMonitor, HealthReport, NodeHealth)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS,
                                     DEFAULT_SIZE_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     MetricsSnapshot, merge2,
                                     merge_snapshots)
from repro_torch.obs.trace import (SCHEMA_VERSION, SPAN_NAMES, STATUS_ERROR,
                                   STATUS_OK, STATUS_OPEN, Span, Tracer,
                                   chrome_from_records, comparable_records,
                                   load_jsonl, save_chrome, save_jsonl,
                                   validate_file, validate_records)


# the replay engine drives a Fleet, whose module imports this package:
# resolve its names lazily (PEP 562) so `import repro_torch.obs` never pulls
# the fabric stack mid-initialization
_REPLAY_NAMES = ("ReplayBus", "ReplayError", "ReplayReport", "replay_run")


def __getattr__(name: str):
    """Lazy re-export of :mod:`repro_torch.obs.replay` (breaks the
    obs -> replay -> fabric -> fleet -> obs import cycle)."""
    if name in _REPLAY_NAMES:
        from repro_torch.obs import replay as _replay
        return getattr(_replay, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Observability:
    """The per-process observability bundle: one :class:`Tracer`, one
    :class:`MetricsRegistry` and one :class:`HealthMonitor` sharing an
    ``origin`` label (the front-end id in a fleet).  This is the single
    handle instrumented layers accept — ``obs=None`` disables the whole
    plane."""

    def __init__(self, origin: str = "fe0"):
        self.origin = origin
        self.tracer = Tracer(process=origin)
        self.metrics = MetricsRegistry(origin=origin)
        self.health = HealthMonitor(origin=origin)
        # pre-register the size-valued histograms so hot call sites can
        # fetch them by name without re-stating bucket config
        for name in ("packet.events", "window.queries"):
            self.metrics.histogram(name, DEFAULT_SIZE_BUCKETS)


__all__ = [
    "Observability",
    # trace
    "Span", "Tracer", "SCHEMA_VERSION", "SPAN_NAMES",
    "STATUS_OPEN", "STATUS_OK", "STATUS_ERROR",
    "save_jsonl", "load_jsonl", "validate_records", "validate_file",
    "comparable_records", "chrome_from_records", "save_chrome",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsSnapshot",
    "merge2", "merge_snapshots",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_SIZE_BUCKETS",
    # health
    "HealthMonitor", "HealthReport", "NodeHealth",
    "HEALTH_STATES", "HEALTH_OK", "HEALTH_DEGRADED", "HEALTH_SUSPECT",
    # flight recorder / replay
    "FlightRecorder", "FlightScope", "FLIGHT_SCHEMA_VERSION",
    "FLIGHT_KINDS", "result_digest",
    "save_flight", "load_flight", "validate_flight",
    "ReplayBus", "ReplayError", "ReplayReport", "replay_run",
]
