"""Per-ticket span tracing for the query service and fleet.

The paper's Job Submit Server "distributes the tasks through all the nodes
and retrieves the result"; when a ticket is slow the operator needs to see
*where* the time went — admission, planning, dispatch, a straggling packet,
or stream backpressure.  This module is the zero-dependency span layer the
whole stack reports into:

* A :class:`Span` covers one phase of one ticket or window (``submit``,
  ``plan``, ``dispatch``, ``packet``, ``stream`` ...) with a parent link,
  *both* clocks (deterministic virtual time from the grid simulation, and
  wall time for real profiling), a terminal ``status`` and free-form
  ``attrs``.
* A :class:`Tracer` is the per-process collector.  Callers pass virtual
  timestamps explicitly (every layer has its own notion of virtual time);
  wall stamps are taken automatically (:func:`wall_s`).  A
  parent *stack* (:meth:`Tracer.push`/:meth:`Tracer.pop`) lets an outer
  layer (the front-end's dispatch span) become the implicit parent of
  spans opened deeper in the stack (the engine's per-packet scans) without
  threading span ids through every call signature.
* Export is JSONL (one record per span, schema-checked by
  :func:`validate_records`) and Chrome-trace JSON
  (:func:`chrome_from_records`) loadable in ``chrome://tracing`` /
  Perfetto — spans are laid out on the virtual-time axis, which is the
  deterministic one.

Determinism contract: with a fixed seed and the simulated backend, every
field except the ``*_wall`` stamps is identical run to run
(:func:`comparable_records` strips the wall fields for such comparisons).

Wall stamps are seconds since the Unix epoch (:func:`wall_s`), the clock
``torch.profiler`` stamps its events with, so spans lie on the axis of a
profiler's trace of the same process.

The LM paths (``train/steps.py``, ``optim/adamw.py``, ``data/pipeline.py``,
``models/transformer.py``) report into one process-wide *step tracer*,
and only while a ``torch.profiler`` records: each root span
(:func:`step_root`: a train step, a prompt, a batch) asks the profiler's
state once at its entry; with it off no tracer is made and every site
inside costs one ``is None`` test.  With it on, each span of the step
also records a pair of CUDA timing events on the current stream (on a
CUDA device), pooled; the next root reads those the device has passed
(``Event.query``), and :meth:`Tracer.drain`, called after the caller's
own synchronize, the rest: the tracer never synchronizes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# span taxonomy used by the instrumented layers: the query service and
# fleet's (docs/observability.md), then the LM steps' (the step tracer)
SPAN_NAMES = (
    "submit", "window", "plan", "dispatch",
    "packet", "merge_prefix", "stream_partial", "stream", "final",
    "node_death", "policy_transition", "speculate", "rereplicate",
    "lease_adopt", "lease_fallback",
    "train.step", "train.microbatch", "train.recompute", "train.grad_sum",
    "train.optimizer", "optim.norm", "optim.update",
    "data.fetch", "data.read", "data.copy",
    "prefill.step", "model.unembed",
)

STATUS_OPEN, STATUS_OK, STATUS_ERROR = "open", "ok", "error"

# required JSONL record fields -> allowed types (None encoded as null)
_SCHEMA: Dict[str, Tuple[type, ...]] = {
    "schema": (int,),
    "span_id": (int,),
    "parent_id": (int, type(None)),
    "name": (str,),
    "kind": (str,),
    "process": (str,),
    "ticket": (int, str, type(None)),  # str = lease key (fabric spans)
    "t0_virtual": (float, int),
    "t1_virtual": (float, int, type(None)),
    "t0_wall": (float, int),
    "t1_wall": (float, int, type(None)),
    "status": (str,),
    "attrs": (dict,),
}

# fields that carry wall-clock (nondeterministic) data
WALL_FIELDS = ("t0_wall", "t1_wall")


def wall_s() -> float:
    """The wall clock of every span: seconds since the Unix epoch, from
    ``time.time_ns``, the clock ``torch.profiler`` stamps its events with
    (``start_ns()``), and converted as a reader of those converts them."""
    return time.time_ns() * 1e-9


@dataclasses.dataclass
class Span:
    """One traced phase: a node in the per-ticket span tree.

    ``kind`` is ``"span"`` for phases with duration and ``"event"`` for
    instantaneous marks (``t1_* == t0_*``).  ``status`` starts ``open``
    and must end ``ok`` or ``error`` — an ``open`` span in an exported
    trace is a leak (the bug class the stream-abort sweep closes)."""
    span_id: int
    name: str
    process: str
    t0_virtual: float
    t0_wall: float
    parent_id: Optional[int] = None
    #: ticket id, or a lease key (str) for fabric-side adoption spans
    ticket: Optional[Any] = None
    kind: str = "span"
    t1_virtual: Optional[float] = None
    t1_wall: Optional[float] = None
    status: str = STATUS_OPEN
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: a step span's CUDA timing events (start, end), until they are read
    events: Optional[list] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    def to_record(self) -> Dict[str, Any]:
        """The span as a schema-versioned JSONL record (plain dict)."""
        return {
            "schema": SCHEMA_VERSION,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "process": self.process,
            "ticket": self.ticket,
            "t0_virtual": self.t0_virtual,
            "t1_virtual": self.t1_virtual,
            "t0_wall": self.t0_wall,
            "t1_wall": self.t1_wall,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Per-process span collector (one per front-end / engine owner).

    Span ids are a plain counter, so a fixed workload produces the same
    ids every run.  The tracer never samples and never drops; the
    disabled path is simply *no tracer* (``obs is None`` at every call
    site), which keeps tracing cost out of hot loops entirely.
    """

    def __init__(self, process: str = "svc"):
        self.process = process
        self.spans: List[Span] = []
        #: offset layers with a window-relative virtual clock add to their
        #: stamps (the front-end sets this to its cumulative virtual "now"
        #: around each dispatch, so per-packet times from the engine land
        #: on the service's single virtual timeline)
        self.virtual_base = 0.0
        self._next_id = 0
        self._stack: List[Span] = []
        #: step spans: roots opened so far by name (their tickets), whether
        #: the open root's spans take CUDA timing events, the closed spans
        #: whose events are not read yet, and the free events
        self._roots: Dict[str, int] = {}
        self._timed = False
        self._pending: List[Span] = []
        self._pool: list = []

    # ------------------------------------------------------------------ #
    def begin(self, name: str, *, t_virtual: float = 0.0,
              ticket: Optional[Any] = None,
              parent: Optional[Span] = None, **attrs) -> Span:
        """Open a span.  ``parent`` defaults to the top of the parent
        stack (see :meth:`push`); pass it explicitly to override."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        span = Span(span_id=self._next_id, name=name, process=self.process,
                    t0_virtual=float(t_virtual), t0_wall=wall_s(),
                    parent_id=None if parent is None else parent.span_id,
                    ticket=ticket, attrs=dict(attrs))
        self._next_id += 1
        self.spans.append(span)
        return span

    def end(self, span: Span, *, t_virtual: Optional[float] = None,
            status: str = STATUS_OK, note: Optional[str] = None):
        """Close a span with a terminal status (idempotent: a span
        already closed keeps its first verdict — the error path wins
        races with a later bulk cleanup)."""
        if span.status != STATUS_OPEN:
            return
        span.t1_virtual = (span.t0_virtual if t_virtual is None
                           else float(t_virtual))
        span.t1_wall = wall_s()
        span.status = status
        if note is not None:
            span.attrs["note"] = note

    def event(self, name: str, *, t_virtual: float = 0.0,
              ticket: Optional[Any] = None,
              parent: Optional[Span] = None, **attrs) -> Span:
        """Record an instantaneous mark (a zero-duration closed span)."""
        span = self.begin(name, t_virtual=t_virtual, ticket=ticket,
                          parent=parent, **attrs)
        span.kind = "event"
        self.end(span, t_virtual=t_virtual)
        return span

    # ------------------------------------------------------------------ #
    def push(self, span: Span):
        """Make ``span`` the implicit parent of spans opened until the
        matching :meth:`pop` — how the front-end's dispatch span becomes
        the parent of engine-side packet spans."""
        self._stack.append(span)

    def pop(self) -> Optional[Span]:
        """Undo the matching :meth:`push`."""
        return self._stack.pop() if self._stack else None

    def open_spans(self) -> List[Span]:
        """Spans never closed — must be empty after a clean drain."""
        return [s for s in self.spans if s.status == STATUS_OPEN]

    # ------------------------------ step spans ------------------------ #
    def _event(self):
        import torch
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open_step(self, name: str, *, root_of=None, **attrs) -> Span:
        """Open a step span, a child of the innermost open one, and push
        it; ``root_of`` (a ``torch.device``) opens a root instead, whose
        ticket is its index among the roots of its name, and whose spans
        take CUDA timing events where the device is CUDA (first reading
        those of the closed spans the device has passed)."""
        if root_of is not None and not self._stack:
            self._resolve()
            ticket = self._roots.get(name, 0)
            self._roots[name] = ticket + 1
            self._timed = root_of.type == "cuda"
        else:
            ticket = self._stack[-1].ticket
        span = self.begin(name, ticket=ticket, **attrs)
        if self._timed:
            span.events = [self._event(), None]
        self._stack.append(span)
        return span

    def close_step(self, span: Span, status: str = STATUS_OK):
        """Close the innermost open step span, ``span``."""
        if span.events is not None:
            span.events[1] = self._event()
            self._pending.append(span)
        self._stack.pop()
        self.end(span, status=status)

    def _resolve(self, wait: bool = False):
        """Read the device ms of each closed span whose end event the
        device has passed (``query``, which does not wait; with ``wait``
        every one, which must have been passed: after the caller's
        synchronize) into its ``attrs``, and pool its events."""
        keep = []
        for span in self._pending:
            start, end = span.events
            if wait or end.query():
                span.attrs["device_ms"] = start.elapsed_time(end)
                self._pool += span.events
                span.events = None
            else:
                keep.append(span)
        self._pending = keep

    def device_ms(self, span: Span) -> float:
        """Milliseconds on the device between the span's two timing
        events (once read: see ``_resolve``), else, with no events (a CPU
        step), its host duration."""
        if "device_ms" in span.attrs:
            return span.attrs["device_ms"]
        if span.events is not None:
            return span.events[0].elapsed_time(span.events[1])
        return (span.t1_wall - span.t0_wall) * 1e3

    def last(self, name: str) -> Optional[Span]:
        """The latest span named ``name``, or None."""
        return next((s for s in reversed(self.spans) if s.name == name),
                    None)

    def drain(self) -> List[Dict[str, Any]]:
        """Every span's record, each with its ``device_ms`` in ``attrs``,
        and forget them.  Call it with no step open, after the device has
        run the steps (a synchronize)."""
        if self._stack:
            raise RuntimeError(f"drain inside an open {self._stack[-1].name}")
        self._resolve(wait=True)
        out = []
        for span in self.spans:
            span.attrs["device_ms"] = self.device_ms(span)
            out.append(span.to_record())
        self.spans = []
        return out

    # ------------------------------- export --------------------------- #
    def records(self) -> List[Dict[str, Any]]:
        """Every span as a schema-versioned record, in open order."""
        return [s.to_record() for s in self.spans]

    def save_jsonl(self, path):
        """Write this tracer's records as JSONL."""
        save_jsonl(self.records(), path)

    def chrome_trace(self) -> Dict[str, Any]:
        """This tracer's records as Chrome-trace JSON (dict)."""
        return chrome_from_records(self.records())

    def save_chrome(self, path):
        """Write this tracer's records as a Chrome-trace file."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# ------------------------------ the step tracer --------------------------- #
#: the process-wide tracer of the LM steps, made by the first root span
#: opened while torch.profiler records (``step_root``)
_STEP: Optional[Tracer] = None
_OFF = contextlib.nullcontext()


def step_tracer() -> Optional[Tracer]:
    """The step tracer while a root span it traces is open, else None."""
    return _STEP if _STEP is not None and _STEP._stack else None


@contextlib.contextmanager
def _step_span(tracer: Tracer, name: str, root_of=None, **attrs):
    span = tracer.open_step(name, root_of=root_of, **attrs)
    status = STATUS_ERROR
    try:
        yield span
        status = STATUS_OK
    finally:
        tracer.close_step(span, status)


def step_root(name: str, device, **attrs):
    """A context manager around one step, prompt or batch on ``device``:
    while ``torch.profiler`` records, a root span of the step tracer
    (yielded; a child where a root is open already), else nothing
    (yields None)."""
    global _STEP
    if _STEP is not None and _STEP._stack:
        return _step_span(_STEP, name, **attrs)
    import torch
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    if _STEP is None:
        _STEP = Tracer(process="step")
    return _step_span(_STEP, name, root_of=torch.device(device), **attrs)


def step_span(name: str, **attrs):
    """A context manager: a span of the step being traced (yielded), or
    nothing where none is (yields None)."""
    tracer = step_tracer()
    return _OFF if tracer is None else _step_span(tracer, name, **attrs)


def recomputed(fn, **attrs):
    """``fn`` for ``torch.utils.checkpoint``: as it is where no step is
    traced; else its first call (the forward) as it is, and each later
    one (the checkpoint's recompute in the backward, on whichever thread
    runs it) inside a ``train.recompute`` span, also when the checkpoint
    stops it early."""
    tracer = step_tracer()
    if tracer is None:
        return fn
    calls = 0

    def run(*args):
        nonlocal calls
        calls += 1
        if calls == 1 or not tracer._stack:
            return fn(*args)
        span = tracer.open_step("train.recompute", **attrs)
        try:
            return fn(*args)
        finally:
            tracer.close_step(span)

    return run


def drain_steps() -> List[Dict[str, Any]]:
    """The step tracer's records so far (:meth:`Tracer.drain`), [] where
    no step was traced."""
    return [] if _STEP is None else _STEP.drain()


# ---------------------------- record helpers ----------------------------- #
def save_jsonl(records: Iterable[Dict[str, Any]], path):
    """Write span records as JSONL (one JSON object per line)."""
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def save_chrome(records: Sequence[Dict[str, Any]], path):
    """Write records as a Chrome-trace JSON file (see
    :func:`chrome_from_records`)."""
    with open(path, "w") as f:
        json.dump(chrome_from_records(records), f)


def load_jsonl(path) -> List[Dict[str, Any]]:
    """Read a JSONL trace file back into records."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_records(records: Sequence[Dict[str, Any]]) -> List[str]:
    """Schema-check span records; returns a list of problems (empty ==
    valid).  Checks field presence/types, status values, parent links
    resolving within the same process, and flags leaked ``open`` spans."""
    problems: List[str] = []
    by_proc: Dict[str, set] = {}
    for i, rec in enumerate(records):
        for field, types in _SCHEMA.items():
            if field not in rec:
                problems.append(f"record {i}: missing field {field!r}")
            elif not isinstance(rec[field], types):
                problems.append(
                    f"record {i}: field {field!r} has type "
                    f"{type(rec[field]).__name__}")
        if rec.get("schema") != SCHEMA_VERSION:
            problems.append(f"record {i}: schema != {SCHEMA_VERSION}")
        if rec.get("status") not in (STATUS_OPEN, STATUS_OK, STATUS_ERROR):
            problems.append(f"record {i}: bad status {rec.get('status')!r}")
        if rec.get("status") == STATUS_OPEN:
            problems.append(
                f"record {i}: leaked open span {rec.get('name')!r}")
        by_proc.setdefault(rec.get("process", ""), set()).add(
            rec.get("span_id"))
    for i, rec in enumerate(records):
        pid = rec.get("parent_id")
        if pid is not None and pid not in by_proc.get(
                rec.get("process", ""), ()):
            problems.append(f"record {i}: dangling parent_id {pid}")
    return problems


def validate_file(path) -> List[str]:
    """Schema-check a JSONL trace file (see :func:`validate_records`)."""
    return validate_records(load_jsonl(path))


def comparable_records(records: Sequence[Dict[str, Any]], *,
                       exclude_attrs: Sequence[str] = (),
                       virtual: bool = True) -> List[Dict[str, Any]]:
    """Strip nondeterministic fields for run-to-run / cross-backend
    comparison: wall stamps always; virtual stamps too when
    ``virtual=False`` (the spmd backend's "virtual" time is wall-derived);
    plus any backend-tagged ``attrs`` keys in ``exclude_attrs``."""
    out = []
    for rec in records:
        r = {k: v for k, v in rec.items() if k not in WALL_FIELDS}
        if not virtual:
            r.pop("t0_virtual", None)
            r.pop("t1_virtual", None)
        r["attrs"] = {k: v for k, v in rec.get("attrs", {}).items()
                      if k not in exclude_attrs}
        out.append(r)
    return out


def chrome_from_records(records: Sequence[Dict[str, Any]]
                        ) -> Dict[str, Any]:
    """Records -> Chrome-trace JSON (the ``traceEvents`` format Perfetto
    and ``chrome://tracing`` load).  Spans map to complete ("X") events
    and instantaneous marks to "i" events, on the *virtual* time axis
    (microseconds); ``pid`` is the emitting process and ``tid`` groups by
    grid node when known, else by ticket."""
    events: List[Dict[str, Any]] = []
    for rec in records:
        t0 = float(rec["t0_virtual"]) * 1e6
        tid = rec["attrs"].get("node")
        if tid is None:
            t = rec["ticket"]
            # string tickets (lease keys) share one lane; args keep the key
            tid = t if isinstance(t, int) else (0 if t is None else -1)
        args = dict(rec["attrs"])
        args["status"] = rec["status"]
        if rec["ticket"] is not None:
            args["ticket"] = rec["ticket"]
        base = {"name": rec["name"], "pid": rec["process"],
                "tid": int(tid), "ts": t0, "cat": rec["name"],
                "args": args}
        if rec["kind"] == "event":
            events.append({**base, "ph": "i", "s": "t"})
        else:
            t1 = rec["t1_virtual"]
            dur = 0.0 if t1 is None else max(0.0, float(t1) * 1e6 - t0)
            events.append({**base, "ph": "X", "dur": dur})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA_VERSION}}
