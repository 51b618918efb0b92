"""Fleet flight recorder: a causally-ordered decision log of every
nondeterminism-relevant event in a fleet run.

The trace and metrics answer *what* a run did; this module answers
*why*.  A :class:`FlightRecorder` attached to a
:class:`~repro_torch.fabric.fleet.Fleet` (``Fleet(flight=True)``) captures one
schema-versioned record per fleet decision:

- **driver ops** — every driver call (submit / step / pump / drain /
  bump / node_leave / ...) with its arguments and resolved ids, so the
  run can be re-driven verbatim;
- **bus decisions** — every envelope send with its outcome (delivered /
  dropped / partitioned), keyed by the per-bus send ordinal, and every
  delivery, causally linked to its send;
- **gossip** — epoch advances and liveness flips, per node;
- **leases** — announce / grant / expire / release / revoke, plus the
  adoption and fallback transitions the front-end drives;
- **policy** — node state-machine transitions, re-replication, and the
  per-window decision surface;
- **scheduler** — each dispatch window's ticket composition;
- **results** — a digest of every final and every streamed snapshot,
  the bit-identity surface the replay engine
  (:mod:`repro_torch.obs.replay`) checks.

Causality model: records carry a monotonically increasing ``eid`` and a
``cause`` eid.  The fleet pushes the enclosing driver op (and, during
``pump``, the delivering envelope) on the recorder's cause stack, so a
lease grant applied while handling a gossip round points at the exact
``bus_deliver`` that carried it, which points at its ``bus_send`` —
walking ``cause`` links yields the ancestry chain of any decision
(``scripts/flight_report.py`` automates the walk).

Determinism: records never contain wall-clock times, only virtual
rounds, ordinals and content digests — two runs of the same seeded
workload produce byte-identical logs, which is what makes the log
diffable and replayable.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional

# Log format version, stamped on every record.  Bump when a record kind
# changes shape; the replay engine refuses logs from a newer schema.
FLIGHT_SCHEMA_VERSION = 1

# Every record kind the recorder emits (validate_flight rejects others).
FLIGHT_KINDS = (
    "run_header", "store_config", "op",
    "bus_send", "bus_deliver",
    "gossip_epoch", "gossip_liveness",
    "lease_announce", "lease_grant", "lease_expire", "lease_release",
    "lease_revoke", "lease_adopt", "lease_fallback",
    "policy_transition", "policy_decide", "rereplicate",
    "window", "stream_snapshot", "final",
)

_UNSET = object()  # distinguishes "cause not given" from "cause=None"


def result_digest(result) -> str:
    """Content digest of a :class:`~repro_torch.core.merge.QueryResult`:
    sha256 over its sorted JSON ``to_dict`` form.  That form is exact
    (ints plus a repr-round-tripping float), so equal digests mean
    bit-identical results — the replay engine compares these instead of
    shipping full histograms through the log."""
    payload = json.dumps(result.to_dict(), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class FlightScope:
    """A :class:`FlightRecorder` view that stamps a fixed ``origin`` on
    every record — components hold one of these in their ``flight``
    attribute so their hook sites stay one-liners."""

    def __init__(self, recorder: "FlightRecorder", origin: str):
        self.recorder = recorder
        self.origin = origin

    def record(self, kind: str, **fields) -> Dict[str, Any]:
        """Append one record with this scope's origin (see
        :meth:`FlightRecorder.record`)."""
        return self.recorder.record(kind, origin=self.origin, **fields)

    def note_send(self, seq: int, eid: int) -> None:
        """Forward to :meth:`FlightRecorder.note_send`."""
        self.recorder.note_send(seq, eid)

    def note_deliver(self, seq: int, eid: int) -> None:
        """Forward to :meth:`FlightRecorder.note_deliver`."""
        self.recorder.note_deliver(seq, eid)

    def send_cause(self, seq: int) -> Optional[int]:
        """Forward to :meth:`FlightRecorder.send_cause`."""
        return self.recorder.send_cause(seq)

    def deliver_cause(self, seq: int) -> Optional[int]:
        """Forward to :meth:`FlightRecorder.deliver_cause`."""
        return self.recorder.deliver_cause(seq)


class FlightRecorder:
    """Collects the causally-ordered flight log of one fleet run.

    The fleet installs :meth:`scoped` views on each component (bus,
    per-node gossip / leases / policy / scheduler); components append
    via ``self.flight.record(...)`` guarded by ``flight is not None``,
    so a recorder-less run pays nothing.  :attr:`records` is the log:
    plain JSON-safe dicts, appended in causal order."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._cause: List[Optional[int]] = []
        self._send_eids: Dict[int, int] = {}     # envelope seq -> send eid
        self._deliver_eids: Dict[int, int] = {}  # envelope seq -> deliver eid

    # ---------------------------- writing ----------------------------- #
    def record(self, kind: str, *, origin: str = "", cause=_UNSET,
               **fields) -> Dict[str, Any]:
        """Append one record and return it (callers may patch fields in
        place after the fact, e.g. the resolved gtid of a submit op).
        ``cause`` defaults to the top of the cause stack — the enclosing
        driver op or delivering envelope."""
        if cause is _UNSET:
            cause = self._cause[-1] if self._cause else None
        rec: Dict[str, Any] = {"schema": FLIGHT_SCHEMA_VERSION,
                               "eid": len(self.records), "kind": kind,
                               "origin": origin, "cause": cause}
        rec.update(fields)
        self.records.append(rec)
        return rec

    def push(self, eid: Optional[int]) -> None:
        """Push a cause eid; records appended until :meth:`pop` chain to
        it by default."""
        self._cause.append(eid)

    def pop(self) -> None:
        """Pop the top of the cause stack."""
        self._cause.pop()

    def scoped(self, origin: str) -> FlightScope:
        """A view of this recorder that stamps ``origin`` on every
        record (what the fleet installs on each component)."""
        return FlightScope(self, origin)

    # ----------------------- envelope causality ----------------------- #
    def note_send(self, seq: int, eid: int) -> None:
        """Remember the send record of envelope ``seq`` so its delivery
        can point back at it."""
        self._send_eids[seq] = eid

    def note_deliver(self, seq: int, eid: int) -> None:
        """Remember the delivery record of envelope ``seq`` so handler
        effects can point back at it."""
        self._deliver_eids[seq] = eid

    def send_cause(self, seq: int) -> Optional[int]:
        """The send eid of envelope ``seq`` (None if unrecorded)."""
        return self._send_eids.get(seq)

    def deliver_cause(self, seq: int) -> Optional[int]:
        """The delivery eid of envelope ``seq`` (None if unrecorded)."""
        return self._deliver_eids.get(seq)

    # ---------------------------- reading ----------------------------- #
    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """The recorded log, optionally filtered to one kind."""
        if kind is None:
            return list(self.records)
        return [r for r in self.records if r["kind"] == kind]

    def save_jsonl(self, path) -> None:
        """Write the log to ``path``, one JSON record per line (the
        ``--flight-out`` format; read back with :func:`load_flight`)."""
        save_flight(self.records, path)


def save_flight(records, path) -> None:
    """Write flight records to ``path`` as JSONL, sorted keys so equal
    logs are byte-equal files."""
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def load_flight(path) -> List[Dict[str, Any]]:
    """Read a JSONL flight log written by :func:`save_flight`."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_flight(records) -> List[str]:
    """Structural checks on a flight log; returns human-readable
    problems (empty = valid).  Checks: schema version, contiguous eids,
    known kinds, and every ``cause`` pointing at an earlier record."""
    problems = []
    for i, rec in enumerate(records):
        where = f"record {i}"
        if rec.get("schema") != FLIGHT_SCHEMA_VERSION:
            problems.append(f"{where}: schema {rec.get('schema')!r} != "
                            f"{FLIGHT_SCHEMA_VERSION}")
        if rec.get("eid") != i:
            problems.append(f"{where}: eid {rec.get('eid')!r} is not "
                            f"contiguous")
        if rec.get("kind") not in FLIGHT_KINDS:
            problems.append(f"{where}: unknown kind {rec.get('kind')!r}")
        cause = rec.get("cause")
        if cause is not None and not (isinstance(cause, int)
                                      and 0 <= cause < i):
            problems.append(f"{where}: cause {cause!r} does not point at "
                            f"an earlier record")
    return problems
