"""Deterministic replay of a recorded fleet flight log.

The flight log (:mod:`repro_torch.obs.flight`) contains everything that made a
run what it was: the fleet's construction parameters (``run_header``),
every driver call in order (``op`` records), and — crucially — the
outcome of every bus send (``bus_send`` records).  The bus is the ONLY
stochastic component of a fleet run (its seeded loss draw), and
partitions/per-link loss funnel through the same decision point, so
substituting the recorded outcomes while re-issuing the recorded driver
calls re-drives the run exactly:

- :class:`ReplayBus` — a :class:`~repro_torch.fabric.bus.MessageBus` whose
  ``_send_outcome`` consults the recorded script (keyed by send ordinal)
  instead of the RNG/partition state, flagging divergences when the
  replayed traffic stops matching the recorded shape;
- :func:`replay_run` — builds a fresh fleet from the header, applies the
  ops, and compares the replay's own flight log against the original on
  the bit-identity surface: ``final`` digests (status / adopted /
  cached / result digest per global ticket) and the full
  ``stream_snapshot`` prefix of every streamed ticket;
- :func:`main` — the CLI (``python -m repro_torch.obs.replay flight.jsonl
  [--device cpu]``): exit 0 iff the replay is bit-identical.

Replay needs a brick store equal to the original run's.  Logs recorded
through ``serve.py --flight-out`` carry a ``store_config`` record and
are self-contained; programmatic logs take ``store=`` (build a FRESH
store with the same parameters — the original object may have been
mutated by re-replication or elastic migration during the run).

The device is the caller's choice (``device=``, default ``"cuda"``),
never the log's: a log recorded by either package, on any device,
replays on the one asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.fabric.bus import MessageBus
from repro_torch.obs import flight as flight_lib


class ReplayError(RuntimeError):
    """The log cannot be replayed (wrong schema, missing header, or a
    construction parameter replay cannot reproduce, e.g. a custom
    scheduler factory)."""


class ReplayBus(MessageBus):
    """A message bus that substitutes recorded send outcomes.

    ``script`` maps the send ordinal (``BusStats.sent`` AFTER the
    increment — the n-th ``send()`` call overall) to its recorded
    ``bus_send`` record.  Sends beyond the script fall back to the live
    decision (counted in :attr:`overruns`); a scripted send whose
    (src, dst, topic) no longer matches the recording lands in
    :attr:`divergences` — both mean the replay has drifted and
    bit-identity is already lost."""

    def __init__(self, script: Dict[int, dict], *, delay: int = 0,
                 drop_rate: float = 0.0, seed: int = 0):
        super().__init__(delay=delay, drop_rate=drop_rate, seed=seed)
        self._script = dict(script)
        self.divergences: List[str] = []
        self.overruns = 0

    def _send_outcome(self, src: str, dst: str, topic: str) -> str:
        rec = self._script.get(self.stats.sent)
        if rec is None:
            self.overruns += 1
            return super()._send_outcome(src, dst, topic)
        if (rec["src"], rec["dst"], rec["topic"]) != (src, dst, topic):
            self.divergences.append(
                f"send #{self.stats.sent}: recorded "
                f"{rec['src']}->{rec['dst']}/{rec['topic']}, replayed "
                f"{src}->{dst}/{topic}")
            return super()._send_outcome(src, dst, topic)
        return rec["outcome"]


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one :func:`replay_run`: :attr:`identical` is the
    bit-identity verdict; on failure :attr:`mismatches` lists the
    differing finals/snapshots and :attr:`bus_divergences` /
    :attr:`overruns` say where the traffic shape drifted.
    :attr:`records` is the REPLAY's own flight log (for triage with
    ``scripts/flight_report.py``) and :attr:`trace` its trace records
    when the run had ``obs=True`` (for ``comparable_records`` checks)."""
    identical: bool
    mismatches: List[str]
    bus_divergences: List[str]
    overruns: int
    n_finals: int
    n_snapshots: int
    fleet_stats: Dict[str, Any]
    records: List[dict] = dataclasses.field(default_factory=list)
    trace: List[dict] = dataclasses.field(default_factory=list)


def _projected(records):
    """The bit-identity surface of a flight log: final tuples (in gtid
    order) and the per-ticket stream-snapshot prefixes (in publish
    order)."""
    finals = [(r["gtid"], r["status"], r.get("digest"),
               bool(r.get("adopted")), bool(r.get("cached")))
              for r in records if r["kind"] == "final"]
    snaps = [(r["gtid"], r["seq"], bool(r["final"]), r["digest"])
             for r in records if r["kind"] == "stream_snapshot"]
    return sorted(finals), snaps


def _build_store(records, device):
    sc = next((r for r in records if r["kind"] == "store_config"), None)
    if sc is None:
        raise ReplayError(
            "log has no store_config record (programmatic recording): "
            "pass store= with a freshly built store equal to the "
            "original run's")
    if sc.get("schema_name") != "geps_reduced":
        raise ReplayError(
            f"unknown store schema {sc.get('schema_name')!r}")
    from repro_torch.configs.geps_events import reduced as geps_reduced
    from repro_torch.core import events as ev
    from repro_torch.core.brick import create_store
    schema = ev.EventSchema.from_config(geps_reduced())
    return create_store(schema, n_events=sc["n_events"],
                        n_nodes=sc["n_nodes"],
                        events_per_brick=sc["events_per_brick"],
                        replication=sc["replication"], seed=sc["seed"],
                        device=device)


def replay_run(records: List[dict], *, store=None,
               device: Union[str, torch.device] = "cuda") -> ReplayReport:
    """Re-drive a fleet from a recorded flight log and compare.

    Builds a fresh fleet from the log's ``run_header`` (over ``store``,
    or a store built from the log's ``store_config``), wires a
    :class:`ReplayBus` scripted with the recorded send outcomes, applies
    every recorded driver op in order, and returns a
    :class:`ReplayReport` whose ``identical`` asserts bit-equality of
    finals and stream prefixes with the original run.  The fleet runs on
    ``device``, where ``store`` must live."""
    problems = flight_lib.validate_flight(records)
    if problems:
        raise ReplayError(f"invalid flight log: {problems[:3]}")
    header = next((r for r in records if r["kind"] == "run_header"), None)
    if header is None:
        raise ReplayError("log has no run_header record")
    for flag in ("scheduler_factory", "policy_config", "l2_path"):
        if header.get(flag):
            raise ReplayError(
                f"run used {flag}, which the log cannot serialize — "
                f"replay programmatically instead")
    if store is None:
        store = _build_store(records, device)

    # lazy import: repro_torch.obs is imported by the fabric package, so a
    # top-level fleet import here would be circular
    from repro_torch.fabric.fleet import Fleet
    from repro_torch.fabric.registry import FragmentRegistry

    script = {r["n"]: r for r in records if r["kind"] == "bus_send"}
    bus = ReplayBus(script, delay=header["bus_delay"],
                    drop_rate=header["bus_drop_rate"])
    fleet = Fleet(
        store, header["n_frontends"], bus=bus,
        shared_cache=header["shared_cache"],
        l1_capacity=header["l1_capacity"],
        l2_capacity=header["l2_capacity"],
        registry=FragmentRegistry() if header["registry"] else None,
        backend=header["backend"],
        gossip_fanout=header["gossip_fanout"],
        service_kwargs=header["service_kwargs"] or None,
        obs=header["obs"], gossip_repair=header["gossip_repair"],
        policy=header["policy"], single_flight=header["single_flight"],
        lease_ttl=header["lease_ttl"], flight=True, device=device)

    mismatches: List[str] = []
    closed = False
    for op in (r for r in records if r["kind"] == "op"):
        name = op["op"]
        if name == "submit":
            if op.get("scripted"):
                raise ReplayError("scripted submit cannot be replayed")
            gtid = fleet.submit(op["expr"], tenant=op["tenant"],
                                calib_iters=op["calib_iters"],
                                stream=op["stream"],
                                frontend=op["frontend"])
            if gtid != op["gtid"]:
                mismatches.append(
                    f"submit issued gtid {gtid}, recorded {op['gtid']}")
        elif name == "step":
            if op.get("scripted"):
                raise ReplayError(
                    "run used a failure_script, which the log cannot "
                    "serialize — replay programmatically instead")
            fleet.step(op["frontend"], pump_rounds=op["pump_rounds"])
        elif name == "pump":
            fleet.pump(op["rounds"])
        elif name == "drain":
            fleet.drain(max_windows=op["max_windows"])
        elif name == "bump":
            fleet.bump_dataset_version(op["frontend"])
        elif name == "stream":
            fleet.stream(op["gtid"], frontend=op["frontend"])
        elif name == "node_leave":
            fleet.node_leave(op["grid_node"],
                             observed_by=op["observed_by"])
        elif name == "node_join":
            fleet.node_join(op["grid_node"], observed_by=op["observed_by"])
        elif name == "frontend_leave":
            fleet.frontend_leave(op["index"])
        elif name == "ban_frontend":
            fleet.ban_frontend(op["index"], by=op["by"])
        elif name == "close":
            fleet.close()
            closed = True
        else:
            raise ReplayError(f"unknown driver op {name!r}")

    # snapshot before the implicit close() below appends its own op
    replay_records = list(fleet.flight.records)
    stats = fleet.fleet_stats()
    trace = fleet.trace_records() if header["obs"] else []
    if not closed:
        fleet.close()

    want_finals, want_snaps = _projected(records)
    got_finals, got_snaps = _projected(replay_records)
    for label, want, got in (("final", want_finals, got_finals),
                             ("stream_snapshot", want_snaps, got_snaps)):
        if want == got:
            continue
        n = min(len(want), len(got))
        i = next((k for k in range(n) if want[k] != got[k]), n)
        mismatches.append(
            f"{label}[{i}]: recorded "
            f"{want[i] if i < len(want) else '<missing>'} vs replayed "
            f"{got[i] if i < len(got) else '<missing>'} "
            f"({len(want)} recorded, {len(got)} replayed)")
    identical = (not mismatches and not bus.divergences
                 and bus.overruns == 0)
    return ReplayReport(identical=identical, mismatches=mismatches,
                        bus_divergences=list(bus.divergences),
                        overruns=bus.overruns,
                        n_finals=len(got_finals),
                        n_snapshots=len(got_snaps),
                        fleet_stats=stats, records=replay_records,
                        trace=trace)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: replay a ``--flight-out`` log and assert bit-identity.
    Exit 0 when finals and stream prefixes match the recording exactly,
    1 otherwise (with a mismatch report on stdout)."""
    ap = argparse.ArgumentParser(
        description="Replay a recorded fleet flight log and assert "
                    "bit-identical finals and stream prefixes.")
    ap.add_argument("log", help="flight JSONL written by --flight-out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the rebuilt store lives and the replay runs")
    args = ap.parse_args(argv)
    records = flight_lib.load_flight(args.log)
    report = replay_run(records, device=args.device)
    print(f"replay: {report.n_finals} finals, {report.n_snapshots} "
          f"stream snapshots, {report.overruns} script overruns, "
          f"{len(report.bus_divergences)} bus divergences")
    if report.identical:
        print("replay: bit-identical to recording")
        return 0
    for m in report.mismatches[:10]:
        print(f"  mismatch: {m}")
    for d in report.bus_divergences[:10]:
        print(f"  bus: {d}")
    print("replay: DIVERGED from recording")
    return 1


if __name__ == "__main__":
    sys.exit(main())
