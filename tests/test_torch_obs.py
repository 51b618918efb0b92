"""The port's observability plane (``obs/trace``, ``metrics``, ``health``)
against the JAX package's: the same workloads with ``Observability`` on
give equal comparable trace records, counters, gauges, histogram buckets,
Prometheus text and health evidence, and a trace written by the port
passes the reference's validator.

Wall-clock values differ between two runs of one package already, so they
are left out of the comparisons, as the reference's own determinism tests
leave them out: the ``*_wall`` stamps of every span (and the spmd
backend's virtual stamps, which it derives from the wall clock), the
histograms that observe wall seconds, and the health plane's scan-rate
EWMAs.  Everything else must be equal, value for value."""
import json

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.fabric import Fleet as RefFleet
from repro.fabric import MessageBus as RefBus
from repro.service import QueryService as RefService
from repro_torch import obs as port_obs
from repro_torch.fabric import Fleet, MessageBus
from repro_torch.service import QueryService
from test_torch_parity import stores

HOT = ["e_total > 40 && count(pt > 15) >= 2",
       "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]
# histograms of wall seconds: the packet scan on either backend, and the
# window makespan on spmd (its clock is the wall clock)
WALL_HISTOGRAMS = {"sim": ("packet.latency_s",),
                   "spmd": ("packet.latency_s", "window.makespan_s")}
SHAPES = ["service-sim", "service-spmd", "fleet-sim", "fleet-spmd"]


def expr_of(i):
    """The serve launcher's workload: three hot queries and a long tail."""
    if i % 3 != 2:
        return HOT[(i // 3) % len(HOT)]
    return f"e_total > {20 + (i % 7) * 10} && count(pt > 15) >= {1 + i % 4}"


def drive(front, n_queries=24, window=8):
    for i in range(n_queries):
        front.submit(expr_of(i), tenant=f"tenant{i % 4}", stream=True)
        if (i + 1) % window == 0:
            front.step()
    front.drain()


def run(pkg, shape, n_events=256):
    """One workload with the observability plane on: (front end, its
    Observability bundles, trace records, merged metrics snapshot)."""
    kind, backend = shape.split("-")
    ref_store, port_store = stores(n_events=n_events, seed=0)
    kw = {"backend": backend}
    if backend == "spmd":
        kw["backend_kwargs"] = {"use_pallas": True}
    if pkg == "port":
        kw["device"] = "cpu"
    if kind == "service":
        bundle = (port_obs if pkg == "port" else ref_obs).Observability("fe0")
        svc = (QueryService if pkg == "port" else RefService)(
            port_store if pkg == "port" else ref_store, obs=bundle, **kw)
        drive(svc)
        svc.close()
        return (svc, [bundle], bundle.tracer.records(),
                bundle.metrics.snapshot())
    bus = (MessageBus if pkg == "port" else RefBus)(drop_rate=0.1, seed=0)
    fleet = (Fleet if pkg == "port" else RefFleet)(
        port_store if pkg == "port" else ref_store, 3, bus=bus, obs=True,
        single_flight=True, **kw)
    drive(fleet)
    fleet.close()
    return (fleet, [fe.obs for fe in fleet.frontends],
            fleet.trace_records(), fleet.metrics_snapshot())


@pytest.fixture(scope="module", params=SHAPES)
def pair(request):
    return (request.param, run("ref", request.param),
            run("port", request.param))


def without_wall(snapshot, backend):
    """The snapshot's dict form minus the wall-second histograms."""
    d = snapshot.to_dict()
    d["metrics"] = {k: v for k, v in d["metrics"].items()
                    if k not in WALL_HISTOGRAMS[backend]}
    return d


def test_trace_records_equal_the_reference(pair):
    shape, (_, _, ref_recs, _), (_, _, port_recs, _) = pair
    virtual = shape.endswith("sim")
    if not virtual:
        # a fleet orders its merged trace by virtual start, which spmd
        # takes from the wall clock: compare in (process, span id) order
        ref_recs, port_recs = (sorted(r, key=lambda x: (x["process"],
                                                        x["span_id"]))
                               for r in (ref_recs, port_recs))
    assert len(port_recs) == len(ref_recs) > 0
    assert port_obs.comparable_records(port_recs, virtual=virtual) == \
        ref_obs.comparable_records(ref_recs, virtual=virtual)
    assert port_obs.validate_records(port_recs) == []


def test_metrics_equal_the_reference(pair):
    shape, (_, _, _, ref_snap), (_, _, _, port_snap) = pair
    backend = shape.split("-")[1]
    want, got = without_wall(ref_snap, backend), \
        without_wall(port_snap, backend)
    assert got == want
    # the wall histograms: same edges, same number of observations
    for name in WALL_HISTOGRAMS[backend]:
        a, b = ref_snap.hist(name), port_snap.hist(name)
        assert b["edges"] == a["edges"]
        assert sum(b["counts"]) == sum(a["counts"]) > 0
    # the Prometheus exposition of everything else, byte for byte
    as_ref = ref_obs.MetricsSnapshot.from_dict(want)
    as_port = port_obs.MetricsSnapshot.from_dict(got)
    assert as_port.to_prom_text() == as_ref.to_prom_text()
    assert "counter" in as_port.to_prom_text()


def test_health_evidence_equals_the_reference(pair):
    """Packet counts, failure EWMAs and stamps per (node, origin): the
    evidence that does not come from the wall clock."""
    _, (_, ref_bundles, _, _), (_, port_bundles, _, _) = pair

    def evidence(bundles):
        return [[{k: v for k, v in e.items() if k != "rate_ewma"}
                 for e in b.health.digest()["entries"]] for b in bundles]

    assert evidence(port_bundles) == evidence(ref_bundles)
    for a, b in zip(ref_bundles, port_bundles):
        assert b.health.report().failures == a.health.report().failures
        assert set(b.health.report().states) == set(a.health.report().states)


def test_port_trace_passes_the_reference_validator(pair, tmp_path):
    _, _, (_, _, recs, _) = pair
    path = tmp_path / "trace.jsonl"
    port_obs.save_jsonl(recs, path)
    assert ref_obs.validate_file(path) == []
    chrome = tmp_path / "trace.json"
    port_obs.save_chrome(recs, chrome)
    assert json.loads(chrome.read_text()) == \
        ref_obs.chrome_from_records(ref_obs.load_jsonl(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_monitors_classify_and_merge_as_the_reference(seed):
    """The same observations (numpy-seeded walls, sizes and failures) on
    both packages' monitors, then a gossip merge: equal digests and
    reports, classification included."""
    rng = np.random.default_rng(seed)
    monitors = []
    for pkg in (ref_obs, port_obs):
        a, b = pkg.HealthMonitor("fe0"), pkg.HealthMonitor("fe1")
        monitors.append((a, b))
    for _ in range(60):
        node = int(rng.integers(0, 5))
        which = int(rng.integers(0, 2))
        if rng.random() < 0.15:
            for pair_ in monitors:
                pair_[which].observe_failure(node)
        else:
            size = int(rng.integers(1, 65))
            wall = float(rng.exponential(1e-3) * (4.0 if node == 3 else 1.0))
            for pair_ in monitors:
                pair_[which].observe_packet(node, size, wall)
    (ra, rb), (pa, pb) = monitors
    ra.merge_digest(rb.digest())
    pa.merge_digest(pb.digest())
    assert pa.digest() == ra.digest()
    assert pa.report().to_dict() == ra.report().to_dict()
    assert pb.report().to_dict() == rb.report().to_dict()


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_registries_merge_as_the_reference(seed):
    """Counters, gauges and histograms fed the same values, snapshots
    merged in a tree: equal dicts and Prometheus text."""
    rng = np.random.default_rng(seed)
    snaps = []
    for pkg in (ref_obs, port_obs):
        regs = [pkg.MetricsRegistry(origin=f"fe{i}") for i in range(3)]
        snaps.append(regs)
    for _ in range(80):
        i = int(rng.integers(0, 3))
        pick = int(rng.integers(0, 3))
        v = float(rng.exponential(0.01))
        for regs in snaps:
            if pick == 0:
                regs[i].counter("c.events").inc(int(v * 1e4))
            elif pick == 1:
                regs[i].gauge("g.width").set(v)
            else:
                regs[i].histogram("h.latency_s").observe(v)
    ref_snap = ref_obs.merge_snapshots([r.snapshot() for r in snaps[0]])
    port_snap = port_obs.merge_snapshots([r.snapshot() for r in snaps[1]])
    assert port_snap.to_dict() == ref_snap.to_dict()
    assert port_snap.to_prom_text() == ref_snap.to_prom_text()
    assert port_obs.merge2(port_snap, port_snap).to_dict() == \
        ref_obs.merge2(ref_snap, ref_snap).to_dict()
