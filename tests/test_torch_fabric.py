"""The port's coherence fabric (``fabric/``) against the JAX package's:
fleets of front-ends over the same stores, on a lossy seeded bus, give
equal ``fleet_stats()``, final digests, stream-snapshot prefixes, gossip
bounds, single-flight adoptions, bus counters and catalogue epochs; the
bus drops the same messages for one seed; and an L2 checkpoint or a
fragment registry saved by either package loads in the other."""
import dataclasses

import numpy as np
import pytest

from repro import fabric as ref_fabric
from repro.core import merge as ref_merge
from repro.fabric import gossip as ref_gossip
from repro.fabric import leases as ref_leases
from repro.service import planner as ref_planner
from repro_torch import fabric as port_fabric
from repro_torch.core import merge as port_merge
from repro_torch.fabric import gossip as port_gossip
from repro_torch.fabric import leases as port_leases
from repro_torch.obs.flight import result_digest
from repro_torch.service import planner as port_planner
from test_torch_parity import stores

HOT = ["e_total > 40 && count(pt > 15) >= 2",
       "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]
Q = HOT[0]


@dataclasses.dataclass(frozen=True)
class Case:
    """One fleet configuration of the parity matrix."""
    n: int = 4
    backend: str = "sim"
    drop_rate: float = 0.1
    bus_seed: int = 0
    delay: int = 0
    single_flight: bool = True
    policy: bool = False
    kill_node: int = None
    n_queries: int = 32


CASES = {
    "sim-lossy-single-flight": Case(),
    "sim-kill-policy": Case(n=3, drop_rate=0.2, bus_seed=3,
                            single_flight=False, policy=True, kill_node=1),
    "sim-delayed-bus": Case(n=2, drop_rate=0.05, bus_seed=5, delay=1),
    "spmd-kernel-lossy": Case(backend="spmd", bus_seed=1),
    # no policy on spmd: its health evidence is wall seconds, which
    # differ from run to run (a policy's states with them)
    "spmd-kernel-kill": Case(backend="spmd", drop_rate=0.2, bus_seed=2,
                             single_flight=False, kill_node=2),
}


def expr_of(i):
    """The serve launcher's fleet workload: hot queries advance slower than
    the round-robin, so duplicates land on different front-ends."""
    if i % 3 != 2:
        return HOT[(i // 3) % len(HOT)]
    return f"e_total > {20 + (i % 7) * 10} && count(pt > 15) >= {1 + i % 4}"


def run_fleet(pkg, case, store, window=8):
    """Drive one fleet: (fleet, global ids, per-ticket stream digests)."""
    fab = port_fabric if pkg == "port" else ref_fabric
    kw = {"device": "cpu"} if pkg == "port" else {}
    if case.backend == "spmd":
        kw["backend_kwargs"] = {"use_pallas": True}
    fleet = fab.Fleet(
        store, case.n, bus=fab.MessageBus(delay=case.delay,
                                          drop_rate=case.drop_rate,
                                          seed=case.bus_seed),
        registry=fab.FragmentRegistry(), backend=case.backend,
        obs=case.policy, policy=case.policy, gossip_repair=case.policy,
        single_flight=case.single_flight, **kw)
    gtids, snaps = [], {}
    for i in range(case.n_queries):
        g = fleet.submit(expr_of(i), tenant=f"tenant{i % 4}", stream=True)
        snaps[g] = []
        fleet.stream(g).subscribe(
            lambda s, g=g: snaps[g].append((s.seq, bool(s.final),
                                            result_digest(s.result))))
        gtids.append(g)
        if (i + 1) % window == 0:
            fleet.step()
        if case.kill_node is not None and i == case.n_queries // 3:
            fleet.node_leave(case.kill_node)
        if i == case.n_queries // 2:
            fleet.bump_dataset_version(0)
    fleet.drain()
    return fleet, gtids, snaps


def summary(fleet, gtids, snaps):
    bus = fleet.bus.stats
    return {
        "stats": fleet.fleet_stats(),
        "finals": [(fleet.result(g).status, fleet.result(g).adopted,
                    fleet.result(g).from_cache,
                    result_digest(fleet.result(g).result)) for g in gtids],
        "snapshots": snaps,
        "rounds_bound": fleet.rounds_bound,
        "fanout": fleet.gossip_fanout,
        "epochs": [fe.catalog.dataset_epoch for fe in fleet.frontends],
        "dead": [sorted(fe.catalog.dead_nodes()) for fe in fleet.frontends],
        "bus": dataclasses.asdict(bus),
        "bus_round": fleet.bus.round,
        "gossip": [dataclasses.asdict(fe.gossip.stats)
                   for fe in fleet.frontends],
        "policy": fleet.policy_states(),
        "l2": (len(fleet.l2), fleet.l2.stats.hits,
               fleet.l2.stats.fragment_puts),
        "registry_hot": fleet.registry.hot(4),
    }


@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet_matches_the_reference(name):
    case = CASES[name]
    ref_store, port_store = stores(n_events=256, seed=0)
    want = summary(*run_fleet("ref", case, ref_store))
    got = summary(*run_fleet("port", case, port_store))
    assert got == want
    assert all(f[0] == "SERVED" for f in got["finals"])
    assert got["stats"]["served"] == case.n_queries
    if case.single_flight:
        assert got["stats"]["adopted"] > 0
    if case.kill_node is not None:
        assert all(case.kill_node in d for d in got["dead"])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("drop_rate", [0.1, 0.5])
def test_bus_drops_the_same_messages_for_one_seed(seed, drop_rate):
    buses = [fab.MessageBus(drop_rate=drop_rate, seed=seed)
             for fab in (ref_fabric, port_fabric)]
    for bus in buses:
        for i in range(4):
            bus.register(f"fe{i}")
    rng = np.random.default_rng(seed)
    got = [[], []]
    for r in range(20):
        for _ in range(int(rng.integers(1, 6))):
            src, dst = (f"fe{int(x)}" for x in rng.choice(4, 2,
                                                          replace=False))
            for bus in buses:
                bus.send(src, dst, "t", {"r": r})
        for out, bus in zip(got, buses):
            bus.tick()
            out.append([(e.seq, e.src, e.dst, e.payload["r"])
                        for d in ("fe0", "fe1", "fe2", "fe3")
                        for e in bus.recv(d)])
    assert got[1] == got[0]
    assert dataclasses.asdict(buses[1].stats) == \
        dataclasses.asdict(buses[0].stats)
    assert buses[1].stats.dropped > 0


def test_gossip_and_lease_bounds_match_the_reference():
    for n in range(1, 40):
        assert port_gossip.adaptive_fanout(n) == \
            ref_gossip.adaptive_fanout(n)
        for fanout in (None, 1, 2, 3):
            assert port_gossip.rounds_bound(n, fanout) == \
                ref_gossip.rounds_bound(n, fanout)
            for delay in (0, 2):
                assert port_leases.lease_ttl(n, fanout, delay) == \
                    ref_leases.lease_ttl(n, fanout, delay)
            for drop in (0.0, 0.1, 0.4):
                want = ref_gossip.rounds_bound_lossy(n, fanout,
                                                     drop_rate=drop)
                assert port_gossip.rounds_bound_lossy(
                    n, fanout, drop_rate=drop) == want
    vv = {"fe0": 2, "fe1": 0, "fe3": 1}
    assert port_leases.lease_key("(e_total > 40.0)", 4, vv) == \
        ref_leases.lease_key("(e_total > 40.0)", 4, vv)
    merged = [dict(vv), dict(vv)]
    assert port_gossip.merge_vv(merged[0], {"fe1": 3, "fe3": 1}) == \
        ref_gossip.merge_vv(merged[1], {"fe1": 3, "fe3": 1}) is True
    assert merged[0] == merged[1]
    assert port_gossip.effective_epoch(vv) == ref_gossip.effective_epoch(vv)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_l2_checkpoint_loads_in_the_other_package(writer, reader, tmp_path):
    """A fleet of one package answers a query and checkpoints its L2 on
    close; a fleet of the other boots from the file and answers the same
    query from the shared tier with zero brick I/O, the same result."""
    path = tmp_path / "l2.json"
    ref_store, port_store = stores(n_events=192, seed=0)
    kw = {"ref": {}, "port": {"device": "cpu"}}
    fab = {"ref": ref_fabric, "port": port_fabric}
    store = {"ref": ref_store, "port": port_store}
    fleet = fab[writer].Fleet(store[writer], 2, l2_path=path, **kw[writer])
    t = fleet.submit(Q, frontend=0)
    fleet.drain()
    want = fleet.result(t).result.to_dict()
    fleet.close()
    reborn = fab[reader].Fleet(store[reader], 2, l2_path=path, **kw[reader])
    assert len(reborn.l2) > 0
    t2 = reborn.submit(Q, frontend=1)
    reborn.drain()
    got = reborn.result(t2)
    assert got.status == "SERVED" and got.from_cache
    assert got.result.to_dict() == want
    assert all(fe.service.stats.events_scanned == 0
               for fe in reborn.frontends)
    reborn.close()
    # the tier itself round-trips: save by one, load by the other
    tier = fab[reader].SharedCacheTier.load(path)
    tier.save(tmp_path / "again.json")
    assert fab[writer].SharedCacheTier.load(tmp_path / "again.json") \
        .to_json() == fab[writer].SharedCacheTier.load(path).to_json()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_fragment_registry_loads_in_the_other_package(writer, reader,
                                                      tmp_path):
    fab = {"ref": ref_fabric, "port": port_fabric}
    planner = {"ref": ref_planner, "port": port_planner}
    reg = fab[writer].FragmentRegistry(hot_min_windows=1, max_hot=4)
    for w in range(3):
        reg.observe_plan(planner[writer].plan_window(
            [f"e_total > {30 + w} && count(pt > 15) >= 2",
             "e_t_miss > 20 && count(pt > 15) >= 2", HOT[2]]))
    path = tmp_path / "registry.json"
    reg.save(path)
    loaded = fab[reader].FragmentRegistry.load(path)
    assert loaded.hot() == reg.hot()
    assert loaded.windows_observed == reg.windows_observed
    assert set(loaded.records) == set(reg.records)


def test_shared_tier_results_cross_the_packages_exactly():
    """A result the port puts into the L2 reads back in the reference as
    the same QueryResult, bit for bit, and the other way round."""
    ref_store, port_store = stores(n_events=192, seed=0)
    ref = ref_fabric.Fleet(ref_store, 1)
    port = port_fabric.Fleet(port_store, 1, device="cpu")
    for f in (ref, port):
        f.submit(Q)
        f.drain()
    a = ref.result(0).result
    b = port.result(0).result
    assert ref_merge.results_identical(
        a, ref_merge.QueryResult.from_dict(b.to_dict()))
    assert port_merge.results_identical(
        port_merge.QueryResult.from_dict(a.to_dict()), b)
    ref.close()
    port.close()
