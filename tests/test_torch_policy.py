"""The port's failure policy (``service/policy.py``) and elastic manager
(``core/elastic.py``) against the JAX package's, on the sim backend with
the same stores and the same failure scripts: job statuses, final digests,
policy states, decisions and re-replication plans, and ElasticManager
leave/join plans must be equal.

Replicas sit at stride 2 on 4 nodes (owner pairs {0, 2} and {1, 3}).  When
both nodes of a stride pair are dead as a window starts, their bricks are
lost: both packages fail those jobs rather than serve a partial result.
A node killed mid-scan has its packets requeued on the live nodes, so
every other script of at most two kills, stride pairs killed mid-scan
included, finishes DONE with results bit-identical to the failure-free
run, speculation or not.  (The reference's own speculation property
expects DONE for every script, and fails for another reason: it calls
``MergeAccumulator.add`` with a keyword the accumulator does not take.)"""
import dataclasses

import numpy as np
import pytest

from repro.core import merge as ref_merge
from repro.core.catalog import MetadataCatalog as RefCatalog
from repro.core.elastic import ElasticManager as RefElastic
from repro.core.elastic import elastic_mesh_shape as ref_mesh_shape
from repro.core.jse import JobSubmissionEngine as RefEngine
from repro.obs import Observability as RefObs
from repro.obs.health import HealthReport as RefReport
from repro.service import QueryService as RefService
from repro.service.policy import FailurePolicy as RefPolicy
from repro.service.policy import PolicyConfig as RefConfig
from repro_torch.core import merge as port_merge
from repro_torch.core.backend import SimulatedBackend
from repro_torch.core.catalog import DONE, MetadataCatalog
from repro_torch.core.elastic import ElasticManager, elastic_mesh_shape
from repro_torch.core.jse import JobSubmissionEngine
from repro_torch.obs import Observability
from repro_torch.obs.flight import result_digest
from repro_torch.obs.health import HealthReport
from repro_torch.service import QueryService
from repro_torch.service.policy import FailurePolicy, PolicyConfig
from test_torch_parity import stores

EXPRS = ["e_total > 40 && count(pt > 15) >= 2",
         "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]
STRIDE_PAIRS = ({0, 2}, {1, 3})
# (failure script {virtual time: node}, nodes dead before the window)
SCRIPTS = {
    "none": ({}, ()),
    "single-early": ({0.2: 1}, ()),
    "single-late": ({0.9: 3}, ()),
    "correlated-adjacent": ({}, (1, 2)),
    "correlated-adjacent-mid": ({0.4: 0, 0.41: 1}, ()),
    "two-kills-apart": ({0.3: 2, 1.2: 3}, ()),
    "stride-pair-02-mid-scan": ({0.05: 0, 0.06: 2}, ()),
    "stride-pair-13-mid-scan": ({0.3: 1, 0.7: 3}, ()),
    "stride-pair-02-dead": ({}, (0, 2)),
    "stride-pair-13-dead": ({}, (1, 3)),
    "stride-pair-13-dead-and-mid-scan": ({0.2: 3}, (1,)),
}


def run_engine(pkg, store, *, failure_script=None, dead=(), **kw):
    """One shared-scan window of EXPRS on fixed 64-event packets:
    (job statuses, result digests of DONE jobs, JobStats summary)."""
    port = pkg == "port"
    cat = (MetadataCatalog if port else RefCatalog)(store.n_nodes)
    for n in dead:
        cat.mark_dead(n)
    jse = (JobSubmissionEngine if port else RefEngine)(
        cat, store, adaptive_packets=False)
    jids = [jse.submit(e) for e in EXPRS]
    merged, stats = jse.run_job_batch_simulated(
        jids, failure_script=dict(failure_script or {}), **kw)
    statuses = [cat.jobs[j].status for j in jids]
    digests = [result_digest(m) if s == DONE else None
               for m, s in zip(merged, statuses)]
    summary = {"failures": stats.failures, "packets": stats.packets,
               "speculated": stats.speculated, "spec_wins": stats.spec_wins,
               "nodes": [t.node for t in stats.packet_telemetry],
               "makespan_s": stats.makespan_s}
    return statuses, digests, summary


@pytest.mark.parametrize("speculate", [False, True])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_failure_scripts_match_the_reference(name, speculate):
    script, dead = SCRIPTS[name]
    ref_store, port_store = stores(n_events=256, seed=0)
    want = run_engine("ref", ref_store, failure_script=script, dead=dead,
                      speculate=speculate)
    got = run_engine("port", port_store, failure_script=script, dead=dead,
                     speculate=speculate)
    assert got == want
    if set(dead) in STRIDE_PAIRS:
        assert all(s != DONE for s in got[0])
    else:
        assert all(s == DONE for s in got[0])
        base = run_engine("port", stores(n_events=256, seed=0)[1])
        assert got[1] == base[1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_speculation_property_on_random_kill_scripts(seed):
    """The reference's speculation property, held to the reference's
    outcome: up to two nodes, each dead before the window or killed at a
    random time, a random speculation lead.  The same statuses, digests
    and stats in both packages; DONE and identical to the failure-free
    run unless a stride pair was dead before the window, which fails."""
    rng = np.random.default_rng(seed)
    nodes = rng.choice(4, size=int(rng.integers(1, 3)), replace=False)
    if seed < 2:   # each stride pair at least once
        nodes = np.array(sorted(STRIDE_PAIRS[seed]))
    times = rng.uniform(0.0, 3.0, len(nodes))
    if seed < 2:
        times[:] = 0.0
    dead = tuple(int(n) for n, t in zip(nodes, times) if t < 0.1)
    script = {round(float(t), 3): int(n)
              for n, t in zip(nodes, times) if t >= 0.1}
    lead = float(rng.uniform(0.5, 3.0))
    ref_store, port_store = stores(n_events=256, seed=11)
    want = run_engine("ref", ref_store, failure_script=script, dead=dead,
                      speculate=True, spec_lead_factor=lead)
    got = run_engine("port", port_store, failure_script=script, dead=dead,
                     speculate=True, spec_lead_factor=lead)
    assert got == want
    base = run_engine("port", stores(n_events=256, seed=11)[1])
    if set(dead) in STRIDE_PAIRS:
        assert all(s != DONE for s in got[0])
    else:
        assert all(s == DONE for s in got[0]) and got[1] == base[1]


def fabricated_reports(rng, n_windows, n_nodes=4):
    """Seeded failure-EWMA evidence per window (rates all equal)."""
    out = []
    for _ in range(n_windows):
        fails = {n: float(rng.choice([0.0, 0.1, 0.5, 0.9],
                                     p=[0.5, 0.2, 0.15, 0.15]))
                 for n in range(n_nodes)}
        out.append(fails)
    return out


def report(cls, fails):
    states = {n: ("suspect" if f >= 0.3 else "ok") for n, f in fails.items()}
    return cls(states=states, rates={n: 1e-3 for n in fails},
               failures=dict(fails), median_rate=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_decisions_match_the_reference(seed):
    """The state machine on the same evidence, with deaths and rejoins:
    states, avoid sets, probe quotas, transitions and re-replication
    copies equal window by window, and the stores' placements after."""
    rng = np.random.default_rng(seed)
    ref_store, port_store = stores(n_events=192, seed=0)
    cfg = dict(degrade_after=1, recover_after=1, ban_after=2, probe_after=1,
               probe_packets=2, rereplicate_after=2)
    rc, pc = RefCatalog(4), MetadataCatalog(4)
    rp = RefPolicy(rc, ref_store, config=RefConfig(**cfg))
    pp = FailurePolicy(pc, port_store, config=PolicyConfig(**cfg))
    seen = set()
    for w, fails in enumerate(fabricated_reports(rng, 14)):
        if w == 5:
            rc.mark_dead(2)
            pc.mark_dead(2)
        if w == 9:
            rc.mark_alive(2)
            pc.mark_alive(2)
        rd = rp.decide(report(RefReport, fails))
        pd = pp.decide(report(HealthReport, fails))
        assert pp.states() == rp.states()
        seen |= set(pp.states().values())
        assert (pd.avoid, pd.probe_quota, pd.transitions, pd.rereplicated,
                pd.speculate) == (rd.avoid, rd.probe_quota, rd.transitions,
                                  rd.rereplicated, rd.speculate)
        assert pd.backend_kwargs() == rd.backend_kwargs()
    assert seen == {"ok", "degraded", "banned", "probing"}
    assert pp.rereplications == rp.rereplications
    assert pp.routable_fraction() == rp.routable_fraction()
    assert {b: dataclasses.astuple(s) for b, s in port_store.specs.items()} \
        == {b: dataclasses.astuple(s) for b, s in ref_store.specs.items()}


def lifecycle_config(cls):
    return cls(degrade_after=1, recover_after=1, ban_after=1, probe_after=2,
               probe_packets=4, rereplicate_after=2, rate_evidence=False)


def drive_lifecycle(pkg, store):
    """The reference's banned-node lifecycle: node 1 fails for two
    windows, then the service runs on; per window the policy states,
    then every ticket's status and final digest."""
    port = pkg == "port"
    obs = (Observability if port else RefObs)(origin="fe0")
    cat = (MetadataCatalog if port else RefCatalog)(store.n_nodes)
    pol = (FailurePolicy if port else RefPolicy)(
        cat, store, obs=obs,
        config=lifecycle_config(PolicyConfig if port else RefConfig))
    if port:
        svc = QueryService(store, backend=SimulatedBackend(
            cat, store, adaptive_packets=False, device="cpu"), obs=obs,
            policy=pol, device="cpu")
    else:
        from repro.core.backend import SimulatedBackend as RefSim
        svc = RefService(store, backend=RefSim(
            cat, store, adaptive_packets=False), obs=obs, policy=pol)
    states, tickets = [], []
    for w in range(8):
        if w < 2:
            for _ in range(6):
                obs.health.observe_failure(1)
        for q in range(3):
            tickets.append(svc.submit(f"e_total > {20 + 2 * (w * 3 + q)}",
                                      tenant=f"t{q}"))
        svc.step()
        states.append(pol.states())
    svc.drain()
    finals = [(svc.result(t).status, result_digest(svc.result(t).result))
              for t in tickets]
    svc.close()
    return states, finals, pol.rereplications


def test_banned_node_lifecycle_matches_the_reference():
    ref_store, port_store = stores(n_events=1024, seed=0)
    got = drive_lifecycle("port", port_store)
    want = drive_lifecycle("ref", ref_store)
    assert got == want
    states, finals, rereplications = got
    assert "banned" in {s[1] for s in states} and rereplications >= 1
    assert all(status == "SERVED" for status, _ in finals)


@pytest.mark.parametrize("ops", [
    [("leave", 1)], [("leave", 1), ("leave", 2)], [("leave", 1),
                                                    ("leave", 3)],
    [("leave", 0), ("join", 0)], [("leave", 2), ("copies", None),
                                  ("join", 2)],
    [("join", 3)]])
def test_elastic_plans_match_the_reference(ops):
    ref_store, port_store = stores(n_events=384, seed=0)
    rm = RefElastic(RefCatalog(4), ref_store)
    pm = ElasticManager(MetadataCatalog(4), port_store)
    last = None
    for op, node in ops:
        if op == "copies":
            rm.apply_copies(last[0])
            pm.apply_copies(last[1])
            continue
        last = (getattr(rm, f"node_{op}")(node),
                getattr(pm, f"node_{op}")(node))
        assert dataclasses.asdict(last[1]) == dataclasses.asdict(last[0])
        assert pm.catalog.dead_nodes() == rm.catalog.dead_nodes()
    assert {b: dataclasses.astuple(s) for b, s in port_store.specs.items()} \
        == {b: dataclasses.astuple(s) for b, s in ref_store.specs.items()}


def test_elastic_mesh_shape_matches_the_reference():
    for hosts in range(0, 300, 7):
        for mp, pods in ((16, 1), (8, 2), (4, 1)):
            assert elastic_mesh_shape(hosts, model_parallel=mp, pods=pods) \
                == ref_mesh_shape(hosts, model_parallel=mp, pods=pods)


def test_port_results_merge_like_the_reference():
    """The digests above compare results through ``to_dict``: the two
    packages' QueryResults of one engine run must be field-for-field
    identical too."""
    ref_store, port_store = stores(n_events=256, seed=0)
    cat_r, cat_p = RefCatalog(4), MetadataCatalog(4)
    r = RefEngine(cat_r, ref_store, adaptive_packets=False)
    p = JobSubmissionEngine(cat_p, port_store, adaptive_packets=False)
    rm, _ = r.run_job_batch_simulated([r.submit(e) for e in EXPRS])
    pm, _ = p.run_job_batch_simulated([p.submit(e) for e in EXPRS])
    for a, b in zip(rm, pm):
        assert port_merge.results_identical(
            port_merge.QueryResult.from_dict(a.to_dict()), b)
        assert ref_merge.results_identical(
            a, ref_merge.QueryResult.from_dict(b.to_dict()))
