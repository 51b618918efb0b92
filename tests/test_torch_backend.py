"""The port's execution backends: its own guarantees (sim and spmd
bit-identical on matched packetization, prefix snapshots equal to
``tree_merge``), and its SpmdBackend and simulation against the JAX
package's over the same bricks."""
import numpy as np
import pytest

from repro.core import backend as ref_backend
from repro.core.catalog import MetadataCatalog as RefCatalog
from repro.service import plan_window as ref_plan_window
from repro_torch.core import merge as merge_lib
from repro_torch.core.backend import (SimulatedBackend, SpmdBackend,
                                      make_backend)
from repro_torch.core.catalog import DONE, MetadataCatalog
from repro_torch.service import plan_window
from test_torch_parity import band_events, same_result, stores

POOL = ["e_total > 40 && count(pt > 15) >= 2",
        "e_total > 30 && count(pt > 15) >= 2",
        "e_t_miss > 25 && count(pt > 15) >= 2",
        "pt_lead > 60 || n_tracks >= 8",
        "e_total > 55 && sum(pt) < 400",
        "e_total + 2 * e_t_miss > 120"]
SUM_COL = POOL.index("e_total > 55 && sum(pt) < 400")
# every pt threshold and sum cap of POOL, for locating band events
POOL_THRESHOLDS = np.array([[0.0, 0.0], [15.0, 0.0], [0.0, 0.0],
                            [-1.0, 400.0]], np.float32)


def run_window(backend, store, exprs, *, calib=0, ramp=None, plan_fn=None):
    plan = (plan_fn or plan_window)(exprs)
    jids = [backend.catalog.submit(e, calib, tuple(sorted(store.bricks)))
            for e in exprs]
    partials = []
    merged, stats = backend.run_batch(jids, plan=plan,
                                      on_partial=partials.append,
                                      packet_ramp=ramp)
    return merged, stats, partials


def matched_backends(store, chunk=64, **spmd_kw):
    sim = SimulatedBackend(MetadataCatalog(store.n_nodes), store,
                           adaptive_packets=False, device="cpu")
    spmd = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       chunk_events=chunk, device="cpu", **spmd_kw)
    return sim, spmd


def assert_window_equivalent(out1, out2):
    (m1, s1, p1), (m2, s2, p2) = out1, out2
    assert s1.packets == s2.packets == len(p1) == len(p2)
    for a, b in zip(m1, m2):
        assert merge_lib.results_identical(a, b)
    for pa, pb in zip(p1, p2):
        assert (pa.seq, pa.brick_id, pa.start, pa.size) == \
               (pb.seq, pb.brick_id, pb.start, pb.size)
        assert all(merge_lib.results_identical(a, b)
                   for a, b in zip(pa.partials, pb.partials))
    assert set(s1.fragment_results) == set(s2.fragment_results)
    for key, res in s1.fragment_results.items():
        assert merge_lib.results_identical(res, s2.fragment_results[key])


# ----------------------- guarantees inside the port --------------------- #
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sim_and_spmd_bit_identical_on_matched_packetization(use_pallas):
    _, store = stores()
    sim, spmd = matched_backends(store, use_pallas=use_pallas)
    out1 = run_window(sim, store, POOL, calib=2)
    out2 = run_window(spmd, store, POOL, calib=2)
    assert_window_equivalent(out1, out2)
    assert out2[1].kernel_events == (store.n_events if use_pallas else 0)
    for cat in (sim.catalog, spmd.catalog):
        assert all(r.status == DONE for r in cat.jobs.values())


def test_spmd_prefix_snapshots_bit_identical_to_tree_merge():
    _, store = stores()
    spmd = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       chunk_events=16, use_pallas=True, device="cpu")
    merged, stats, partials = run_window(spmd, store, POOL[:3])
    assert stats.packets == len(partials) > 1
    for col in range(3):
        acc = merge_lib.MergeAccumulator()
        for k, pp in enumerate(partials, 1):
            acc.add(pp.partials[col], brick_id=pp.brick_id)
            want = merge_lib.tree_merge(
                [p.partials[col] for p in partials[:k]])
            assert merge_lib.results_identical(acc.snapshot(), want)
        assert merge_lib.results_identical(acc.snapshot(), merged[col])
    order = [(p.brick_id, p.start) for p in partials]
    assert order == sorted(order)
    times = [p.t_virtual for p in partials]
    assert times == sorted(times)


@pytest.mark.parametrize("kw", [dict(double_buffer=False),
                                dict(mesh_devices=4)])
def test_spmd_scan_options_keep_results(kw):
    _, store = stores(n_events=96)
    base = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       chunk_events=16, use_pallas=True, device="cpu")
    other = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                        chunk_events=16, use_pallas=True, device="cpu", **kw)
    m1, _, _ = run_window(base, store, POOL)
    m2, s2, p2 = run_window(other, store, POOL)
    for a, b in zip(m1, m2):
        assert merge_lib.results_identical(a, b)
    assert s2.events_scanned == sum(p.size for p in p2) == store.n_events


def test_spmd_packet_ramp_caps_early_chunks():
    _, store = stores()
    spmd = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       chunk_events=16, use_pallas=True, device="cpu")
    merged, _, partials = run_window(spmd, store, POOL[:1], ramp=4)
    assert [p.size for p in partials[:2]] == [4, 8]
    assert max(p.size for p in partials) <= 16
    assert merged[0].n_processed == store.n_events


def test_spmd_rejects_autotune_and_failure_scripts():
    """autotune sweeps the CUDA kernel's launch: on a CPU store, whose
    scans take the kernel's plain version, it raises at construction."""
    _, store = stores(n_events=32)
    for use_pallas in (True, False):
        with pytest.raises(ValueError, match="CUDA kernel's launch shape"):
            SpmdBackend(MetadataCatalog(store.n_nodes), store,
                        use_pallas=use_pallas, autotune=True, device="cpu")
    spmd = SpmdBackend(MetadataCatalog(store.n_nodes), store, device="cpu")
    assert not spmd.supports_failure_injection
    jid = spmd.catalog.submit("e_total > 40", 0, tuple(sorted(store.bricks)))
    with pytest.raises(ValueError, match="simulated-grid"):
        spmd.run_batch([jid], failure_script={0.5: 1})


def test_make_backend_factory_and_store_device():
    _, store = stores(n_events=32)
    cat = MetadataCatalog(store.n_nodes)
    assert isinstance(make_backend("sim", cat, store, device="cpu"),
                      SimulatedBackend)
    assert isinstance(make_backend("spmd", cat, store, device="cpu"),
                      SpmdBackend)
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("tpu", cat, store, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        make_backend("spmd", cat, store, device="meta")


# ----------------------- against the reference -------------------------- #
def _reference_window(ref_store, exprs, *, calib, chunk, use_pallas=True):
    spmd = ref_backend.SpmdBackend(RefCatalog(ref_store.n_nodes), ref_store,
                                   chunk_events=chunk, use_pallas=use_pallas)
    return run_window(spmd, ref_store, exprs, calib=calib,
                      plan_fn=ref_plan_window)


def _slice_band(store, brick_id, start, size, calib):
    b = store.bricks[brick_id]
    tr = b["tracks"][start:start + size].numpy()
    nt = b["n_tracks"][start:start + size].numpy()
    return band_events(tr, nt, POOL_THRESHOLDS, calib)


def _assert_matches_reference(ref_out, port_out, store, calib):
    """Finals, fragment results and every partial ``results_identical``
    across the packages, except where a partial's slice holds band
    events: there only the columns that cannot ride on rounding must
    agree (at calib 0 that is every column but the sum cap's)."""
    (rm, rs, rp), (pm, ps, pp) = ref_out, port_out
    assert rs.packets == ps.packets == len(rp) == len(pp)
    assert rs.kernel_events == ps.kernel_events == store.n_events
    n_band = 0
    for a, b in zip(rp, pp):
        assert (a.seq, a.brick_id, a.start, a.size) == \
               (b.seq, b.brick_id, b.start, b.size)
        band = _slice_band(store, b.brick_id, b.start, b.size, calib)
        n_band += int(band.sum())
        for col, (ra, pb) in enumerate(zip(a.partials, b.partials)):
            if band.any() and (calib or col == SUM_COL):
                continue
            assert same_result(ra, pb), (b.seq, col)
    assert n_band <= 2, f"{n_band} band events"
    if n_band == 0:
        for ra, pb in zip(rm, pm):
            assert same_result(ra, pb)
        assert set(rs.fragment_results) == set(ps.fragment_results)
        for key, res in rs.fragment_results.items():
            assert same_result(res, ps.fragment_results[key])


def test_spmd_kernel_path_matches_reference_at_calib_0():
    ref, store = stores(n_events=192)
    port = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       chunk_events=32, use_pallas=True, device="cpu")
    port_out = run_window(port, store, POOL)
    ref_out = _reference_window(ref, POOL, calib=0, chunk=32)
    # the window is mixed: kernel targets and plain targets both ran
    split = port._split_plan(plan_window(POOL))
    assert split.kernel_cols and split.plain_cols
    _assert_matches_reference(ref_out, port_out, store, 0)


def test_spmd_kernel_path_matches_reference_with_calibration():
    ref, store = stores(n_events=96, seed=5)
    port = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       chunk_events=32, use_pallas=True, device="cpu")
    exprs = POOL[:3] + POOL[4:5]
    port_out = run_window(port, store, exprs, calib=2)
    ref_out = _reference_window(ref, exprs, calib=2, chunk=32)
    _assert_matches_reference(ref_out, port_out, store, 2)


def test_simulated_backend_matches_reference_stream():
    ref, store = stores(n_events=128)
    port = SimulatedBackend(MetadataCatalog(store.n_nodes), store,
                            device="cpu")
    refb = ref_backend.SimulatedBackend(RefCatalog(ref.n_nodes), ref)
    for failure_script in (None, {0.5: 1}):
        exprs = [e for e in POOL if "sum(pt)" not in e]
        jp = [port.catalog.submit(e, 0, tuple(sorted(store.bricks)))
              for e in exprs]
        jr = [refb.catalog.submit(e, 0, tuple(sorted(ref.bricks)))
              for e in exprs]
        pp, rp = [], []
        pm, ps = port.run_batch(jp, plan=plan_window(exprs),
                                on_partial=pp.append,
                                failure_script=failure_script)
        rm, rs = refb.run_batch(jr, plan=ref_plan_window(exprs),
                                on_partial=rp.append,
                                failure_script=failure_script)
        assert ps.makespan_s == rs.makespan_s
        assert len(pp) == len(rp) > 0
        for a, b in zip(rp, pp):
            assert (a.seq, a.brick_id, a.start, a.size, a.node,
                    a.t_virtual, a.failures) == \
                (b.seq, b.brick_id, b.start, b.size, b.node, b.t_virtual,
                 b.failures)
            assert all(same_result(x, y)
                       for x, y in zip(a.partials, b.partials))
        assert all(same_result(x, y) for x, y in zip(rm, pm))
        assert [port.catalog.jobs[j].status for j in jp] == \
            [refb.catalog.jobs[j].status for j in jr]


class TickClock:
    """Deterministic injectable clock: a fixed step per call, so adaptive
    chunk boundaries replay identically."""

    def __init__(self, dt=0.003):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def test_adaptive_chunks_match_reference_boundaries_and_results():
    ref, store = stores()
    kw = dict(chunk_events=8, adaptive_chunks=True, chunk_target_s=0.05)
    port = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                       use_pallas=True, double_buffer=False,
                       clock=TickClock(), device="cpu", **kw)
    refb = ref_backend.SpmdBackend(RefCatalog(ref.n_nodes), ref,
                                   clock=TickClock(), **kw)
    pm, _, pp = run_window(port, store, POOL[:3])
    rm, _, rp = run_window(refb, ref, POOL[:3], plan_fn=ref_plan_window)
    assert len({p.size for p in pp}) > 1     # the controller moved
    assert [(p.brick_id, p.start, p.size) for p in pp] == \
        [(p.brick_id, p.start, p.size) for p in rp]
    for a, b in zip(rp, pp):
        assert all(same_result(x, y) for x, y in zip(a.partials, b.partials))
    assert all(same_result(x, y) for x, y in zip(rm, pm))


@pytest.mark.parametrize("events,wall,want", [
    ([(64, 0.001)] * 32, None, 640),
    ([(8, 10.0)] * 64, None, 8),
    ([(100, 1.0), (110, 1.0)], 0.25, 100),
    ([(100, 1.0), (200, 1.0), (0, 1.0), (10, 0.0)], 0.25, 200),
])
def test_chunk_controller_matches_reference(events, wall, want):
    from repro_torch.core.backend import ChunkController
    kw = dict(initial=64, min_chunk=8, max_chunk=4096, target_s=0.01,
              alpha=0.5, hysteresis=0.0) if wall is None else dict(
        initial=100, target_s=1.0, alpha=1.0, hysteresis=wall)
    port, refc = ChunkController(**kw), ref_backend.ChunkController(**kw)
    assert port.chunk() == refc.chunk()
    for n, w in events:
        port.observe(events=n, wall_s=w)
        refc.observe(events=n, wall_s=w)
        assert port.chunk() == refc.chunk()
        assert port.scan_rate == refc.scan_rate
    assert port.chunk() == want
