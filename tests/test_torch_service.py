"""The port's QueryService and serve launcher against the JAX package's:
the serve workload through both services on the spmd backend with the
kernel path, ticket by ticket, final and stream prefix."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.service import QueryScheduler as RefScheduler
from repro.service import QueryService as RefService
from repro_torch.launch import serve as port_serve
from repro_torch.service import QueryScheduler, QueryService
from test_torch_parity import same_result, stores

REPO = Path(__file__).resolve().parents[1]
HOT = ["e_total > 40 && count(pt > 15) >= 2",
       "e_t_miss > 30", "pt_lead > 60 || n_tracks >= 8"]


def serve_workload(svc, n_queries=64, tenants=4, window=16):
    """The serve launcher's multi-tenant workload (every ticket streamed);
    returns ticket ids and, per ticket, every snapshot at publish time."""
    tids, snaps = [], {}
    for i in range(n_queries):
        expr = HOT[i % len(HOT)] if i % 3 != 2 else (
            f"e_total > {20 + (i % 7) * 10} && count(pt > 15) >= {1 + i % 4}")
        tid = svc.submit(expr, tenant=f"tenant{i % tenants}", stream=True)
        snaps[tid] = []
        svc.stream(tid).subscribe(snaps[tid].append)
        tids.append(tid)
        if (i + 1) % window == 0:
            svc.step()
    svc.drain()
    for tid, got in snaps.items():
        if not got:     # a cache hit published its one final at submit
            got.append(svc.stream(tid).latest())
    return tids, snaps


def test_serve_workload_identical_finals_and_stream_prefixes():
    ref_store, store = stores(n_events=256, n_nodes=4, seed=0)
    ref = RefService(ref_store, scheduler=RefScheduler(max_batch=16),
                     backend="spmd", backend_kwargs={"use_pallas": True})
    port = QueryService(store, scheduler=QueryScheduler(max_batch=16),
                        backend="spmd", backend_kwargs={"use_pallas": True},
                        device="cpu")
    rt, rsnaps = serve_workload(ref)
    pt, psnaps = serve_workload(port)
    assert len(rt) == len(pt) == 64
    for a, b in zip(rt, pt):
        ra, pb = ref.result(a), port.result(b)
        assert (ra.status, ra.expr, ra.from_cache) == \
            (pb.status, pb.expr, pb.from_cache) and pb.status == "SERVED"
        assert same_result(ra.result, pb.result)
        sa, sb = rsnaps[a], psnaps[b]
        assert len(sa) == len(sb) >= 1
        for x, y in zip(sa, sb):
            assert (x.seq, x.final) == (y.seq, y.final)
            assert same_result(x.result, y.result)
            assert (x.coverage.events_scanned, x.coverage.events_total) == \
                (y.coverage.events_scanned, y.coverage.events_total)
        assert sb[-1].final and same_result(sa[-1].result, pb.result)
    for key in ("served", "cache_hits", "batches", "jobs_run",
                "events_scanned", "fragment_evals"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key
    ref.close()
    port.close()


def test_service_requires_the_store_device():
    _, store = stores(n_events=32)
    with pytest.raises(ValueError, match="lives on"):
        QueryService(store, backend="spmd", device="meta")


def _run_serve(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


def test_serve_launcher_query_mode_on_cpu():
    proc = _run_serve("--mode", "query", "--backend", "spmd", "--use-pallas",
                      "--device", "cpu", "--queries", "12", "--n-events",
                      "128")
    assert proc.returncode == 0, proc.stderr
    assert "query-service (cpu): 12/12 served" in proc.stdout


@pytest.mark.parametrize("argv,flag", [
    (["--mode", "lm", "--arch", "grok-1-314b", "--reduced"], "--mode lm"),
    (["--mode", "lm", "--arch", "qwen3-14b", "--production-mesh"],
     "--mode lm --production-mesh"),
    (["--fleet", "4"], "--fleet > 1"),
    (["--policy"], "--policy"),
    (["--trace-out", "t.json"], "--trace-out"),
    (["--metrics-dump", "m.json"], "--metrics-dump"),
    (["--flight-out", "f.jsonl"], "--flight-out"),
    (["--autotune"], "--autotune"),
])
def test_serve_launcher_refuses_unported_options(argv, flag):
    with pytest.raises(SystemExit, match="not ported") as err:
        port_serve.main(argv + ["--device", "cpu"])
    assert str(err.value).startswith(flag)


def test_serve_launcher_rejects_scan_knobs_on_sim_backend():
    with pytest.raises(SystemExit, match="requires --backend spmd"):
        port_serve.main(["--device", "cpu", "--use-pallas"])
