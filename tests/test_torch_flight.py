"""The port's flight recorder and replay (``obs/flight.py``,
``obs/replay.py``) against the JAX package's, both ways: a log recorded by
the reference's serve launcher (``--fleet 4 --drop-rate 0.1 --kill-node 1
--flight-out``, sim backend) replays identical through the port's
``replay_run``, a log recorded by the port's launcher replays identical
through the reference's, the two launchers write the same log, the
port's CLI replays on the CPU, and the port flags a tampered log."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import jse as ref_jse
from repro.launch import serve as ref_serve
from repro.obs import flight as ref_flight
from repro.obs import replay as ref_replay
from repro_torch.core import brick as port_brick
from repro_torch.core import jse as port_jse
from repro_torch.launch import serve as port_serve
from repro_torch.obs import flight as port_flight
from repro_torch.obs import replay as port_replay
from test_torch_fabric import packet_clock
from test_torch_parity import ref_store

REPO = Path(__file__).resolve().parents[1]
# the launcher flags of the recorded run (the queries cut to keep the
# reference's run short; events, fleet, loss and the kill as specified)
FLAGS = ["--mode", "query", "--fleet", "4", "--drop-rate", "0.1",
         "--kill-node", "1", "--queries", "36", "--n-events", "512"]
VARIANTS = {"plain": [], "policy-single-flight-stream": [
    "--policy", "--single-flight", "--stream", "--bus-seed", "3"]}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def logs(request, tmp_path_factory):
    """(reference log, port log, their paths), recorded by each package's
    serve launcher with the same flags.  Both packages' packet timing
    reads a clock that advances 1 ms a read (``packet_clock``): the
    policy's node states follow the health rates made of those seconds,
    and on the wall clock a slow packet (a busy host, the reference's
    first compile) could turn a node degraded in one run and not the
    other, and the logs would differ by its decisions."""
    tmp = tmp_path_factory.mktemp(request.param)
    flags = FLAGS + VARIANTS[request.param]
    ref_path, port_path = tmp / "ref.jsonl", tmp / "port.jsonl"
    with pytest.MonkeyPatch.context() as mp:
        packet_clock(mp, ref_jse)
        packet_clock(mp, port_jse)
        ref_serve.main(flags + ["--flight-out", str(ref_path)])
        port_serve.main(flags + ["--flight-out", str(port_path),
                                 "--device", "cpu"])
    return (ref_flight.load_flight(ref_path),
            port_flight.load_flight(port_path), ref_path, port_path)


def test_both_launchers_record_the_same_log(logs):
    ref_recs, port_recs, _, _ = logs
    assert port_flight.validate_flight(port_recs) == []
    assert ref_flight.validate_flight(port_recs) == []
    assert port_recs == ref_recs
    kinds = {r["kind"] for r in port_recs}
    assert {"store_config", "run_header", "bus_send", "final"} <= kinds
    assert any(r["kind"] == "op" and r["op"] == "node_leave"
               for r in port_recs)
    assert any(r["kind"] == "bus_send" and r["outcome"] == "dropped"
               for r in port_recs)


def test_reference_log_replays_identical_in_the_port(logs):
    ref_recs = logs[0]
    report = port_replay.replay_run(ref_recs, device="cpu")
    assert report.identical, (report.mismatches, report.bus_divergences)
    assert report.overruns == 0 and report.n_finals == 36


def test_port_log_replays_identical_in_the_reference(logs):
    port_recs = logs[1]
    report = ref_replay.replay_run(port_recs)
    assert report.identical, (report.mismatches, report.bus_divergences)
    assert report.overruns == 0 and report.n_finals == 36


def test_port_replays_onto_a_store_it_is_given(logs):
    """``store=`` over the same bricks (the card's path for a full-size
    log) replays as the rebuilt store does."""
    sc = next(r for r in logs[1] if r["kind"] == "store_config")
    store = port_brick.store_from_reference(
        ref_store(n_events=sc["n_events"], n_nodes=sc["n_nodes"],
                  seed=sc["seed"]), device="cpu")
    report = port_replay.replay_run(logs[1], store=store, device="cpu")
    assert report.identical


@pytest.mark.parametrize("field,value", [("digest", "0" * 16),
                                         ("status", "REJECTED")])
def test_port_flags_a_tampered_final(logs, field, value):
    tampered = [dict(r) for r in logs[0]]
    final = next(r for r in tampered
                 if r["kind"] == "final" and r.get("digest"))
    final[field] = value
    report = port_replay.replay_run(tampered, device="cpu")
    assert not report.identical
    assert any("final" in m for m in report.mismatches)


def test_port_flags_bus_divergence_and_refuses_bad_logs(logs):
    recs = [dict(r) for r in logs[0]]
    sends = [r for r in recs if r["kind"] == "bus_send"]
    sends[len(sends) // 2]["src"] = "fe999"
    report = port_replay.replay_run(recs, device="cpu")
    assert report.bus_divergences and not report.identical
    with pytest.raises(port_replay.ReplayError):
        port_replay.replay_run(logs[0][2:], device="cpu")
    with pytest.raises(port_replay.ReplayError):
        port_replay.replay_run([r for r in logs[0]
                                if r["kind"] != "run_header"], device="cpu")
    with pytest.raises(port_replay.ReplayError):
        port_replay.replay_run([r for r in logs[0]
                                if r["kind"] != "store_config"],
                               device="cpu")


def test_replay_cli_on_the_cpu(logs):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.replay", str(logs[2]),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "bit-identical to recording" in proc.stdout
