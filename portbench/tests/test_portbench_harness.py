"""The harness's own checks: cells found by their names alone, a run's
exit without a card, the result line's keys, where a run writes, and
``BENCHMARK.json`` and the configuration files against the rules they
keep."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, workload, trace=False, seed=7, seconds=0.3):
    cell = harness.load_cell(root, workload)
    return harness.run(cell, seed=seed, seconds=seconds, trace=trace,
                       device="cpu", t0=time.perf_counter())


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(folder.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("workload", ["glm.train", "qwen.prefill"])
def test_result_line_keys(tiny_root, workload):
    for trace in (False, True):
        out = run_tiny(tiny_root, workload, trace=trace)
        want = KEYS + (["breakdown"] if trace else []) + ["checks"]
        assert list(out) == want
        assert out["correct"] is True and out["failed"] == 0
        assert out["attempted"] >= 1
        assert set(out["checks"]) == set(harness.load_cell(
            tiny_root, workload).limits)
        if trace:
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            cell = harness.load_cell(tiny_root, workload)
            assert set(out["metrics"]) == {m["name"]
                                           for m in cell.end_to_end}
        json.dumps(out)


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell,
    added as new files and new entries: found and run by name, with no
    file of the benchmark changed."""
    from conftest import make_root
    root = make_root(tmp_path)
    before = digest(root / "portbench")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/tiny-glm.json").read_text())
    cfg["model"]["num_layers"] = 1
    new = {"portbench/configs/tiny-glm-l1.json": json.dumps(cfg),
           "portbench/traffic/tiny-prefill-96.json": json.dumps(
               {"kind": "prefill", "prompt_len": 96}),
           "portbench/limits/glm.prefill.json": json.dumps(
               {"logit_err": 1.0}),
           "portbench/metrics/prompts_seen.prefill.py":
               "def read(run):\n    return float(run.units)\n"}
    for rel, text in new.items():
        assert not (root / rel).exists()
        (root / rel).write_text(text)
    bench["configs"].append({"name": "tiny-glm-l1", "source": "x",
                             "file": "portbench/configs/tiny-glm-l1.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "glm.prefill", "config": "tiny-glm-l1",
                               "traffic": "tiny-prefill-96", "chips": 1,
                               "why": "a test"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "prefill_tokens_per_s":
            metric["workloads"].append("glm.prefill")
    bench["per_layer"].append({"name": "prompts_seen.prefill", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves":
                               "prefill_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {rel.removeprefix("portbench/")
                                        for rel in new}
    # a per-layer metric with no ``workloads`` is read in every cell that
    # reports the end-to-end metric it moves
    assert {w for w in ("glm.prefill", "qwen.prefill", "glm.train")
            if "prompts_seen.prefill" in {
                m["name"] for m in harness.load_cell(root, w).per_layer}} \
        == {"glm.prefill", "qwen.prefill"}
    out = run_tiny(root, "glm.prefill", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["prompts_seen.prefill"]["value"] >= 1
    out = run_tiny(root, "glm.prefill")
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "peak_gb",
                                   "setup_s"}


def test_a_run_without_a_card_exits_non_zero_and_writes_no_metric():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "chatglm3-6b.train-4k", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "metrics" not in proc.stdout


def test_a_run_writes_only_in_its_checkout_home_cache_and_tmp(tmp_path):
    """A whole run of a tiny cell in a process of its own, every file
    it opens for writing and every path it creates, renames or removes
    recorded by an audit hook."""
    from conftest import make_root
    root = make_root(tmp_path / "checkout")
    dirs = {name: tmp_path / name for name in ("home", "cache", "tmp")}
    for d in dirs.values():
        d.mkdir()
    code = f"""
import json, os, sys, time
writes = []
def hook(event, args):
    if event == "open":
        path, mode, flags = args
        if not isinstance(path, (str, bytes, os.PathLike)):
            return
        if (mode and any(c in str(mode) for c in "wax+")) or (
                flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            writes.append(os.path.abspath(os.fsdecode(path)))
    elif event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir",
                   "os.symlink", "os.link", "os.truncate"):
        writes.append(os.path.abspath(os.fsdecode(args[0])))
sys.addaudithook(hook)
sys.path[:0] = [{str(root)!r}, {str(REPO / 'src')!r}]
from portbench import harness
harness.cache_env({str(root)!r})
for w, trace in (("qwen.train", True), ("qwen.prefill", False)):
    cell = harness.load_cell({str(root)!r}, w)
    harness.run(cell, seed=9, seconds=0.2, trace=trace, device="cpu",
                t0=time.perf_counter())
print(json.dumps(writes))
"""
    env = dict(os.environ, HOME=str(dirs["home"]),
               XDG_CACHE_HOME=str(dirs["cache"]), TMPDIR=str(dirs["tmp"]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600,
                          check=True)
    writes = json.loads(proc.stdout.strip().splitlines()[-1])
    allowed = [str(root)] + [str(d) for d in dirs.values()] + ["/dev/null"]
    outside = [w for w in writes
               if not any(w == a or w.startswith(a + os.sep)
                          for a in allowed)]
    assert not outside


# --------------------------------------------------------------------------
# BENCHMARK.json and the configuration files against their rules

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: keys that name a width, which ``reduced`` may never name
WIDTH = re.compile(r"(_size$|_dim$|_rank$|^kv_channels$|expansion|per_tok|"
                   r"^d_model$|^d_ff$|^head)")


def line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and \
        "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_its_rules():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"][:2] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (b["run_seconds"] + 60) + \
        cells * 2 * 90 + 1200
    assert total <= 43200
    names = {}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["why"]) and \
            line(c["source"])
        assert c["file"].startswith("portbench/") and \
            (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        names[c["name"]] = c
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    used = set()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "portbench/limits" / f"{w['name']}.json").is_file()
    assert used == set(names)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= 1
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    every = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(every) == len(set(every))
    for w in b["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert any("mfu" in m["name"] for m in cell.per_layer)


def test_config_files_hold_the_configurations_as_run():
    """Each file's ``model`` is the published config where ``reduced``
    does not name the key, and the port's registry config where the
    published config has no such key."""
    from repro_torch.configs.registry import get_config
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in b["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["source"] == entry["source"]
        pub, model = cfg["published"], cfg["model"]
        for key, field in cfg["field_of"].items():
            same = model[field] == pub[key]
            assert same != (key in cfg["reduced"]), (entry["name"], key)
        fields = {cfg["field_of"][k] for k in cfg["reduced"]}
        base = get_config(cfg["arch"])
        for field, val in model.items():
            if field not in fields:
                assert getattr(base, field) == val, (entry["name"], field)
