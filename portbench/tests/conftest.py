"""Shared set-up of the benchmark's own tests: a checkout root in a
temporary directory that holds a copy of the benchmark and tiny cells of
its configurations, which run on the CPU.

Run from the root of the repository:
``PYTHONPATH=src python -m pytest -q portbench/tests``."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the tiny models: name -> (config file it shrinks, model numbers).
#: The train cells run them in float32: at these widths (weights of
#: ~1/sqrt(128)) a bf16 weight's rounding step is as large as an update
#: of lr 3e-4, so bf16 weights would barely move
TINY_MODELS = {
    "glm": ("chatglm3-6b-l18", dict(num_layers=2, d_model=128, num_heads=4,
                                    num_kv_heads=2, head_dim=32, d_ff=256,
                                    vocab_size=512, microbatches=2)),
    "qwen": ("qwen3-14b-l8", dict(num_layers=2, d_model=128, num_heads=5,
                                  num_kv_heads=1, head_dim=32, d_ff=256,
                                  vocab_size=500, microbatches=2,
                                  pad_heads_to=4)),
}
F32 = {"dtype": "float32", "param_dtype": "float32"}
#: each tiny cell: (workload, tiny model, traffic file it shrinks, changes,
#: the committed workload whose limits it is held to)
TINY_CELLS = [
    ("glm.train", "glm-f32", "train-4k",
     {"seq_len": 128}, "chatglm3-6b.train-4k"),
    ("qwen.train", "qwen-f32", "train-4k",
     {"seq_len": 128}, "qwen3-14b.train-4k"),
    ("qwen.prefill", "qwen", "prefill-32k", {"prompt_len": 256},
     "qwen3-14b.prefill-32k"),
]


def make_root(dest: Path) -> Path:
    """A checkout root at ``dest`` with the benchmark's files and the
    tiny cells added as new files and entries; the committed files are
    left as they are."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    models = dict(TINY_MODELS)
    models.update({f"{name}-f32": (base, dict(numbers, **F32))
                   for name, (base, numbers) in TINY_MODELS.items()})
    for tiny, (base, numbers) in models.items():
        cfg = json.loads((REPO / "portbench" / "configs" /
                          f"{base}.json").read_text())
        cfg["model"].update(numbers)
        (dest / "portbench" / "configs" / f"tiny-{tiny}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({
            "name": f"tiny-{tiny}", "source": cfg["source"],
            "file": f"portbench/configs/tiny-{tiny}.json",
            "reduced": [], "why": "a CPU test's size"})
    for name, tiny, traffic, changes, committed in TINY_CELLS:
        t = json.loads((REPO / "portbench" / "traffic" /
                        f"{traffic}.json").read_text())
        t.update(changes)
        (dest / "portbench" / "traffic" / f"tiny-{name}.json").write_text(
            json.dumps(t))
        shutil.copy(REPO / "portbench" / "limits" / f"{committed}.json",
                    dest / "portbench" / "limits" / f"{name}.json")
        bench["workloads"].append({
            "name": name, "config": f"tiny-{tiny}",
            "traffic": f"tiny-{name}", "chips": 1, "why": "a CPU test"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if committed in metric.get("workloads", []):
                metric["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))
