"""What the benchmark may import: nothing of JAX or of the JAX package
(``repro``) anywhere under ``portbench/``, and nothing of the program
(``repro_torch``) in the reference.  Top-level module names are compared
whole: ``repro_torch`` begins with ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports, anywhere in it
    (``from . import x`` counts as its own package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(folder: Path) -> list:
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


def test_nothing_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): imported(p) & FORBIDDEN
             for p in sources(BENCH)}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in sources(BENCH / "reference"):
        assert not imported(p) & (FORBIDDEN | {"repro_torch"}), p


def test_top_level_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom jax import numpy\n"
                   "import reprox\n")
    assert imported(src) & FORBIDDEN == {"jax"}


def test_a_run_loads_no_jax(tiny_root):
    """A whole run of a tiny cell on the CPU, in a process of its own:
    no module whose top-level name is forbidden is loaded at its end."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(tiny_root)!r}, {str(BENCH.parent / 'src')!r}]\n"
        "from portbench import harness\n"
        f"cell = harness.load_cell({str(tiny_root)!r}, 'qwen.train')\n"
        "harness.run(cell, seed=3, seconds=0.2, trace=False, device='cpu',"
        " t0=time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN
