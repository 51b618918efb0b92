"""Times the mLSTM tensor-core backward with parts of its work taken out,
to see which part holds it: its stage loads, its S and dP products, or
neither of them (what is left: the P and dS products, the elementwise
work and the two roles' barriers).

    python3 scripts/mlstm_bwd_ablation.py [--iters 32]

Needs one CUDA card.  Each variant is a copy of this checkout's ``src/``
under ``build/mlstm_bwd_ablation/<variant>/`` whose
``csrc/mlstm_scan_bwd.cu`` starts with the variant's diagnosis switches
(``csrc/mlstm_bwd_wgmma.cuh`` describes them), timed by
``scripts/scan_backward_timing.py --src`` in its own process (each copy
builds its own library).  The variants' gradients are wrong by design:
only their times mean something.

- ``full``: the kernels as they are;
- ``no_stage_loads``: ``MLSTM_BWD_SKIP_STAGE_LOADS``, after the first two
  stages of the ring a stage's barrier is completed with no copy (the
  products read the stale stage);
- ``no_small_products``: ``MLSTM_BWD_SKIP_SMALL_PRODUCTS``, the m64n16k16
  products of S, S^T, dP and dP^T are not issued (their accumulators are
  zeros);
- ``neither``: both.

Prints one JSON line: nvidia-smi's name and power limit, and for each
variant the device ms a call of the backward at (2, 2048, 4, 512) bf16
and of each of its kernels."""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its kernels' names)

SOURCE = Path("repro_torch/kernels/mlstm_scan/csrc/mlstm_scan_bwd.cu")

#: the switches each variant sets
SWITCHES = {"full": (),
            "no_stage_loads": ("MLSTM_BWD_SKIP_STAGE_LOADS",),
            "no_small_products": ("MLSTM_BWD_SKIP_SMALL_PRODUCTS",),
            "neither": ("MLSTM_BWD_SKIP_STAGE_LOADS",
                        "MLSTM_BWD_SKIP_SMALL_PRODUCTS")}


def variant_src(name: str) -> Path:
    """A copy of ``src/`` with ``name``'s switches set; returns its path."""
    dst = ROOT / "build" / "mlstm_bwd_ablation" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    source = dst / "src" / SOURCE
    source.write_text("".join(f"#define {switch} 1\n"
                              for switch in SWITCHES[name]) +
                      source.read_text())
    return dst / "src"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    row = {"variants": {}}
    for name in SWITCHES:
        timing = ROOT / "scripts" / "scan_backward_timing.py"
        out = subprocess.run(
            [sys.executable, str(timing), "--src", str(variant_src(name)),
             "--iters", str(args.iters)],
            capture_output=True, text=True, check=True).stdout
        line = json.loads(out.strip().splitlines()[-1])
        row["nvidia_smi"] = line["nvidia_smi"]
        row["variants"][name] = {
            "ms": line["mlstm_bwd_ms"],
            "kernels_ms": {short: sum(ms for key, ms in
                                      line["mlstm_bwd_kernels"].items()
                                      if sub in key)
                           for short, sub in cs.MLSTM_BWD_KERNELS.items()}}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
