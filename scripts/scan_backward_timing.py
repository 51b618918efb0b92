"""Times the RG-LRU and mLSTM backward kernels at their training shapes,
each of their device kernels apart, and the mLSTM forward beside them.

    python3 scripts/scan_backward_timing.py [--iters 48]
    python3 scripts/scan_backward_timing.py --src OTHER/src --forward-only

Needs one CUDA card.  Prints one JSON line (with nvidia-smi's name and
power limit) holding, over 4 seeded operand sets cycled so that each call
finds its inputs cold in L2:

- ``forward_ms``: device ms a call (CUDA graph replay of ``--iters``
  calls) of the mLSTM forward at xlstm-350m's serving forward (1, 2048,
  4, 512) and training microbatch (2, 2048, 4, 512), bf16, without row
  stats (serving) and, where the checkout has them, with (training);
- ``mlstm_bwd_ms``: device ms a call of ``mlstm_bwd_cuda`` at (2, 2048,
  4, 512) bf16 (``mlstm_bwd_variant``: the tensor-core variant since it
  exists, the CUDA cores before), and ``mlstm_bwd_kernels``: device ms a
  call of each of its kernels by name (F's cumulative sum, the pre-pass,
  dK/dV, dQ, the reverse cumulative sum), from torch.profiler over
  ``--iters`` calls (``mlstm_bwd_kernel_counts``: the launches it
  recorded of each);
- ``rglru_bwd_ms``: device ms a call of ``rglru_scan_bwd_cuda`` at
  recurrentgemma-9b's training microbatch (1, 2048, 4096) f32, beside the
  forward kernel at the same shape (``rglru_fwd_ms``).

``--src`` imports the package from another checkout's ``src/`` (the
parent of a change; ``module`` in the line says which was imported): run
the script on the parent and on the change in one call (parent, change,
change, parent) to compare them on one card.  With ``--forward-only``
only the mLSTM forward is timed, which any checkout has."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds this checkout's src/ to the path)

SERVE_SHAPE = (1, 2048, 4, 512)
TRAIN_SHAPE = (2, 2048, 4, 512)
SCAN_SHAPE = (1, 2048, 4096)
SETS = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ whose package is timed (default: this "
                         "checkout's)")
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--iters", type=int, default=48)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_backward_timing: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    has_stats = "with_stats" in ml_kernel.mlstm_cuda.__code__.co_varnames
    row = {"src": args.src, "module": ml_kernel.__file__,
           "nvidia_smi": cs.nvidia_smi_line(),
           "device": torch.cuda.get_device_name(0), "iters": args.iters,
           "forward_ms": {}}
    for name, shape in (("serve", SERVE_SHAPE), ("train", TRAIN_SHAPE)):
        sets = [cs.mlstm_operands(gen, *shape, torch.bfloat16)
                for _ in range(SETS)]
        row["forward_ms"][name] = {"no_stats": cs.device_time_ms(
            [lambda x=x: ml_kernel.mlstm_cuda(*x) for x in sets],
            args.iters)}
        if has_stats:
            row["forward_ms"][name]["with_stats"] = cs.device_time_ms(
                [lambda x=x: ml_kernel.mlstm_cuda(*x, with_stats=True)
                 for x in sets], args.iters)
        del sets
    if not args.forward_only:
        from repro_torch.kernels.mlstm_scan import backward as ml_backward
        from repro_torch.kernels.rglru_scan import backward as rg_backward
        from repro_torch.kernels.rglru_scan import kernel as rg_kernel
        sets = []
        for _ in range(SETS):
            ops = cs.mlstm_operands(gen, *TRAIN_SHAPE, torch.bfloat16)
            out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
            dout = torch.randn(out.shape, generator=gen,
                               device="cuda").to(torch.bfloat16)
            sets.append((*ops, out, dout, lse, sg))
        calls = [lambda x=x: ml_backward.mlstm_bwd_cuda(*x) for x in sets]
        row["mlstm_bwd_variant"] = ml_backward.plan(
            *TRAIN_SHAPE, torch.bfloat16) if hasattr(ml_backward, "plan") \
            else "simt"
        row["mlstm_bwd_ms"] = cs.device_time_ms(calls, args.iters)
        row["mlstm_bwd_kernel_counts"] = {}
        row["mlstm_bwd_kernels"] = cs.kernel_ms(
            calls, args.iters, row["mlstm_bwd_kernel_counts"])
        del sets, calls
        scans = []
        for _ in range(SETS):
            a, x, _ = cs.scan_operands(gen, *SCAN_SHAPE, False)
            h, _ = rg_kernel.rglru_scan_cuda(a, x)
            scans.append((a, x, h, torch.randn(h.shape, generator=gen,
                                               device="cuda")))
        row["rglru_fwd_ms"] = cs.device_time_ms(
            [lambda s=s: rg_kernel.rglru_scan_cuda(s[0], s[1])
             for s in scans], args.iters)
        row["rglru_bwd_ms"] = cs.device_time_ms(
            [lambda s=s: rg_backward.rglru_scan_bwd_cuda(s[0], s[2], s[3])
             for s in scans], args.iters)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
