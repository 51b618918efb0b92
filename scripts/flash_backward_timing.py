"""Times flash attention's backward kernels, apart, at the training shapes
of starcoder2-3b (head dim 128) and recurrentgemma-9b (head dim 256), and
the forward kernel beside them.

    python3 scripts/flash_backward_timing.py [--iters 48]
    python3 scripts/flash_backward_timing.py --src OTHER/src --forward-only

Needs one CUDA card.  Prints one JSON line (with nvidia-smi's name and
power limit) holding, at starcoder2-3b's microbatch (B 2, Sq = Sk = 2048,
32 q heads over 2 kv heads of 128, causal, window 4096, bf16) and at
recurrentgemma-9b's (B 1, Sq = Sk = 2048, 16 q heads over 1 kv head of
256, causal, window 2048, bf16), over 4 seeded operand sets cycled so
that each call finds its inputs cold in L2:

- ``backward[shape]``: ``ms``, device ms a call of
  ``flash_attention_bwd_cuda`` (CUDA graph replay of ``--iters`` calls),
  and ``kernels``, device ms a call of each of its kernels by name (the
  delta pre-pass, dK/dV, the sum of the head runs' partials, dQ), from
  torch.profiler over ``--iters`` calls; ``plan``: its variant and runs;
  ``sdpa_ms``: the backward of scaled_dot_product_attention (enable_gqa,
  is_causal) on the same values, CUDA events around calls;
- ``forward_ms``: the forward kernel at starcoder2-3b's shape and at
  qwen3-14b's prefill (1, 2048², 48/8, 128), without lse (serving) and,
  where the checkout has it, with lse (training).

``--src`` imports the package from another checkout's ``src/`` (the
parent of a change, to compare the forward in one call); with
``--forward-only`` only the forward is timed, which any checkout has."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds this checkout's src/ to the path)

TRAIN_SHAPE = (2, 2048, 2048, 32, 2, 128)
TRAIN_WINDOW = 4096
#: the backward's shapes: (shape, window) by model
BACKWARD_SHAPES = {"starcoder2-3b": (TRAIN_SHAPE, TRAIN_WINDOW),
                   "recurrentgemma-9b": ((1, 2048, 2048, 16, 1, 256), 2048)}
PREFILL_SHAPE = (1, 2048, 2048, 48, 8, 128)
SETS = 4


def operands(gen, b, sq, sk, h, kh, d):
    return [cs.fa_operands(gen, b, sq, sk, h, kh, d, torch.bfloat16)
            for _ in range(SETS)]


def time_backward(gen, shape, window, iters):
    """The backward at one shape: its plan, device ms a call, each of its
    kernels apart, and SDPA's backward on the same values."""
    from repro_torch.kernels.flash_attention import backward as fa_backward
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    kw = {"window": window}
    sets = []
    for q, k, v in operands(gen, *shape):
        out, lse = fa_kernel.flash_attention_cuda(q, k, v, with_lse=True,
                                                  **kw)
        dout = torch.randn(out.shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
        sets.append((q, k, v, out, dout, lse))
    calls = [lambda x=x: fa_backward.flash_attention_bwd_cuda(*x, **kw)
             for x in sets]
    pl = fa_backward.plan(*shape, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_bwd(q, k, v, out, dout, lse):
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        with torch.enable_grad():
            o = sdpa(*leaves, is_causal=True, enable_gqa=True)
        g = dout.transpose(1, 2)
        return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)

    return {"shape": list(shape), "window": window,
            "plan": {"variant": pl.variant, "splits": pl.splits},
            "ms": cs.device_time_ms(calls, iters),
            "kernels": cs.kernel_ms(calls, iters),
            "sdpa_ms": cs.call_time_ms([sdpa_bwd(*x) for x in sets], iters)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ whose package is timed (default: this "
                         "checkout's)")
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--iters", type=int, default=48)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_backward_timing: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    has_lse = "with_lse" in fa_kernel.flash_attention_cuda.__code__\
        .co_varnames
    row = {"src": args.src, "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0), "iters": args.iters,
           "forward_ms": {}}
    for name, shape, kw in (("train", TRAIN_SHAPE, {"window": TRAIN_WINDOW}),
                            ("qwen3_prefill", PREFILL_SHAPE, {})):
        sets = operands(gen, *shape)
        row["forward_ms"][name] = {"plain_call": cs.device_time_ms(
            [lambda x=x: fa_kernel.flash_attention_cuda(*x, **kw)
             for x in sets], args.iters)}
        if has_lse:
            row["forward_ms"][name]["with_lse"] = cs.device_time_ms(
                [lambda x=x: fa_kernel.flash_attention_cuda(
                    *x, with_lse=True, **kw) for x in sets], args.iters)
        del sets
    if not args.forward_only:
        row["backward"] = {name: time_backward(gen, shape, window,
                                               args.iters)
                           for name, (shape, window)
                           in BACKWARD_SHAPES.items()}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
