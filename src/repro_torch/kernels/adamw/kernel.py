"""Wrappers of the hand-written CUDA AdamW passes.

``csrc/adamw.cu`` holds the optimizer's two passes (no Pallas kernel is
replaced: the JAX package's AdamW is plain ``jnp``):

- the norm: one launch a leaf sums the gradient's squares in f64, a
  double a block into a scratch buffer (``adamw_sumsq_kernel``), then one
  single-block launch sums those in index order, takes the root, rounds it
  to f32 and makes the clip factor (``adamw_norm_final_kernel``);
- the update: one launch a leaf reads p, g, m and v once and writes p, m
  and v once (``adamw_update_kernel``), reading the clip factor, the bias
  corrections and the learning rate from 0-dim device tensors.

The update's instance follows the dtypes of the tensors it is given: p
bf16 or f32, g f32 or bf16 (grok-1's bf16 sum), m and v f32 or bf16
(grok-1's bf16 moments).  :func:`validate` raises on any other dtype, on
sizes that differ, on a non-contiguous leaf and on leaves of several
devices, before any launch; the wrappers never fall back to the plain
version (``optim/adamw.py`` takes it for CPU and ``meta`` tensors).  Each
launch goes on PyTorch's current stream without a synchronize, and raises
if it was refused.  :func:`norm_calls` and :func:`update_calls` are the
calls a step makes, which the dry run sets against the card's
(``launch/dryrun.OpTrace.fused``).  The library is built with nvcc at
first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import dtype_name, load_cuda_library, sms_of

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"

#: launches since process start (or since a caller reset it): the norm's
#: (one a leaf and the final sum) and the update's (one a leaf)
LAUNCHES = {"adamw_norm": 0, "adamw_update": 0}

#: threads a block of either pass (the kernels' kThreads), elements a
#: thread takes a step (kVec), and blocks an SM at most
THREADS = 256
VEC = 8
BLOCKS_PER_SM = 4

#: the dtypes each operand may take, and their codes in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def blocks(n: int, sms: int) -> int:
    """Blocks of a pass over ``n`` elements: enough for one step of VEC
    elements a thread, at most BLOCKS_PER_SM an SM (the rest is the grid
    stride).  A fixed function of ``n`` and the SMs, so the norm's sum
    order, and its bits, repeat."""
    return max(1, min(-(-n // (THREADS * VEC)), sms * BLOCKS_PER_SM))


def _check(what: str, x: torch.Tensor, device) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"AdamW's kernels take float32 or bfloat16, got "
                         f"{what} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous, got strides "
                         f"{x.stride()}")
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, the first leaf on "
                         f"{device}")


def validate_grads(grads) -> None:
    """The norm's operands: each gradient float32 or bfloat16, contiguous,
    all on one device.  Raises ``ValueError`` naming the leaf."""
    if not grads:
        raise ValueError("AdamW's norm got no leaves")
    for i, g in enumerate(grads):
        _check(f"gradient {i}", g, grads[0].device)


def validate(leaves) -> None:
    """The update's operands, ``(p, g, m, v)`` a leaf: one size a leaf, p
    and g float32 or bfloat16, m and v one of those and one dtype, every
    tensor contiguous and on the first leaf's device.  Raises
    ``ValueError`` naming the leaf before anything launches."""
    if not leaves:
        raise ValueError("AdamW's update got no leaves")
    device = leaves[0][0].device
    for i, leaf in enumerate(leaves):
        if len({x.numel() for x in leaf}) != 1:
            raise ValueError(
                "a parameter, its gradient and its moments differ in size: "
                f"leaf {i}, {[tuple(x.shape) for x in leaf]}")
        for what, x in zip(("p", "g", "m", "v"), leaf):
            _check(f"{what} of leaf {i}", x, device)
        if leaf[2].dtype != leaf[3].dtype:
            raise ValueError(f"m and v of leaf {i} differ in dtype: "
                             f"{leaf[2].dtype}, {leaf[3].dtype}")


def _aligned(*xs) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def norm_calls(grads) -> list:
    """The norm's launches for ``grads`` as (kernel, variant, shape): one
    sum of squares a non-empty leaf, then the final sum over every
    block's partial."""
    validate_grads(grads)
    sms = sms_of(grads[0].device)
    calls, partials = [], 0
    for g in grads:
        n = g.numel()
        if n:
            nb = blocks(n, sms)
            calls.append(("adamw_norm", dtype_name(g.dtype),
                          {"n": n, "blocks": nb, "vec": _aligned(g)}))
            partials += nb
    return calls + [("adamw_norm", "final", {"partials": partials})]


def update_calls(leaves) -> list:
    """The update's launches for ``leaves`` as (kernel, variant, shape):
    one a non-empty leaf, its variant the dtypes of p, g and the
    moments."""
    validate(leaves)
    sms = sms_of(leaves[0][0].device)
    return [("adamw_update", "/".join(dtype_name(x.dtype) for x in leaf[:3]),
             {"n": leaf[0].numel(), "blocks": blocks(leaf[0].numel(), sms),
              "vec": _aligned(*leaf)})
            for leaf in leaves if leaf[0].numel()]


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points with their signatures declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    lib = load_cuda_library(str(SOURCE))
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.adamw_sumsq_launch.argtypes = [p, i, ll, i, i, p, p]
    lib.adamw_norm_final_launch.argtypes = [p, ll, f, p, p, p]
    lib.adamw_update_launch.argtypes = [p, i, p, i, p, p, i, ll, i, i,
                                        p, p, p, p, f, f, f, f, f, f, p]
    for fn in (lib.adamw_sumsq_launch, lib.adamw_norm_final_launch,
               lib.adamw_update_launch):
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _lib()


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"AdamW {what} launch failed: CUDA error {rc}")


def _cuda_device(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"AdamW's kernels take CUDA tensors, got "
                         f"{x.device} (CPU and meta tensors take the plain "
                         f"version in optim/adamw.py)")
    return x.device


def norm_and_clip(grads, grad_clip: float):
    """The global norm of ``grads`` (a list of CUDA tensors, the
    reference's leaf order) and the clip factor ``min(grad_clip /
    max(norm, 1e-9), 1)``, as two 0-dim float32 tensors still being
    computed on the current stream."""
    validate_grads(grads)
    device = _cuda_device(grads[0])
    calls = norm_calls(grads)
    partial = torch.empty(calls[-1][2]["partials"], dtype=torch.float64,
                          device=device)
    gnorm = torch.empty((), dtype=torch.float32, device=device)
    clip = torch.empty((), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        at = 0
        for g, (_, _, shape) in zip((g for g in grads if g.numel()), calls):
            _raise_if(lib.adamw_sumsq_launch(
                g.data_ptr(), DTYPES[g.dtype], shape["n"], shape["blocks"],
                int(shape["vec"]), partial.data_ptr() + 8 * at, stream),
                "norm")
            LAUNCHES["adamw_norm"] += 1
            at += shape["blocks"]
        _raise_if(lib.adamw_norm_final_launch(
            partial.data_ptr(), at, grad_clip, gnorm.data_ptr(),
            clip.data_ptr(), stream), "norm")
        LAUNCHES["adamw_norm"] += 1
    return gnorm, clip


def update(leaves, clip, c1, c2, lr, opt) -> None:
    """AdamW's update of ``leaves`` (``(p, g, m, v)`` a leaf, CUDA
    tensors) in place, with ``clip``, ``c1``, ``c2`` and ``lr`` 0-dim
    float32 tensors on the same device and ``opt``'s b1, b2, eps and
    weight decay; launched on the current stream."""
    validate(leaves)
    device = _cuda_device(leaves[0][0])
    calls = update_calls(leaves)
    for name, x in (("clip", clip), ("c1", c1), ("c2", c2), ("lr", lr)):
        if x.dim() != 0 or x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{name} must be a 0-dim float32 tensor on "
                             f"{device}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
    # each Python float rounded to f32 once, as the eager ops' scalars:
    # (1 - b1) in double first
    coef = (opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2, opt.eps,
            opt.weight_decay)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for (p, g, m, v), (_, _, shape) in zip(
                (leaf for leaf in leaves if leaf[0].numel()), calls):
            _raise_if(lib.adamw_update_launch(
                p.data_ptr(), DTYPES[p.dtype], g.data_ptr(), DTYPES[g.dtype],
                m.data_ptr(), v.data_ptr(), DTYPES[m.dtype], shape["n"],
                shape["blocks"], int(shape["vec"]), clip.data_ptr(),
                c1.data_ptr(), c2.data_ptr(), lr.data_ptr(), *coef, stream),
                "update")
            LAUNCHES["adamw_update"] += 1


def launches() -> int:
    """Launches of both passes since process start."""
    return sum(LAUNCHES.values())
