"""Wrapper of the hand-written CUDA flash-attention kernel.

``csrc/flash_attention.cu`` replaces the JAX package's Pallas
``flash_attention`` (``src/repro/kernels/flash_attention/kernel.py``).
The wrapper takes CUDA tensors only: it validates shapes, device, dtype
and the head-dim stride, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused.  It never falls back
to the plain version; ``ops.py`` picks the plain version for CPU tensors.
The library is built with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import load_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: launches since process start (or since a caller reset it): shows that a
#: run went through the kernel
LAUNCHES = {"flash_attention": 0}

#: head dims the kernel is instantiated for, and its dtype codes
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def validate(q, k, v) -> None:
    """Shape validation shared by every entry point (CPU or CUDA)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention expects q (B,Sq,H,D), k/v (B,Sk,K,D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B,Sk,K,D) "
            f"for q {tuple(q.shape)}")
    sk, kh = k.shape[1], k.shape[2]
    if min(b, sq, h, d, sk, kh) == 0:
        raise ValueError(f"flash_attention got a zero-sized operand: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    fn = load_cuda_library(str(SOURCE)).flash_attention_launch
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i] + [ll] * 14 + [f, i, i, ll, i, f, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def _check_operands(q, k, v) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"the flash_attention CUDA kernel takes CUDA tensors, got a "
            f"tensor on {dev} (CPU tensors go through ops.py to the plain "
            f"version)")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance "
                         f"(instances: {HEAD_DIMS})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim, got "
                             f"strides {x.stride()}")
    if q.shape[2] > 65535 or q.shape[0] > 65535:
        raise ValueError(f"at most 65535 heads and batch rows per launch, "
                         f"got q {tuple(q.shape)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         logit_cap: Optional[float] = None):
    """Flash attention on the card: q (B,Sq,H,D), k/v (B,Sk,K,D), float32
    or bfloat16 CUDA tensors on one device, head dim in ``HEAD_DIMS`` and
    contiguous.  Returns a contiguous (B,Sq,H,D) in q's dtype, still being
    computed on the current stream."""
    validate(q, k, v)
    _check_operands(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], d, b, sq, sk, h, kh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale if scale is not None else d ** -0.5), int(causal),
            int(window is not None), int(window or 0),
            int(logit_cap is not None), float(logit_cap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return out
