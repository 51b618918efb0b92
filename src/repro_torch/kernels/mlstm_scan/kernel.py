"""Wrapper of the hand-written CUDA chunkwise-mLSTM kernel.

``csrc/mlstm_scan.cu`` replaces the JAX package's Pallas
``mlstm_pallas`` (``src/repro/kernels/mlstm_scan/kernel.py``).  As the
Pallas wrapper does, this wrapper forms ``F = cumsum(log_f)`` over the
sequence in f32 before the launch.  It takes CUDA tensors only: it
validates shapes, device, dtype and the head-dim stride, allocates the
output, launches on PyTorch's current stream and raises if the launch was
refused.  It never falls back to the plain version; ``ops.py`` picks the
plain version for CPU tensors.  The library is built with nvcc at first
launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import load_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan.cu"

#: launches since process start (or since a caller reset it): shows that a
#: run went through the kernel
LAUNCHES = {"mlstm": 0}

#: head dims the kernel is instantiated for, and its dtype codes
HEAD_DIMS = (16, 32, 64, 512)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def validate(q, k, v, log_i, log_f) -> None:
    """Shape validation shared by every entry point (CPU or CUDA)."""
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"mlstm expects q, k, v of one shape (B,S,H,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if tuple(log_i.shape) != tuple(q.shape[:3]) or \
            tuple(log_f.shape) != tuple(q.shape[:3]):
        raise ValueError(f"log_i {tuple(log_i.shape)} and log_f "
                         f"{tuple(log_f.shape)} must be (B,S,H) = "
                         f"{tuple(q.shape[:3])}")
    if min(q.shape) == 0:
        raise ValueError(f"mlstm got a zero-sized operand: q "
                         f"{tuple(q.shape)}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    fn = load_cuda_library(str(SOURCE)).mlstm_launch
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, i, i] + [ll] * 14 + [f, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def _check_operands(q, k, v, log_i, log_f) -> None:
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("log_i", log_i),
                    ("log_f", log_f)):
        if x.device.type != "cuda":
            raise ValueError(
                f"the mlstm CUDA kernel takes CUDA tensors, got {name} on "
                f"{x.device} (CPU tensors go through ops.py to the plain "
                f"version)")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"mlstm takes float32 or bfloat16 q, k, v, got "
                         f"{q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    for name, x in (("log_i", log_i), ("log_f", log_f)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
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


def mlstm_cuda(q, k, v, log_i, log_f):
    """Chunkwise mLSTM on the card: q, k, v (B,S,H,D) float32 or bfloat16
    with a contiguous head dim in ``HEAD_DIMS``, log_i/log_f (B,S,H)
    float32, CUDA tensors on one device.  Returns a contiguous (B,S,H,D)
    in q's dtype, still being computed on the current stream."""
    validate(q, k, v, log_i, log_f)
    _check_operands(q, k, v, log_i, log_f)
    b, s, h, d = q.shape
    fcum = torch.cumsum(log_f, dim=1).contiguous()
    li = log_i.contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), fcum.data_ptr(),
            li.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], d, b, s, h,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            fcum.stride(0), fcum.stride(1), float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: CUDA error {rc} "
                           f"(q {tuple(q.shape)}, {q.dtype})")
    LAUNCHES["mlstm"] += 1
    return out
