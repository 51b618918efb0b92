"""Wrapper of the hand-written CUDA RG-LRU scan kernel.

``csrc/rglru_scan.cu`` replaces the JAX package's Pallas
``rglru_scan_pallas`` (``src/repro/kernels/rglru_scan/kernel.py``).  The
wrapper takes CUDA tensors only: it validates shapes, device, dtype and
contiguity, allocates the output, launches on PyTorch's current stream
and raises if the launch was refused.  It never falls back to the plain
version; ``ops.py`` picks the plain version for CPU tensors.  The library
is built with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import load_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

#: launches since process start (or since a caller reset it): shows that a
#: run went through the kernel
LAUNCHES = {"rglru_scan": 0}


def validate(a, b, h0=None) -> None:
    """Shape validation shared by every entry point (CPU or CUDA)."""
    if a.dim() != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"rglru_scan expects a and b of one shape (B,S,W); "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    if min(a.shape) == 0:
        raise ValueError(f"rglru_scan got a zero-sized operand: "
                         f"{tuple(a.shape)}")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 {tuple(h0.shape)} must be (B,W) = "
                         f"{(a.shape[0], a.shape[2])}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    fn = load_cuda_library(str(SOURCE)).rglru_scan_launch
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, ll, ll, ll, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def rglru_scan_cuda(a, b, h0=None):
    """``h_t = a_t h_{t-1} + b_t`` on the card: a, b (B,S,W) and h0 (B,W)
    (None: zeros), contiguous float32 CUDA tensors on one device.  Returns
    (h (B,S,W) float32, h_last (B,W), a view of h), still being computed
    on the current stream."""
    validate(a, b, h0)
    ops = (("a", a), ("b", b)) + ((("h0", h0),) if h0 is not None else ())
    for name, x in ops:
        if x.device.type != "cuda":
            raise ValueError(
                f"the rglru_scan CUDA kernel takes CUDA tensors, got {name} "
                f"on {x.device} (CPU tensors go through ops.py to the plain "
                f"version)")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"rglru_scan takes float32, got {name} "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{x.stride()}")
    bsz, s, w = a.shape
    if bsz > 65535:
        raise ValueError(f"at most 65535 batch rows per launch, got {bsz}")
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = _launcher()(
            a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h.data_ptr(),
            bsz, s, w, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc} (a {tuple(a.shape)})")
    LAUNCHES["rglru_scan"] += 1
    return h, h[:, -1]
