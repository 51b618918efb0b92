"""Wrapper of the hand-written CUDA backward of the RG-LRU scan.

The gradient of ``h_t = a_t h_{t-1} + b_t`` is the same recurrence run
from the end: ``g_t = dy_t + a_{t+1} g_{t+1}`` from ``g_{S-1} = dy_{S-1} +
dh_last``, then ``db = g``, ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``, or 0)
and ``dh0 = a_0 g_0``.  ``csrc/rglru_scan.cu`` runs it as the forward's
single-pass chunked scan over the reversed sequence (its ``kRev``
instance): the decays read one step ahead, ``dh_last`` as the initial
carry, the carry composed in the forward's fixed order, and ``da`` and
``dh0`` formed in the second pass from the forward's h.  On the card it
equals ``ref.rglru_scan_bwd_chunked_ref`` at the plan's chunk bit for bit.
It has no Pallas counterpart: the JAX package differentiates its plain
associative scan, and the port's forward on the card is a kernel, so its
gradient is one too (``ops.RglruScanFn``).

The wrapper takes CUDA tensors, and ``meta`` tensors for the dry run
(nothing launched): it validates shapes, device, dtype and contiguity,
allocates the gradients and the workspace (filled with all ones, as the
forward's), launches on PyTorch's current stream and raises if the
launch was refused.  The library is the forward's, built
with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels as kernel_pkg
from repro_torch.kernels import load_cuda_library
from repro_torch.kernels.rglru_scan import kernel as scan_kernel

SOURCE = scan_kernel.SOURCE

#: calls since process start (or since a caller reset it): shows that a
#: run went through the kernel
LAUNCHES = {"rglru_scan_bwd": 0}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    fn = load_cuda_library(str(SOURCE)).rglru_scan_bwd_launch
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p] * 9 + [ll, ll, ll, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def rglru_scan_bwd_cuda(a, h, dy, dh_last=None, h0=None):
    """(da, db (B,S,W), dh0 (B,W) or None when h0 is None) of the RG-LRU
    scan on the card: a the forward's decays and h its output, dy the
    gradient of the loss with respect to h and dh_last (None: zeros) with
    respect to h_last, h0 the forward's initial state (None: zeros); all
    contiguous float32 CUDA tensors on one device.  Still being computed
    on the current stream when it returns.  On ``meta`` tensors (the dry
    run) it returns the gradients unwritten, launching nothing."""
    trace = kernel_pkg.TRACE
    if trace is not None:
        trace.begin()
    scan_kernel.validate(a, h)
    scan_kernel.validate(a, dy, dh_last)
    scan_kernel.validate(a, h, h0)
    ops = (("a", a), ("h", h), ("dy", dy), ("dh_last", dh_last),
           ("h0", h0))
    for name, x in ops:
        if x is None:
            continue
        if x.device.type not in ("cuda", "meta"):
            raise ValueError(
                f"the rglru_scan backward CUDA kernel takes CUDA (or meta) "
                f"tensors, got {name} on {x.device} (CPU tensors are "
                f"differentiated through the plain version)")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"rglru_scan backward takes float32, got {name} "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{x.stride()}")
    bsz, s, w = a.shape
    if bsz > 65535:
        raise ValueError(f"at most 65535 batch rows per launch, got {bsz}")
    pl = scan_kernel.plan(bsz, s, w, aligned=a.data_ptr() % 16 == 0 and
                          dy.data_ptr() % 16 == 0)
    db = torch.empty_like(a)
    da = torch.empty_like(a)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    ws = torch.full((pl.ws_words,), -1, dtype=torch.int64, device=a.device)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    if a.device.type == "cuda":
        with torch.cuda.device(a.device):
            rc = _launcher()(
                a.data_ptr(), dy.data_ptr(), ptr(dh_last), h.data_ptr(),
                ptr(h0), db.data_ptr(), da.data_ptr(), ptr(dh0),
                ws.data_ptr(), bsz, s, w, pl.chunk, int(pl.load == "bulk"),
                torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rglru_scan backward kernel launch failed: "
                               f"CUDA error {rc} (a {tuple(a.shape)})")
        LAUNCHES["rglru_scan_bwd"] += 1
    if trace is not None:
        trace.end("rglru_scan_bwd", pl.load, dict(
            b=bsz, s=s, w=w, h0=h0 is not None,
            dh_last=dh_last is not None))
    return da, db, dh0
