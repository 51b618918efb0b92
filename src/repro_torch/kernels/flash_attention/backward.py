"""Wrapper of the hand-written CUDA backward of flash attention.

``csrc/flash_attention_bwd.cu`` computes dq, dk and dv of exactly the
forward in ``csrc/flash_attention.cu`` (GQA, causal with the queries at
the last Sq of Sk, window, softcap, the masked-row guard) with three
device kernels on one stream: row statistics (lse and delta), dK/dV (one
block per key tile of a kv head, summing the group's query heads in
order) and dQ.  It has no Pallas counterpart: the JAX package
differentiates its plain attention with autodiff, and the port's forward
on the card is a kernel, so its gradient is one too
(``ops.FlashAttentionFn``).

The wrapper takes CUDA tensors only: it validates shapes, device, dtype
and the head-dim stride (it raises, never copies), allocates the
gradients and the (B, H, Sq) f32 scratch, launches on PyTorch's current
stream and raises if the launch was refused.  Its plain version is
``ref.flash_attention_bwd_ref``; the library is built with nvcc at first
launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import load_cuda_library
from repro_torch.kernels.flash_attention import kernel as fa_kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"

#: calls since process start (or since a caller reset it), one a call
#: (each launches the three device kernels)
LAUNCHES = {"flash_attention_bwd": 0}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    lib = load_cuda_library(str(SOURCE))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [p] * 10 + [i, i] + [ll] * 20 + [f, i, i, ll, i, f, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def _check(q, k, v, out, dout) -> None:
    fa_kernel.validate(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"the flash_attention backward CUDA kernel takes CUDA tensors, "
            f"got a tensor on {dev} (CPU tensors are differentiated through "
            f"the plain version)")
    if q.dtype not in fa_kernel.DTYPE_CODES:
        raise ValueError(f"flash_attention backward takes float32 or "
                         f"bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    for name, x in (("out", out), ("dout", dout)):
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} {tuple(x.shape)} must have q's shape "
                             f"{tuple(q.shape)}")
    d = q.shape[3]
    if d not in fa_kernel.HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance "
                         f"(instances: {fa_kernel.HEAD_DIMS})")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim, got "
                             f"strides {x.stride()}")
    if q.shape[2] > 65535 or q.shape[0] > 65535:
        raise ValueError(f"at most 65535 heads and batch rows per launch, "
                         f"got q {tuple(q.shape)}")


def flash_attention_bwd_cuda(q, k, v, out, dout, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             logit_cap: Optional[float] = None):
    """dq (B,Sq,H,D), dk and dv (B,Sk,K,D) of flash attention on the card,
    contiguous and in the operands' dtype, for ``out``, the forward's
    output on the same q, k, v and options, and ``dout``, the gradient of
    the loss with respect to it.  Still being computed on the current
    stream when it returns."""
    _check(q, k, v, out, dout)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dev = q.device
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, kh, d), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    scale = float(scale if scale is not None else d ** -0.5)
    strides = [s for x in (q, k, v, out, dout) for s in x.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), fa_kernel.DTYPE_CODES[q.dtype],
            d, b, sq, sk, h, kh, *strides, scale, int(causal),
            int(window is not None), int(window or 0),
            int(logit_cap is not None), float(logit_cap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
