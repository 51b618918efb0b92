"""Wrapper of the hand-written CUDA backward of the chunkwise mLSTM.

``csrc/mlstm_scan_bwd.cu`` computes dq, dk, dv, d log_i and d log_f of
the forward in ``csrc/mlstm_scan.cu`` from q, k, v, the gates, the
forward's output and its row stats ``(L, sg)`` (written by the same
forward launch, ``kernel.mlstm_cuda(with_stats=True)``: no pass recomputes
them), and the incoming gradient, on the CUDA cores in five launches:
F = cumsum(log_f), a pre-pass (delta), dK/dV with the column sums of
dlogw (d log_i) over blocks of 16 keys, dQ with its row sums over query
tiles, then d log_f's reverse cumulative sum of their differences.  Every sum has a fixed order and no data
goes through an atomic, so two runs give the same bits.  It has no
Pallas counterpart: the JAX package differentiates its plain
``mlstm_parallel``, and the port's forward on the card is a kernel, so its
gradient is one too (``ops.MlstmFn``).

It takes CUDA tensors only: it validates
shapes, device, dtype and the head-dim stride (it raises, never copies an
operand), allocates the gradients and the f32 scratch, launches on
PyTorch's current stream and raises if a launch was refused.  Its plain
version is ``ref.mlstm_bwd_ref``; the library is built with nvcc at first
launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import load_cuda_library
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan_bwd.cu"

#: calls since process start (or since a caller reset it), one a call
#: however many device kernels it launches
LAUNCHES = {"mlstm_bwd": 0}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    fn = load_cuda_library(str(SOURCE)).mlstm_bwd_launch
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p] * 17 + [i, i] + [ll] * 18 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def mlstm_bwd_cuda(q, k, v, log_i, log_f, out, dout, lse, sg):
    """dq, dk, dv (B,S,H,D) contiguous in q's dtype and d log_i, d log_f
    (B,S,H) float32 of the chunkwise mLSTM on the card, for ``out`` and
    ``(lse, sg)``, the forward's output and row stats on the same q, k, v,
    log_i, log_f, and ``dout``, the gradient of the loss with respect to
    ``out``.  Still being computed on the current stream when it
    returns."""
    ml_kernel.validate(q, k, v, log_i, log_f)
    ml_kernel._check_operands(q, k, v, log_i, log_f)
    dev = q.device
    for name, x in (("out", out), ("dout", dout)):
        if x.device != dev or x.dtype != q.dtype or \
                tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} must be a {tuple(q.shape)} {q.dtype} "
                             f"tensor on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous head dim, got "
                             f"strides {x.stride()}")
    b, s, h, d = q.shape
    for name, x in (("lse", lse), ("sg", sg)):
        if x.device != dev or x.dtype != torch.float32 or \
                tuple(x.shape) != (b, s, h) or not x.is_contiguous():
            raise ValueError(f"{name} must be the forward's contiguous ({b}, "
                             f"{s}, {h}) float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    lf, li = log_f.contiguous(), log_i.contiguous()
    scratch = torch.empty((3, b, s, h), dtype=torch.float32, device=dev)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    dli = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dlf = torch.empty_like(dli)
    strides = [st for x in (q, k, v, out, dout) for st in x.stride()[:3]]
    with torch.cuda.device(dev):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lf.data_ptr(), scratch[0].data_ptr(),
            li.data_ptr(), lse.data_ptr(), sg.data_ptr(),
            scratch[1].data_ptr(), scratch[2].data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
            dlf.data_ptr(), ml_kernel.DTYPE_CODES[q.dtype], d, b, s, h,
            *strides, float(d ** -0.5),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm backward kernel launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, {q.dtype})")
    LAUNCHES["mlstm_bwd"] += 1
    return dq, dk, dv, dli, dlf
