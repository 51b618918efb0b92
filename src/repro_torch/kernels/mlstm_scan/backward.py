"""Wrapper of the hand-written CUDA backward of the chunkwise mLSTM.

``csrc/mlstm_scan_bwd.cu`` computes dq, dk, dv, d log_i and d log_f of
the forward in ``csrc/mlstm_scan.cu`` from q, k, v, the gates, the
forward's output and its row stats ``(L, sg)`` (written by the same
forward launch, ``kernel.mlstm_cuda(with_stats=True)``: no pass recomputes
them), and the incoming gradient.  Every call starts with F =
cumsum(log_f) and ends with d log_f's reverse cumulative sum of the
differences of dlogw's row and column sums; :func:`plan` picks what runs
between:

- ``"wgmma"``: bf16 at head dim 512 (xlstm-350m), on the tensor cores
  (``csrc/mlstm_bwd_wgmma.cuh``): a pass that writes delta and the gates'
  exp2 terms as padded planes, then dK/dV with the column sums (d log_i)
  over blocks of 64 keys and one half of the head dim, and dQ with its
  row sums over blocks of 64 rows, each block's two warpgroups splitting
  the products by role;
- ``"simt"``: f32 at every head dim and bf16 at 16, 32 and 64, on the CUDA
  cores: delta, dK/dV over blocks of 16 keys, dQ over query tiles.

Every sum has a fixed order and no data goes through an atomic, so two
runs give the same bits.  It has no Pallas counterpart: the JAX package
differentiates its plain ``mlstm_parallel``, and the port's forward on
the card is a kernel, so its gradient is one too (``ops.MlstmFn``).

It takes CUDA tensors only: it validates shapes, device, dtype, the
head-dim stride and, for the tensor-core variant, 16-byte alignment (it
raises, never copies an operand), allocates the gradients and the f32
scratch, launches on PyTorch's current stream and raises if a launch was
refused.  Its plain version is ``ref.mlstm_bwd_ref`` (the tensor-core
variant's arithmetic: ``ref.mlstm_bwd_split_ref``); the library is built
with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import check_tma_aligned, load_cuda_library
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan_bwd.cu"

#: calls since process start (or since a caller reset it), one a call
#: however many device kernels it launches
LAUNCHES = {"mlstm_bwd": 0}

#: the variants, and the calls that took each (counted as LAUNCHES)
VARIANTS = ("wgmma", "simt")
VARIANT_CALLS = {name: 0 for name in VARIANTS}

#: head dims of the tensor-core variant (bf16)
TC_HEAD_DIMS = (512,)
#: keys of a tensor-core dK/dV block and rows of a dQ block; the row
#: padding of its planes
BLOCK = 64


def plan(b: int, s: int, h: int, d: int, dtype) -> str:
    """The variant a call takes: ``"wgmma"`` for bf16 at a head dim in
    ``TC_HEAD_DIMS``, ``"simt"`` otherwise (f32 would run the tensor cores
    in TF32).  The shape does not change it: the tensor-core variant's
    grids are ``2 * ceil(s / BLOCK) * b * h`` dK/dV blocks and ``ceil(s /
    BLOCK) * b * h`` dQ blocks."""
    del b, s, h
    return "wgmma" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS \
        else "simt"


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points with their signatures declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    lib = load_cuda_library(str(SOURCE))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    simt = lib.mlstm_bwd_launch
    simt.argtypes = [p] * 17 + [i, i] + [ll] * 18 + [f, p]
    wgmma = lib.mlstm_bwd_wgmma_launch
    wgmma.argtypes = [p] * 17 + [ll] * 19 + [f, p]
    for fn in (simt, wgmma):
        fn.restype = ctypes.c_int
    return {"simt": simt, "wgmma": wgmma}


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launchers()


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
    variant = plan(b, s, h, d, q.dtype)
    if variant == "wgmma":
        check_tma_aligned("the tensor-core backward", q=q, k=k, v=v,
                          dout=dout)
    lf, li = log_f.contiguous(), log_i.contiguous()
    # F, delta (the CUDA-core variant's) and the row sums
    scratch = torch.empty((3, b, s, h), dtype=torch.float32, device=dev)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    dli = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dlf = torch.empty_like(dli)
    strides = [st for x in (q, k, v, out, dout) for st in x.stride()[:3]]
    launch = _launchers()[variant]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant == "simt":
            rc = launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lf.data_ptr(), scratch[0].data_ptr(),
                li.data_ptr(), lse.data_ptr(), sg.data_ptr(),
                scratch[1].data_ptr(), scratch[2].data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
                dlf.data_ptr(), ml_kernel.DTYPE_CODES[q.dtype], d, b, s, h,
                *strides, float(d ** -0.5), stream)
        else:
            sp = math.ceil(s / BLOCK) * BLOCK
            planes = torch.empty((3, b * h, sp), dtype=torch.float32,
                                 device=dev)
            rc = launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lf.data_ptr(), scratch[0].data_ptr(),
                li.data_ptr(), lse.data_ptr(), sg.data_ptr(),
                scratch[2].data_ptr(), planes.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
                dlf.data_ptr(), b, s, h, sp, *strides,
                float(math.log2(d ** -0.5)), stream)
    if rc != 0:
        what = (f"TMA descriptor encoding failed (code {rc})" if rc < 0
                else f"CUDA error {rc}")
        raise RuntimeError(f"mlstm backward {variant} kernel launch failed: "
                           f"{what} (q {tuple(q.shape)}, {q.dtype})")
    LAUNCHES["mlstm_bwd"] += 1
    VARIANT_CALLS[variant] += 1
    return dq, dk, dv, dli, dlf
