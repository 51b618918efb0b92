"""Wrapper of the hand-written CUDA backward of flash attention.

``csrc/flash_attention_bwd.cu`` computes dq, dk and dv of exactly the
forward in ``csrc/flash_attention.cu`` (GQA, causal with the queries at
the last Sq of Sk, window, softcap, the masked-row guard) from q, k, v,
the forward's output and its per-row lse (written by the same forward
launch, ``kernel.flash_attention_cuda(with_lse=True)``: no pass recomputes
it), and the incoming gradient.  Every call starts with a delta pre-pass
(delta = sum_d dO . O); :func:`plan` then picks one of two variants:

- ``"wgmma"``: bf16 at head dim 64, 128 (every dense config trains at
  128) or 256 (recurrentgemma-9b), on the tensor cores
  (``csrc/flash_bwd_wgmma.cuh``): a dK/dV kernel of one block per
  (``KEY_BLOCK`` keys, batch row, kv head, run of ``splits`` consecutive
  query heads of the group), each run's f32 partials added in run order by
  a sum kernel when there is more than one, then a dQ kernel of one block
  per 128 query rows of a head (64 at head dim 256, where the block's two
  warpgroups split the products by role instead of the rows);
- ``"simt"``: f32 at every head dim and bf16 at 16 and 32, the CUDA-core
  dK/dV and dQ kernels.

Both are deterministic: every sum has a fixed order and no data goes
through an atomic.  It has no Pallas counterpart: the JAX package
differentiates its plain attention with autodiff, and the port's forward
on the card is a kernel, so its gradient is one too
(``ops.FlashAttentionFn``).

The wrapper takes CUDA tensors only: it validates shapes, device, dtype,
the head-dim stride and, for the tensor-core variant, 16-byte alignment
(it raises, never copies), allocates the gradients and the f32 scratch,
launches on PyTorch's current stream and raises if the launch was
refused.  Its plain version is ``ref.flash_attention_bwd_ref``; the
library is built with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import (H100_SMS, check_tma_aligned,
                                 load_cuda_library, sm_count)
from repro_torch.kernels.flash_attention import kernel as fa_kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"

#: calls since process start (or since a caller reset it), one a call
#: however many device kernels it launches
LAUNCHES = {"flash_attention_bwd": 0}

#: the variants, and the calls that took each (counted as LAUNCHES)
VARIANTS = ("wgmma", "simt")
VARIANT_CALLS = {name: 0 for name in VARIANTS}

#: head dims of the tensor-core variant (bf16)
TC_HEAD_DIMS = (64, 128, 256)
#: keys of a tensor-core dK/dV block by head dim: two warpgroups of 64 keys
#: each at 64 and 128, one tile of 64 keys shared by both at 256
KEY_BLOCK = {64: 128, 128: 128, 256: 64}
#: the row padding of the lse and delta planes (a multiple of every dQ
#: block's query rows)
ROW_PAD = 128


@dataclass(frozen=True)
class Plan:
    """The variant of one call, and for ``"wgmma"`` the runs of query
    heads that each kv head's dK/dV blocks are cut into."""
    variant: str
    splits: int


def plan(b: int, sq: int, sk: int, h: int, kh: int, d: int, dtype,
         sms: int = H100_SMS) -> Plan:
    """Which variant a call takes.  bf16 at ``TC_HEAD_DIMS`` takes the
    tensor cores, with the fewest runs of the G = H / K query heads (a
    divisor of G) that give at least one dK/dV block an SM: at
    starcoder2-3b's shape (2, 2048, 32/2 heads of 128) 64 key blocks need
    4 runs of 4 heads, 256 blocks; at recurrentgemma-9b's (1, 2048, 16/1
    heads of 256) 32 key blocks of 64 need 8 runs of 2 heads, 256 blocks.
    Everything else takes the CUDA cores (f32 would run the tensor cores
    in TF32)."""
    if dtype != torch.bfloat16 or d not in TC_HEAD_DIMS:
        return Plan("simt", 1)
    g = h // kh
    blocks = math.ceil(sk / KEY_BLOCK[d]) * b * kh
    splits = next(n for n in range(1, g + 1)
                  if g % n == 0 and (blocks * n >= sms or n == g))
    return Plan("wgmma", splits)


@functools.lru_cache(maxsize=None)
def _launchers():
    """The C entry points with their signatures declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    lib = load_cuda_library(str(SOURCE))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    tail = [f, i, i, ll, i, f, p]     # scale, causal, window, cap, stream
    simt = lib.flash_attention_bwd_launch
    simt.argtypes = [p] * 10 + [i, i] + [ll] * 20 + tail
    wgmma = lib.flash_attention_bwd_wgmma_launch
    wgmma.argtypes = [p] * 12 + [i] + [ll] * 6 + [i] + [ll] * 15 + tail
    for fn in (simt, wgmma):
        fn.restype = ctypes.c_int
    return {"simt": simt, "wgmma": wgmma}


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launchers()


def _check(q, k, v, out, dout, lse) -> None:
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
    b, sq, h, d = q.shape
    if lse.device != dev or lse.dtype != torch.float32 or \
            tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be the forward's contiguous ({b}, {h}, "
                         f"{sq}) float32 on {dev}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
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


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             logit_cap: Optional[float] = None):
    """dq (B,Sq,H,D), dk and dv (B,Sk,K,D) of flash attention on the card,
    contiguous and in the operands' dtype, for ``out`` and ``lse``, the
    forward's output and per-row lse on the same q, k, v and options, and
    ``dout``, the gradient of the loss with respect to ``out``.  Still
    being computed on the current stream when it returns."""
    _check(q, k, v, out, dout, lse)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dev = q.device
    pl = plan(b, sq, sk, h, kh, d, q.dtype, sm_count(dev.index))
    if pl.variant == "wgmma":
        check_tma_aligned("the tensor-core backward", q=q, k=k, v=v,
                          dout=dout)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, kh, d), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    scale = float(scale if scale is not None else d ** -0.5)
    flags = (scale, int(causal), int(window is not None), int(window or 0),
             int(logit_cap is not None), float(logit_cap or 0.0))
    strides = [s for x in (q, k, v, out, dout) for s in x.stride()[:3]]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr())
    launch = _launchers()[pl.variant]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pl.variant == "simt":
            delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
            rc = launch(*ptrs, delta.data_ptr(),
                        fa_kernel.DTYPE_CODES[q.dtype], d, b, sq, sk, h, kh,
                        *strides, *flags, stream)
        else:
            sqp = math.ceil(sq / ROW_PAD) * ROW_PAD
            stats = torch.empty((2, b, h, sqp), dtype=torch.float32,
                                device=dev)
            ws = torch.empty((2, pl.splits, b, sk, kh, d),
                             dtype=torch.float32, device=dev) \
                if pl.splits > 1 else None
            rc = launch(*ptrs, stats[0].data_ptr(), stats[1].data_ptr(),
                        None if ws is None else ws.data_ptr(), d, b, sq, sk,
                        h, kh, sqp, pl.splits, *strides, *flags, stream)
    if rc != 0:
        what = (f"TMA descriptor encoding failed (code {rc})" if rc < 0
                else f"CUDA error {rc}")
        raise RuntimeError(f"flash_attention backward {pl.variant} kernel "
                           f"launch failed: {what} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES["flash_attention_bwd"] += 1
    VARIANT_CALLS[pl.variant] += 1
    return dq, dk, dv
