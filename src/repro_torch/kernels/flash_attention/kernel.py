"""Wrapper of the hand-written CUDA flash-attention kernels.

``csrc/flash_attention.cu`` replaces the JAX package's Pallas
``flash_attention`` (``src/repro/kernels/flash_attention/kernel.py``) with
three device kernels, one chosen per call by :func:`plan`:

- ``"wgmma"``: prefill in bf16 at head dim 64/128/256 on the tensor cores,
  TMA-fed (``csrc/flash_wgmma.cuh``);
- ``"decode"``: bf16 at those head dims when the G = H / K query heads of
  a kv head times Sq fit one 16-row tile: the heads packed into the rows,
  the keys split over blocks when Sk is long, and a merge pass when there
  is more than one split (``csrc/flash_decode.cuh``);
- ``"simt"``: f32 at every head dim and bf16 at head dim 16/32, the
  CUDA-core kernel (no model path calls it).

A training call asks for each row's lse as well (``with_lse``): the
prefill kernels write it, and the plan never sends such a call to the
decode kernel, so lse comes from the launch whose output the backward
differentiates.

The wrapper takes CUDA tensors, and ``meta`` tensors for the dry run
(planned as on an H100, nothing launched): it validates shapes, device, dtype,
the head-dim stride and, for the tensor-core kernels, 16-byte alignment
(it raises, never copies), allocates the output and the split scratch,
launches on PyTorch's current stream and raises if the launch was refused
or a TMA descriptor could not be made.  It never falls back to the plain
version; ``ops.py`` picks the plain version for CPU tensors.  The library
is built with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from repro_torch import kernels as kernel_pkg
from repro_torch.kernels import (H100_SMS, check_tma_aligned, dtype_name,
                                 load_cuda_library, sms_of)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: calls since process start (or since a caller reset it), one a call
#: however many device kernels it launches: shows that a run went through
#: the kernels
LAUNCHES = {"flash_attention": 0}

#: the device kernels, and the calls that took each (counted as LAUNCHES)
VARIANTS = ("wgmma", "decode", "simt")
VARIANT_CALLS = {name: 0 for name in VARIANTS}

#: head dims the kernels are instantiated for, and the CUDA-core kernel's
#: dtype codes
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the tensor-core kernels (bf16)
TC_HEAD_DIMS = (64, 128, 256)
#: packed (query head, query) rows of a decode block, and keys a tile
DECODE_ROWS = 16
DECODE_TILE = 64
#: below this many key tiles a decode call runs as one split: a second
#: launch costs more than the split saves
SPLIT_MIN_TILES = 4


@dataclass(frozen=True)
class Plan:
    """The device kernel of one call and its key splits: ``splits`` are
    the ``[lo, hi)`` key ranges of the decode blocks, in order, tiling the
    keys some query may see; the other kernels have one range."""
    variant: str
    splits: tuple

    @property
    def chunk(self) -> int:
        """Keys of every split but the last (a multiple of the tile)."""
        lo, hi = self.splits[0]
        return hi - lo


def key_range(sq: int, sk: int, causal: bool,
              window: Optional[int]) -> tuple:
    """``[lo, hi)``: the keys valid for some query (the queries are the
    last Sq of Sk positions when causal); never empty, so a call whose
    window masks every key still has one range, which the kernel masks."""
    off = sk - sq if causal else 0
    lo = max(0, off - window + 1) if window is not None else 0
    return min(lo, sk - 1), sk


def plan(b: int, sq: int, sk: int, h: int, kh: int, d: int, dtype,
         causal: bool = True, window: Optional[int] = None,
         sms: int = H100_SMS, with_lse: bool = False) -> Plan:
    """Which device kernel a call takes, and its key splits.

    f32 (tensor cores would run it in TF32) and head dims under 64 take
    the CUDA-core kernel; bf16 calls whose G = H / K heads times Sq rows
    fit one 16-row tile take the decode kernel, the rest the tensor-core
    prefill, and so does every bf16 call ``with_lse`` (the decode kernel
    writes no lse).  A decode call over at least ``SPLIT_MIN_TILES``
    tiles of keys is split into as many splits as keep B * K * splits
    blocks within one wave of ``sms`` (one block an SM), each split a
    whole number of tiles."""
    lo, hi = key_range(sq, sk, causal, window)
    if dtype != torch.bfloat16 or d not in TC_HEAD_DIMS:
        return Plan("simt", ((lo, hi),))
    if with_lse or (h // kh) * sq > DECODE_ROWS:
        return Plan("wgmma", ((lo, hi),))
    tiles = math.ceil((hi - lo) / DECODE_TILE)
    n = 1
    if tiles >= SPLIT_MIN_TILES:
        n = min(tiles, max(1, sms // (b * kh)))
    per = math.ceil(tiles / n)
    chunk = per * DECODE_TILE
    n = math.ceil(tiles / per)
    return Plan("decode", tuple((lo + i * chunk, min(lo + (i + 1) * chunk,
                                                     hi))
                                for i in range(n)))


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
def _launchers():
    """The C entry points with their signatures declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    lib = load_cuda_library(str(SOURCE))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    tail = [f, i, i, ll, i, f]       # scale, causal, window, cap
    simt = lib.flash_attention_launch
    simt.argtypes = [p] * 5 + [i, i] + [ll] * 14 + tail + [p]
    wgmma = lib.flash_attention_wgmma_launch
    wgmma.argtypes = [p] * 5 + [i] + [ll] * 14 + tail + [p]
    decode = lib.flash_attention_decode_launch
    decode.argtypes = [p] * 6 + [i] + [ll] * 14 + tail + [ll, ll, ll, i, p]
    for fn in (simt, wgmma, decode):
        fn.restype = ctypes.c_int
    return {"simt": simt, "wgmma": wgmma, "decode": decode}


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launchers()


def _check_operands(q, k, v) -> None:
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(
            f"the flash_attention CUDA kernel takes CUDA (or meta) tensors, "
            f"got a tensor on {dev} (CPU tensors go through ops.py to the "
            f"plain version)")
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
                         logit_cap: Optional[float] = None,
                         with_lse: bool = False):
    """Flash attention on the card: q (B,Sq,H,D), k/v (B,Sk,K,D), float32
    or bfloat16 CUDA tensors on one device, head dim in ``HEAD_DIMS`` and
    contiguous.  Returns a contiguous (B,Sq,H,D) in q's dtype, still being
    computed on the current stream; ``with_lse`` returns (out, lse), lse
    the (B, H, Sq) f32 log-sum-exp of each row's scaled (capped) valid
    scores in natural log, +inf for a row with no valid key, written by
    the same launch (the backward's input).  On ``meta`` tensors (the dry
    run, ``launch/dryrun.py``) it validates and plans the call as on an
    H100 and returns the outputs unwritten, launching nothing."""
    trace = kernel_pkg.TRACE
    if trace is not None:
        trace.begin()
    validate(q, k, v)
    _check_operands(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dev = q.device
    pl = plan(b, sq, sk, h, kh, d, q.dtype, causal, window,
              sms_of(dev), with_lse=with_lse)
    if pl.variant != "simt":
        check_tma_aligned("the tensor-core kernels", q=q, k=k, v=v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    if dev.type == "cuda":
        _launch(pl, q, k, v, out, lse, causal, window, scale, logit_cap)
    if trace is not None:
        trace.end("flash_attention", pl.variant, dict(
            b=b, sq=sq, sk=sk, h=h, kh=kh, d=d, dtype=dtype_name(q.dtype),
            window=window, causal=causal, with_lse=with_lse))
    return (out, lse) if with_lse else out


def _launch(pl, q, k, v, out, lse, causal, window, scale, logit_cap):
    """Launch the kernel of plan ``pl`` on the current stream and count
    the call."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dev = q.device
    scale = float(scale if scale is not None else d ** -0.5)
    flags = (scale, int(causal), int(window is not None), int(window or 0),
             int(logit_cap is not None), float(logit_cap or 0.0))
    strides = (q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    launch = _launchers()[pl.variant]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lse_ptr = None if lse is None else lse.data_ptr()
        if pl.variant == "simt":
            rc = launch(*ptrs, lse_ptr, DTYPE_CODES[q.dtype], d, b, sq, sk,
                        h, kh, *strides, *flags, stream)
        elif pl.variant == "wgmma":
            rc = launch(*ptrs, lse_ptr, d, b, sq, sk, h, kh, *strides,
                        *flags, stream)
        else:
            n = len(pl.splits)
            ws_acc = ws_ml = None
            if n > 1:
                ws_acc = torch.empty((b, kh, n, DECODE_ROWS, d),
                                     dtype=torch.float32, device=dev)
                ws_ml = torch.empty((b, kh, n, DECODE_ROWS, 2),
                                    dtype=torch.float32, device=dev)
            rc = launch(*ptrs,
                        None if ws_acc is None else ws_acc.data_ptr(),
                        None if ws_ml is None else ws_ml.data_ptr(),
                        d, b, sq, sk, h, kh, *strides, *flags,
                        pl.splits[0][0], pl.splits[-1][1], pl.chunk, n,
                        stream)
    if rc != 0:
        what = (f"TMA descriptor encoding failed (code {rc})" if rc < 0
                else f"CUDA error {rc}")
        raise RuntimeError(f"flash_attention {pl.variant} kernel launch "
                           f"failed: {what} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    VARIANT_CALLS[pl.variant] += 1
