"""Wrapper of the hand-written CUDA chunkwise-mLSTM kernels.

``csrc/mlstm_scan.cu`` replaces the JAX package's Pallas
``mlstm_pallas`` (``src/repro/kernels/mlstm_scan/kernel.py``) with two
device kernels, one chosen per call by :func:`plan`:

- ``"wgmma"``: bf16 at head dim 512 (xlstm-350m) on the tensor cores,
  TMA-fed, each query tile's keys cut into splits that the kernel adds in
  split order (``csrc/mlstm_wgmma.cuh``);
- ``"simt"``: f32 at every head dim and bf16 at the other head dims, the
  CUDA-core kernel.

For the CUDA-core kernel, as the Pallas wrapper does, this wrapper forms
``F = cumsum(log_f)`` over the sequence in f32 before the launch; the
tensor-core kernel forms F itself, with the gates' row max.  It takes
CUDA tensors, and ``meta`` tensors for the dry run (planned as on an
H100, nothing launched): it validates shapes, device, dtype, the head-dim
stride and, for the tensor-core kernel, 16-byte alignment (it raises,
never copies), allocates the output and the split scratch, launches on
PyTorch's current stream and raises if the launch was refused or a TMA
descriptor could not be made.  It never falls back to the plain version;
``ops.py`` picks the plain version for CPU tensors.  The library is built
with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch import kernels as kernel_pkg
from repro_torch.kernels import (H100_SMS, check_tma_aligned, dtype_name,
                                 load_cuda_library, sms_of)

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan.cu"

#: calls since process start (or since a caller reset it), one a call:
#: shows that a run went through the kernels
LAUNCHES = {"mlstm": 0}

#: the device kernels, and the calls that took each (counted as LAUNCHES)
VARIANTS = ("wgmma", "simt")
VARIANT_CALLS = {name: 0 for name in VARIANTS}

#: head dims the kernels are instantiated for, and the CUDA-core kernel's
#: dtype codes
HEAD_DIMS = (16, 32, 64, 512)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the tensor-core kernel (bf16)
TC_HEAD_DIMS = (512,)
#: query rows and keys of a tile: the tensor-core kernel's, then the
#: CUDA-core kernel's rows
QUERY_TILE = 64
KEY_TILE = 32
SIMT_QUERY_TILE = 32
#: the fewest key tiles a split: a split's partials cost about two tiles
#: of work to write and add
MIN_SPLIT_TILES = 4


@dataclass(frozen=True)
class Plan:
    """The device kernel of one call and its key splits.  Query tile ``i``
    holds rows ``[rows * i, rows * (i + 1))`` and sees keys ``[0, min(rows
    * (i + 1), S))``, cut into splits of ``chunk`` keys (the last
    shorter); ``items`` lists every (query tile, key range) a block
    takes, in the order the kernel numbers its blocks: the last (heaviest)
    query tile first, each tile's splits in key order."""
    variant: str
    s: int
    rows: int
    chunk: int

    @property
    def query_tiles(self) -> int:
        return -(-self.s // self.rows)

    def splits(self, tile: int) -> tuple:
        """The ``[lo, hi)`` key ranges of query tile ``tile``, in order."""
        hi = min(self.rows * (tile + 1), self.s)
        return tuple((lo, min(lo + self.chunk, hi))
                     for lo in range(0, hi, self.chunk))

    @property
    def items(self) -> tuple:
        return tuple((i, lo, hi) for i in reversed(range(self.query_tiles))
                     for lo, hi in self.splits(i))

    @property
    def split_tiles(self) -> int:
        """Query tiles cut into more than one split (the last ones)."""
        return sum(len(self.splits(i)) > 1 for i in range(self.query_tiles))

    @property
    def split_items(self) -> int:
        """Their splits: the blocks that write partials to scratch."""
        return sum(len(self.splits(i)) for i in range(self.query_tiles)
                   if len(self.splits(i)) > 1)


def plan(b: int, s: int, h: int, d: int, dtype,
         sms: int = H100_SMS) -> Plan:
    """Which device kernel a call takes, and its key splits.

    bf16 at a head dim in ``TC_HEAD_DIMS`` takes the tensor-core kernel;
    the rest the CUDA-core kernel, whose query tiles see all their keys in
    one block.  The tensor-core kernel's split holds as many key tiles as
    the call's (query tile, key tile) pairs over ``sms`` (one block an
    SM), at least ``MIN_SPLIT_TILES``: at xlstm-350m's (1, 2048, 4, 512)
    4224 pairs give 32 tiles, so the 16 longest query tiles of each head
    run as two blocks."""
    if dtype != torch.bfloat16 or d not in TC_HEAD_DIMS:
        return Plan("simt", s, SIMT_QUERY_TILE, s)
    pairs = b * h * sum(-(-min(QUERY_TILE * (i + 1), s) // KEY_TILE)
                        for i in range(-(-s // QUERY_TILE)))
    tiles = max(MIN_SPLIT_TILES, math.ceil(pairs / sms))
    return Plan("wgmma", s, QUERY_TILE, tiles * KEY_TILE)


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
def _launchers():
    """The C entry points with their signatures declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    lib = load_cuda_library(str(SOURCE))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    simt = lib.mlstm_launch
    simt.argtypes = [p, p, p, p, p, p, i, i] + [ll] * 14 + [f, p, p, p]
    wgmma = lib.mlstm_wgmma_launch
    wgmma.argtypes = [p] * 10 + [i] + [ll] * 14 + [f, i, ll, ll, p, p, p]
    for fn in (simt, wgmma):
        fn.restype = ctypes.c_int
    return {"simt": simt, "wgmma": wgmma}


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launchers()


def _check_operands(q, k, v, log_i, log_f) -> None:
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("log_i", log_i),
                    ("log_f", log_f)):
        if x.device.type not in ("cuda", "meta"):
            raise ValueError(
                f"the mlstm CUDA kernel takes CUDA (or meta) tensors, got "
                f"{name} on {x.device} (CPU tensors go through ops.py to the "
                f"plain version)")
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


def mlstm_cuda(q, k, v, log_i, log_f, *, with_stats: bool = False):
    """Chunkwise mLSTM on the card: q, k, v (B,S,H,D) float32 or bfloat16
    with a contiguous head dim in ``HEAD_DIMS``, log_i/log_f (B,S,H)
    float32, CUDA tensors on one device.  Returns a contiguous (B,S,H,D)
    in q's dtype, still being computed on the current stream; with
    ``with_stats``, (out, L, sg), the row stats the backward reads
    (``ref.mlstm_ref(with_stats=True)``), contiguous (B,S,H) float32
    written by the same launch.  On ``meta`` tensors (the dry run) it
    validates and plans the call as on an H100 and returns the outputs
    unwritten, launching nothing."""
    trace = kernel_pkg.TRACE
    if trace is not None:
        trace.begin()
    validate(q, k, v, log_i, log_f)
    _check_operands(q, k, v, log_i, log_f)
    b, s, h, d = q.shape
    dev = q.device
    pl = plan(b, s, h, d, q.dtype, sms_of(dev))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    lse = sg = None
    if with_stats:
        lse = torch.empty((b, s, h), dtype=torch.float32, device=dev)
        sg = torch.empty_like(lse)
    if dev.type == "cuda":
        _launch(pl, q, k, v, log_i, log_f, out, lse, sg)
    if trace is not None:
        trace.end("mlstm", pl.variant, dict(b=b, s=s, h=h, d=d,
                                            dtype=dtype_name(q.dtype),
                                            with_stats=with_stats))
    return (out, lse, sg) if with_stats else out


def _launch(pl, q, k, v, log_i, log_f, out, lse, sg):
    """Launch the kernel of plan ``pl`` on the current stream and count
    the call."""
    b, s, h, d = q.shape
    dev = q.device
    stats = (None if lse is None else lse.data_ptr(),
             None if sg is None else sg.data_ptr())
    strides = (q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    launch = _launchers()[pl.variant]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pl.variant == "simt":
            fcum = torch.cumsum(log_f, dim=1).contiguous()
            li = log_i.contiguous()
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        fcum.data_ptr(), li.data_ptr(), out.data_ptr(),
                        DTYPE_CODES[q.dtype], d, b, s, h, *strides,
                        fcum.stride(0), fcum.stride(1), float(d ** -0.5),
                        *stats, stream)
        else:
            check_tma_aligned("the tensor-core kernel", q=q, k=k, v=v)
            # the kernel forms F = cumsum(log f) itself, with the row max
            lf, li = log_f.contiguous(), log_i.contiguous()
            gates = torch.empty((4, b * h, pl.query_tiles * QUERY_TILE),
                                dtype=torch.float32, device=dev)
            slots = pl.split_items * b * h
            ws = ws_den = done = None
            if slots:
                ws = torch.empty((slots, QUERY_TILE, d), dtype=torch.float32,
                                 device=dev)
                ws_den = torch.empty((slots, 2 * 128, 2),
                                     dtype=torch.float32, device=dev)
                done = torch.empty((pl.split_tiles * b * h,),
                                   dtype=torch.int32, device=dev)
            rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lf.data_ptr(), li.data_ptr(), out.data_ptr(),
                        gates.data_ptr(),
                        *(None if x is None else x.data_ptr()
                          for x in (ws, ws_den, done)),
                        d, b, s, h, *strides, lf.stride(0), lf.stride(1),
                        float(d ** -0.5), pl.chunk // KEY_TILE,
                        len(pl.items), pl.split_tiles, *stats, stream)
    if rc != 0:
        what = (f"TMA descriptor encoding failed (code {rc})" if rc < 0
                else f"CUDA error {rc}")
        raise RuntimeError(f"mlstm {pl.variant} kernel launch failed: "
                           f"{what} (q {tuple(q.shape)}, {q.dtype})")
    LAUNCHES["mlstm"] += 1
    VARIANT_CALLS[pl.variant] += 1
