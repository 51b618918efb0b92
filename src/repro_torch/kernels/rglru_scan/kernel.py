"""Wrapper of the hand-written CUDA RG-LRU scan kernel.

``csrc/rglru_scan.cu`` replaces the JAX package's Pallas
``rglru_scan_pallas`` (``src/repro/kernels/rglru_scan/kernel.py``) with a
single-pass chunked scan: one block per (batch row, chunk of S, tile of
W) stages its chunk in shared memory, publishes the chunk's aggregate
(the last chunk of a group of ``FOLD``, its group's) and composes its
carry from the earlier groups' and its group's earlier chunks'
aggregates in a fixed order; :func:`plan` gives the launch shape and the
load path.  The wrapper takes CUDA tensors only: it validates shapes,
device, dtype and contiguity, allocates the output and the workspace
(the ticket counter and the aggregates, filled with all ones), launches
on PyTorch's current stream and raises if the launch was refused.  It
never falls back to the plain version; ``ops.py`` picks the plain
version for CPU tensors.  The library is built with nvcc at first launch
(``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import load_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"

#: launches since process start (or since a caller reset it): shows that a
#: run went through the kernel
LAUNCHES = {"rglru_scan": 0}

#: steps of S an item takes at most, and by default (the kernel's
#: kMaxChunk); channels of W an item takes (its kTile, one a thread); and
#: chunks a group (its kFold: the carry composes earlier groups, then
#: earlier chunks of its group)
CHUNK = 64
TILE = 128
FOLD = 8


@dataclass(frozen=True)
class Plan:
    """The launch shape of one call.  S is cut into ``chunks`` chunks of
    ``chunk`` steps (the last may be shorter), W into ``tiles`` tiles of
    ``TILE`` channels: an item is one (batch row, chunk, tile), and one
    block takes each.  ``load`` is how a block stages its item:
    ``"bulk"`` (one ``cp.async.bulk`` a row, when W % 4 == 0 and a and b
    are 16-byte aligned) or ``"cp_async"`` (one 4-byte ``cp.async`` an
    element)."""
    b: int
    w: int
    chunk: int
    chunks: int
    tiles: int
    load: str

    @property
    def blocks(self) -> int:
        return self.b * self.chunks * self.tiles

    @property
    def slots(self) -> int:
        """Workspace slots a (batch row, tile): every chunk but the last,
        then every group but the last (the aggregates later chunks
        read)."""
        last = self.chunks - 1
        return last + last // FOLD

    @property
    def ws_words(self) -> int:
        """64-bit words of workspace: the ticket counter, then one (A, B)
        word a (batch row, slot, channel).  The wrapper fills it with all
        ones (no ticket taken, no aggregate written) for every launch."""
        return 1 + self.b * self.slots * self.w


def plan(b: int, s: int, w: int, aligned: bool = True,
         chunk: int = CHUNK) -> Plan:
    """The launch shape of a (B, S, W) scan.  Chunks of ``chunk`` steps
    (all of S in one chunk when S is shorter) and tiles of ``TILE``
    channels: at recurrentgemma-9b's (1, 4096, 4096) 64 chunks x 32 tiles
    = 2048 blocks of 64 KB of staged rows, three an SM.  ``aligned``: a
    and b start on 16-byte boundaries (the bulk copies need it, with W %
    4 == 0).  A shorter ``chunk`` is there for probes that time other
    chunk lengths; the model's calls keep the default."""
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"chunk must be in [1, {CHUNK}], got {chunk}")
    chunk = min(chunk, s)
    load = "bulk" if aligned and w % 4 == 0 else "cp_async"
    return Plan(b, w, chunk, -(-s // chunk), -(-w // TILE), load)


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
    fn.argtypes = [p] * 5 + [ll, ll, ll, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def rglru_scan_cuda(a, b, h0=None, *, chunk: int = CHUNK):
    """``h_t = a_t h_{t-1} + b_t`` on the card: a, b (B,S,W) and h0 (B,W)
    (None: zeros), contiguous float32 CUDA tensors on one device; chunks
    of ``chunk`` steps (:func:`plan`).  Returns (h (B,S,W) float32, h_last
    (B,W), a view of h), still being computed on the current stream."""
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
    pl = plan(bsz, s, w, aligned=a.data_ptr() % 16 == 0 and
              b.data_ptr() % 16 == 0, chunk=chunk)
    h = torch.empty_like(a)
    ws = torch.full((pl.ws_words,), -1, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        rc = _launcher()(
            a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h.data_ptr(),
            ws.data_ptr(),
            bsz, s, w, pl.chunk, int(pl.load == "bulk"),
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc} (a {tuple(a.shape)})")
    LAUNCHES["rglru_scan"] += 1
    return h, h[:, -1]
