"""Wrappers of the hand-written CUDA event-filter kernels.

``csrc/event_filter.cu`` holds one kernel: the K-query shared scan that
replaces the JAX package's ``event_filter_batch_pallas``.  Its block size
is a launch argument (``LAUNCH_THREADS``, 512 by default), which the
launch-shape sweep (``tune.py``) chooses among.  The single-query form
(``event_filter_pallas`` in the reference) launches the same kernel with
K = 1 and the default block size, through its own wrapper and launch
counter.

The wrappers take CUDA tensors only: they validate shapes (the checks of
the reference's ``_validate``, without its TPU block shapes), device,
dtype and contiguity, allocate the outputs, launch on PyTorch's current
stream and raise if the launch was refused.  They never fall back to the
plain version; ``ops.py`` picks the plain version for CPU tensors.
The library is built with nvcc at first launch (``repro_torch.kernels``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import load_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "event_filter.cu"

#: launches per wrapper since process start (or since a caller reset it):
#: shows that a run went through the kernel
LAUNCHES = {"event_filter": 0, "event_filter_batch": 0}

#: the kernel keeps 2*K floats of dynamic shared memory per block; this
#: keeps it well under the 48 KB a launch gets without opting in
MAX_QUERIES = 4096

#: block sizes the one kernel instance takes (threads a block, one block
#: an event), and the launch it gets unless a caller passes another (the
#: launch-shape sweep, ``tune.py``)
LAUNCH_THREADS = (128, 256, 512)
DEFAULT_THREADS = 512


def check_threads(threads) -> int:
    """The block size of a launch: ``DEFAULT_THREADS`` for None, else one
    of ``LAUNCH_THREADS``; raises ``ValueError`` for any other value."""
    if threads is None:
        return DEFAULT_THREADS
    if isinstance(threads, bool) or threads not in LAUNCH_THREADS:
        raise ValueError(f"event_filter launches {LAUNCH_THREADS} threads a "
                         f"block, got threads={threads!r}")
    return int(threads)


def validate(scalars, tracks, n_tracks, thresholds, *, batch: bool) -> None:
    """Shape/size validation shared by every entry point (CPU or CUDA):
    reject zero-sized operands and malformed thresholds before any work,
    with errors that name the offending operand."""
    if scalars.ndim != 2 or tracks.ndim != 3 or n_tracks.ndim != 1:
        raise ValueError(
            f"event_filter expects scalars (N,S), tracks (N,T,V), "
            f"n_tracks (N,); got {tuple(scalars.shape)}, "
            f"{tuple(tracks.shape)}, {tuple(n_tracks.shape)}")
    n, _ = scalars.shape
    nt, t, v = tracks.shape
    if n == 0 or t == 0 or v == 0:
        raise ValueError(
            f"event_filter got a zero-sized operand (scalars "
            f"{tuple(scalars.shape)}, tracks {tuple(tracks.shape)}): empty "
            f"chunks must be skipped by the caller, the kernel has no "
            f"zero-width grid")
    if nt != n or n_tracks.shape[0] != n:
        raise ValueError(
            f"event axis mismatch: scalars N={n}, tracks N={nt}, "
            f"n_tracks N={n_tracks.shape[0]}")
    if batch:
        if thresholds.ndim != 2 or thresholds.shape[0] != 4 \
                or thresholds.shape[1] == 0:
            raise ValueError(
                f"batched thresholds must be (4, K) with K >= 1, got "
                f"{tuple(thresholds.shape)}")
    elif tuple(thresholds.shape) != (4,):
        raise ValueError(
            f"thresholds must be (4,), got {tuple(thresholds.shape)}")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its signature declared: without
    ``argtypes`` ctypes would pass every pointer as a 32-bit int."""
    fn = load_cuda_library(str(SOURCE)).event_filter_batch_launch
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, ll, ll, ll, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load the kernel library now (otherwise at first launch)."""
    _launcher()


def _check_operands(scalars, tracks, n_tracks, thresholds, var_idx):
    dev = scalars.device
    if dev.type != "cuda":
        raise ValueError(
            f"the event_filter CUDA kernel takes CUDA tensors, got a tensor "
            f"on {dev} (CPU tensors go through ops.py to the plain version)")
    for name, x, dtype in (("scalars", scalars, torch.float32),
                           ("tracks", tracks, torch.float32),
                           ("n_tracks", n_tracks, torch.int32),
                           ("thresholds", thresholds, torch.float32),
                           ("var_idx", var_idx, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, scalars on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    k = var_idx.shape[0]
    if var_idx.ndim != 1 or k != thresholds.numel() // 4:
        raise ValueError(f"var_idx must be (K,) with K={thresholds.numel() // 4}"
                         f", got {tuple(var_idx.shape)}")
    if k > MAX_QUERIES:
        raise ValueError(f"at most {MAX_QUERIES} queries per launch, got {k}")
    if scalars.shape[0] >= 2 ** 31:
        raise ValueError(f"too many events for one launch: {scalars.shape[0]}")


def _launch(scalars, tracks, n_tracks, thresholds, var_idx, calib_iters,
            threads, mask, var) -> None:
    n, s = scalars.shape
    _, t, v = tracks.shape
    k = var_idx.shape[0]
    rc = _launcher()(
        scalars.data_ptr(), tracks.data_ptr(), n_tracks.data_ptr(),
        thresholds.data_ptr(), var_idx.data_ptr(), mask.data_ptr(),
        var.data_ptr(), n, s, t, v, k, int(calib_iters), threads,
        torch.cuda.current_stream(scalars.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"event_filter kernel launch failed: CUDA error "
                           f"{rc} (N={n}, T={t}, V={v}, K={k}, "
                           f"{threads} threads)")


def event_filter_batch_cuda(scalars, tracks, n_tracks, thresholds, var_idx,
                            *, calib_iters: int, threads=None):
    """K-query shared scan on the card: scalars (N,S) f32, tracks (N,T,V)
    f32, n_tracks (N,) i32, thresholds (4,K) f32, var_idx (K,) i32, all
    contiguous CUDA tensors on one device; ``threads`` a block, one of
    ``LAUNCH_THREADS`` (None: ``DEFAULT_THREADS``).  Returns (mask (N,K),
    var (N,)) f32, still being computed on the current stream."""
    validate(scalars, tracks, n_tracks, thresholds, batch=True)
    threads = check_threads(threads)
    _check_operands(scalars, tracks, n_tracks, thresholds, var_idx)
    n, k = scalars.shape[0], thresholds.shape[1]
    mask = torch.empty((n, k), dtype=torch.float32, device=scalars.device)
    var = torch.empty((n,), dtype=torch.float32, device=scalars.device)
    with torch.cuda.device(scalars.device):
        _launch(scalars, tracks, n_tracks, thresholds, var_idx, calib_iters,
                threads, mask, var)
    LAUNCHES["event_filter_batch"] += 1
    return mask, var


def event_filter_cuda(scalars, tracks, n_tracks, thresholds, var_idx,
                      *, calib_iters: int):
    """Single-query form on the card: thresholds (4,) f32, var_idx (1,)
    i32.  Runs the batched kernel with K = 1.  Returns (mask (N,), var
    (N,)) f32."""
    validate(scalars, tracks, n_tracks, thresholds, batch=False)
    _check_operands(scalars, tracks, n_tracks, thresholds, var_idx)
    n = scalars.shape[0]
    mask = torch.empty((n, 1), dtype=torch.float32, device=scalars.device)
    var = torch.empty((n,), dtype=torch.float32, device=scalars.device)
    with torch.cuda.device(scalars.device):
        # a contiguous (4,) threshold vector is the (4, 1) layout
        _launch(scalars, tracks, n_tracks, thresholds, var_idx, calib_iters,
                DEFAULT_THREADS, mask, var)
    LAUNCHES["event_filter"] += 1
    return mask[:, 0], var
