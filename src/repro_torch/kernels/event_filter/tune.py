"""Launch-shape autotuner for the fused ``event_filter`` CUDA kernel (port
of ``kernels/event_filter/tune.py``).

The reference sweeps the Pallas kernel's ``(block_e, block_t)`` block
shapes, which tile the TPU kernel's grid.  The CUDA kernel has no such
tiles: it runs one block per event, and what shapes its launch is the
block size, ``threads`` (``kernel.LAUNCH_THREADS``: 128, 256 or 512, with
512 the fixed default).  How many threads pay depends on the chunk the
scan feeds (events x tracks x vars), the query width K and the card, so
this module measures instead of guessing:

- :func:`autotune_block_shapes` sweeps :data:`CANDIDATES` on a sample
  chunk (each distinct block size once), times each with CUDA events on
  the launch it will actually run, and returns a :class:`TunedShape`
  carrying the winner, the fixed-default baseline, every measurement and
  a roofline point (bytes moved / useful FLOPs / achieved GB/s and
  GFLOP/s at the winner's time).
- Winners are cached **in-process** by :func:`shape_key` (chunk shape x
  schema width x K x calib x the card's name), so a scan pays the sweep
  once per shape class.

The sweep tunes the CUDA kernel's launch, so it takes CUDA tensors only:
the plain version that CPU tensors take has no launch to shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.event_filter import kernel as ef_kernel

#: The sweep grid: every block size the kernel takes, the fixed default
#: among them.
CANDIDATES: Tuple[int, ...] = ef_kernel.LAUNCH_THREADS

#: The fixed pre-autotune default the tuned shape is benchmarked against.
DEFAULT_SHAPE: int = ef_kernel.DEFAULT_THREADS

#: Timed launches of each candidate (after its one warm-up launch).
REPEATS = 3

#: GPU cycles of the spin kernel queued before each timed launch (~0.5 ms
#: on an H100), long enough for the host to queue the start event, the
#: launch and the end event behind it.
_HOLD_CYCLES = 1_000_000

#: In-process winner cache: ``shape_key -> TunedShape``.
_CACHE: Dict[tuple, "TunedShape"] = {}


@dataclasses.dataclass(frozen=True)
class TunedShape:
    """One autotune verdict: the winning block size for a shape class,
    with the evidence (per-candidate timings) and the winner's roofline
    point (estimated bytes/FLOPs over measured device time)."""
    threads: int
    best_ms: float
    default_ms: float
    #: ((threads, ms), ...) for every distinct candidate timed
    measurements: Tuple[Tuple[int, float], ...]
    #: bytes / flops estimates + achieved GB/s, GFLOP/s, FLOP/byte
    roofline: Dict[str, float]

    @property
    def speedup_vs_default(self) -> float:
        """default_ms / best_ms — >= 1.0 by construction (the default is
        itself a candidate, so the winner can never be slower)."""
        return self.default_ms / self.best_ms if self.best_ms > 0 else 1.0

    def as_dict(self) -> dict:
        """JSON-ready form for reporting."""
        return {
            "threads": self.threads,
            "best_ms": round(self.best_ms, 4),
            "default_ms": round(self.default_ms, 4),
            "speedup_vs_default": round(self.speedup_vs_default, 3),
            "measurements": [[t, round(ms, 4)]
                             for t, ms in self.measurements],
            "roofline": {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in self.roofline.items()},
        }


def shape_key(n: int, t: int, v: int, s: int, k: int, calib_iters: int,
              device_name: str) -> tuple:
    """The in-process cache key: everything the winner depends on —
    chunk shape (n, t, v), scalar width s, query width k, calibration
    depth, and the card (its name) the kernel runs on."""
    return (n, t, v, s, k, calib_iters, device_name)


def roofline_point(n: int, t: int, v: int, s: int, k: int,
                   calib_iters: int, ms: float) -> Dict[str, float]:
    """Estimated traffic/compute for one kernel invocation, scaled by a
    measured runtime into achieved GB/s / GFLOP/s.  Traffic counts each
    operand once (the kernel's whole point is that tracks stream from
    device memory exactly once); FLOPs count the calibration polynomial
    (~10 flops/element/iter: tanh+rsqrt+mults) plus the per-query
    compare/accumulate epilogue."""
    bytes_moved = 4.0 * (n * t * v          # tracks, one streaming read
                         + n * s            # scalars
                         + n                # n_tracks
                         + n * k + n)       # mask + var outputs
    flops = (10.0 * calib_iters * n * t * v     # calibration sweep
             + n * t * (k + 2.0))               # hit test + cnt/sum accum
    sec = max(ms, 1e-9) / 1e3
    return {
        "bytes": bytes_moved, "flops": flops,
        "intensity_flop_per_byte": flops / bytes_moved,
        "gbytes_per_s": bytes_moved / sec / 1e9,
        "gflops_per_s": flops / sec / 1e9,
        "ms": ms,
    }


def _time_once(fn, repeats: int) -> float:
    """Best-of-``repeats`` device milliseconds of one ``fn()`` launch, after
    one untimed warm-up launch (the library's first load, the caches).
    CUDA events bracket the launch on the current stream behind a spin
    kernel (``torch.cuda._sleep``) that holds the stream while the host
    queues them: without it the interval would hold the wrapper's host
    time (tens of µs), not the kernel's (~10 µs at the query path's
    chunk)."""
    fn()  # warm-up
    best = float("inf")
    for _ in range(max(1, repeats)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def autotune_block_shapes(scalars, tracks, n_tracks, thresholds, var_idx,
                          *, calib_iters: int,
                          candidates: Sequence[int] = CANDIDATES,
                          repeats: int = REPEATS,
                          cache: Optional[Dict[tuple, TunedShape]] = None
                          ) -> TunedShape:
    """Sweep ``candidates`` (block sizes) on the given sample chunk and
    return the winning :class:`TunedShape` (cached in-process by shape
    class).  The operands are the kernel's (CUDA tensors in the layout of
    ``ops.batch_kernel_params``).

    Each distinct block size is timed once, in ascending order; the fixed
    default (512) is always among them, so ``speedup_vs_default >= 1.0``.
    A candidate the kernel does not take raises ``ValueError`` before any
    launch."""
    from repro_torch.kernels.event_filter import ops as ef_ops

    dev = scalars.device
    if dev.type != "cuda":
        raise ValueError(
            f"autotune_block_shapes tunes the event_filter CUDA kernel's "
            f"launch (threads a block) and takes CUDA tensors; got tensors "
            f"on {dev}, whose plain version has no launch to tune")
    effective = sorted({ef_kernel.check_threads(c)
                        for c in tuple(candidates) + (DEFAULT_SHAPE,)})
    n, s = scalars.shape
    _, t, v = tracks.shape
    k = thresholds.shape[1]
    key = shape_key(n, t, v, s, k, calib_iters,
                    torch.cuda.get_device_name(dev))
    store = _CACHE if cache is None else cache
    hit = store.get(key)
    if hit is not None:
        return hit

    def run(threads):
        ef_ops.event_filter_batch(scalars, tracks, n_tracks, thresholds,
                                  var_idx, calib_iters=calib_iters,
                                  threads=threads)

    timed = [(c, _time_once(functools.partial(run, c), repeats))
             for c in effective]
    best, best_ms = min(timed, key=lambda r: r[1])
    default_ms = next(ms for c, ms in timed if c == DEFAULT_SHAPE)
    tuned = TunedShape(
        threads=best, best_ms=best_ms, default_ms=default_ms,
        measurements=tuple(timed),
        roofline=roofline_point(n, t, v, s, k, calib_iters, best_ms))
    store[key] = tuned
    return tuned


def cached_shapes() -> Dict[tuple, TunedShape]:
    """A snapshot of the in-process winner cache (reporting)."""
    return dict(_CACHE)


def clear_cache() -> None:
    """Drop every cached winner (tests / fresh sweeps)."""
    _CACHE.clear()
