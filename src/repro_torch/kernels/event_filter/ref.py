"""Plain PyTorch versions of the fused event-filter kernels.

Canonical GEPS hot query family (the paper's filter+calibration job):

    mask = (scalars[:, var_idx] > scalar_thresh)
           & (count(calibrated_pt > pt_thresh) >= min_count)
           & (sum(calibrated_pt) < sum_cap)          [sum_cap <= 0: disabled]
    var  = scalars[:, 0]   (summary variable for the histogram/merge)

Calibration is the paper's section-4.1 iterative per-track refinement.
These are what a wrapper runs for CPU tensors and what the CUDA kernels
are held against on the card; they run on whatever device their inputs
live on.
"""
from __future__ import annotations

from typing import Sequence

import torch


def calibrate_tracks(tracks: torch.Tensor, iters: int) -> torch.Tensor:
    """tracks: (..., T, V) f32.  Matches core.query.calibrate."""
    trk = tracks.float()
    for _ in range(iters):
        pt = trk[..., 0:1]
        corr = 1.0 + 0.01 * torch.tanh(trk) * torch.rsqrt(1.0 + pt * pt)
        trk = trk * corr
    return trk


def event_filter_ref(scalars, tracks, n_tracks, *, var_idx: int,
                     scalar_thresh: float, pt_thresh: float,
                     min_count: float, sum_cap: float, calib_iters: int):
    """Returns (mask (N,) f32 in {0,1}, var (N,) f32)."""
    pt = calibrate_tracks(tracks, calib_iters)[..., 0]  # (N, T)
    t = torch.arange(pt.shape[-1], device=pt.device)
    valid = t[None, :] < n_tracks[:, None]
    cnt = torch.sum(torch.where(valid & (pt > pt_thresh), 1.0, 0.0), dim=-1)
    ssum = torch.sum(torch.where(valid, pt, 0.0), dim=-1)
    mask = (scalars[:, var_idx] > scalar_thresh) & (cnt >= min_count)
    if sum_cap > 0:
        mask = mask & (ssum < sum_cap)
    return mask.float(), scalars[:, 0]


def event_filter_batch_ref(scalars, tracks, n_tracks, thresholds, *,
                           var_idx: Sequence[int], calib_iters: int):
    """Batched version: thresholds (4, K) columns per query, var_idx K
    scalar columns (a sequence or an int tensor).  Returns (mask (N, K)
    f32 in {0,1}, var (N,) f32) — one calibration + one track sweep
    shared by all K queries."""
    pt = calibrate_tracks(tracks, calib_iters)[..., 0]  # (N, T)
    t = torch.arange(pt.shape[-1], device=pt.device)
    valid = t[None, :] < n_tracks[:, None]
    hit = valid[..., None] & (pt[..., None] > thresholds[1, :])  # (N, T, K)
    cnt = torch.sum(torch.where(hit, 1.0, 0.0), dim=1)            # (N, K)
    ssum = torch.sum(torch.where(valid, pt, 0.0), dim=-1)         # (N,)
    idx = torch.as_tensor(var_idx, dtype=torch.long, device=scalars.device)
    sc_sel = scalars[:, idx]                                      # (N, K)
    mask = (sc_sel > thresholds[0, :]) & (cnt >= thresholds[2, :])
    mask = mask & torch.where(thresholds[3, :] > 0,
                              ssum[:, None] < thresholds[3, :], True)
    return mask.float(), scalars[:, 0]
