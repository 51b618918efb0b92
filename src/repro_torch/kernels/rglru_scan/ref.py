"""Plain PyTorch version of the RG-LRU scan kernel (port of
``kernels/rglru_scan/ref.py``): the first-order linear recurrence
``h_t = a_t h_{t-1} + b_t`` as a log-depth doubling scan.  A wrapper runs
it for CPU tensors, and the CUDA kernel is held against it on the card."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0=None):
    """a, b: (B, S, W) f32; h0: (B, W) or None.  Returns (h (B,S,W),
    h_last (B,W)).

    ``h0`` is folded into the first step, ``b_0 += a_0 h0``, as the
    reference folds it.  Then the ``associative_scan`` combine
    ``(a1 a2, a2 b1 + b2)`` runs over shifts 1, 2, 4, ...: after the pass
    with shift ``s`` every position holds the composition of the last
    ``2s`` steps (Hillis-Steele), so ``ceil(log2 S)`` passes give h."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    s = a.shape[1]
    shift = 1
    while shift < s:
        a_next, b_next = a.clone(), b.clone()
        b_next[:, shift:] = a[:, shift:] * b[:, :-shift] + b[:, shift:]
        a_next[:, shift:] = a[:, :-shift] * a[:, shift:]
        a, b = a_next, b_next
        shift *= 2
    return b, b[:, -1]
