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


def rglru_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor, h0=None,
                           chunk: int = 64, fold: int = 8):
    """The CUDA kernel's order of operations in plain PyTorch: a, b (B, S,
    W) f32, h0 (B, W) or None.  Returns (h, h_last) as
    :func:`rglru_scan_ref`; on the card the kernel equals it bit for bit.

    S is cut into chunks of ``chunk`` steps, and the chunks into groups of
    ``fold``.  Each chunk's aggregate runs its steps from h = 0 (``B_c``)
    and multiplies ``A_c = 1 * a_0 * a_1 ...`` in step order; each group's
    aggregate folds its chunks' the same way (``GA = 1 * A_0 * A_1 ...``,
    ``GB = A_j * GB + B_j`` from 0).  The carry into chunk c is h0 (or 0)
    composed with ``carry = GA * carry + GB`` for each earlier group, then
    ``carry = A * carry + B`` for each earlier chunk of its group, in that
    order; then each chunk runs its steps again from its carry.  Every
    product and sum is its own rounded op.  A ragged last chunk is padded
    with a = 1, b = 0: its aggregate is never read and its padded steps
    are cut off.  Used by the tests and ``chip_smoke.py``; the wrapper's
    CPU path is :func:`rglru_scan_ref`."""
    bsz, s, w = a.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        a = torch.cat([a, a.new_ones((bsz, pad, w))], dim=1)
        b = torch.cat([b, b.new_zeros((bsz, pad, w))], dim=1)
    a4 = a.reshape(bsz, n, chunk, w)
    b4 = b.reshape(bsz, n, chunk, w)
    prod = a.new_ones((bsz, n, w))
    agg = a.new_zeros((bsz, n, w))
    for t in range(chunk):
        prod = prod * a4[:, :, t]
        agg = a4[:, :, t] * agg + b4[:, :, t]
    # the groups whose aggregate a later chunk reads: all but the last
    groups = (n - 1) // fold
    gprod = a.new_ones((bsz, groups, w))
    gagg = a.new_zeros((bsz, groups, w))
    for j in range(fold):
        cp = prod[:, j:groups * fold:fold]
        gprod = gprod * cp
        gagg = cp * gagg + agg[:, j:groups * fold:fold]
    carry = h0 if h0 is not None else a.new_zeros((bsz, w))
    group_carry = [carry]
    for g in range(groups):
        carry = gprod[:, g] * carry + gagg[:, g]
        group_carry.append(carry)
    carries = []
    for c in range(n):
        if c % fold == 0:
            carry = group_carry[c // fold]
        carries.append(carry)
        carry = prod[:, c] * carry + agg[:, c]
    h = torch.stack(carries, dim=1)
    out = torch.empty_like(a4)
    for t in range(chunk):
        h = a4[:, :, t] * h + b4[:, :, t]
        out[:, :, t] = h
    out = out.view(bsz, n * chunk, w)[:, :s]
    return out, out[:, -1]


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dy: torch.Tensor,
                       dh_last=None, h0=None):
    """The gradient of :func:`rglru_scan_ref`, in plain PyTorch: a (B, S,
    W) the decays, h (B, S, W) the forward's output, dy (B, S, W) the
    gradient of the loss with respect to h, dh_last (B, W) or None that
    with respect to h_last, h0 (B, W) or None the forward's initial state.
    Returns (da, db, dh0), dh0 None when h0 is.

    The reverse recurrence ``g_t = dy_t + a_{t+1} g_{t+1}``, from
    ``g_{S-1} = dy_{S-1} + dh_last``, run as the forward's doubling scan
    over the reversed sequence with the decays read one step ahead (``a``
    shifted by one, 1 past the end) and ``dh_last`` as the initial state.
    Then ``db = g``, ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``, or 0) and
    ``dh0 = a_0 g_0``."""
    g, _ = rglru_scan_ref(*_reversed(a, dy), dh_last)
    return _bwd_products(a, h, g.flip(1), h0)


def rglru_scan_bwd_chunked_ref(a: torch.Tensor, h: torch.Tensor,
                               dy: torch.Tensor, dh_last=None, h0=None,
                               chunk: int = 64, fold: int = 8):
    """The backward kernel's order of operations in plain PyTorch, as
    :func:`rglru_scan_chunked_ref` is the forward's: the same arguments
    and results as :func:`rglru_scan_bwd_ref`, and on the card the kernel
    equals it bit for bit.

    The reverse recurrence is the forward's chunked scan run from the end:
    step ``r`` of the reversed sequence is time ``S - 1 - r``, with the
    decay ``a_{t+1}`` (1 at ``t = S - 1``) and the input ``dy_t``;
    ``dh_last`` is the initial carry, and chunks of ``chunk`` steps count
    from the end, so a ragged chunk holds the first steps of time.  Then
    ``da_t = g_t * h_{t-1}`` and ``dh0 = a_0 * g_0``, each one rounded
    product."""
    g, _ = rglru_scan_chunked_ref(*_reversed(a, dy), dh_last, chunk=chunk,
                                  fold=fold)
    return _bwd_products(a, h, g.flip(1), h0)


def _reversed(a, dy):
    """The reverse recurrence's decays and inputs in scan order: a read
    one step ahead (1 past the end) and dy, both reversed in time."""
    ahead = torch.cat([a[:, 1:], a.new_ones((a.shape[0], 1, a.shape[2]))],
                      dim=1)
    return ahead.flip(1), dy.flip(1)


def _bwd_products(a, h, g, h0):
    """(da, db, dh0) from the reverse recurrence's g: da_t = g_t h_{t-1}
    (h_{-1} = h0, or 0), db = g, dh0 = a_0 g_0 (None without h0)."""
    first = h0 if h0 is not None else h.new_zeros((h.shape[0], h.shape[2]))
    prev = torch.cat([first[:, None], h[:, :-1]], dim=1)
    da = g * prev
    dh0 = a[:, 0] * g[:, 0] if h0 is not None else None
    return da, g, dh0
