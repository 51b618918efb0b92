"""Device dispatch of the RG-LRU recurrence: a CUDA tensor launches the
hand-written kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``), a ``meta`` tensor (the dry run) goes through the same
calls as a CUDA one, its wrapper launching nothing, and any other device
raises.  There is no switch that
sends a CUDA tensor to the plain version.

On CUDA operands of which one requires grad, with grad mode on, the call
goes through ``RglruScanFn``: its forward is the same kernel and its
backward the hand-written backward kernel (``backward.py``).  Otherwise
the kernel runs as a plain call (serving).  On CPU tensors autograd
differentiates the plain version.

The reference's ``ops.rglru_scan`` also computes the gates; here the
gates stay in ``models/rglru.py``, which calls this function with
``(a, b, h0)``, so the kernel package does not import the model."""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import backward as scan_backward
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


class RglruScanFn(torch.autograd.Function):
    """The RG-LRU scan with its gradient on the card: the forward launches
    the kernel (``kernel.rglru_scan_cuda``) and saves a, h and h0; the
    backward launches the backward kernel
    (``backward.rglru_scan_bwd_cuda``) on them and returns da, db and dh0.
    h_last is returned as its own tensor, so its gradient reaches the
    backward kernel as ``dh_last``.  Both kernels are looked up on their
    modules at call time."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = scan_kernel.rglru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.set_materialize_grads(False)
        return h, h_last.clone()

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        da, db, dh0 = scan_backward.rglru_scan_bwd_cuda(a, h, dh, dh_last,
                                                        h0)
        return da, db, dh0


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W) f32, h0: (B, W) f32 or None -> (h (B,S,W),
    h_last (B,W))."""
    dev = a.device
    if b.device != dev or (h0 is not None and h0.device != dev):
        raise ValueError("rglru_scan operands are on different devices: "
                         f"{a.device}, {b.device}, "
                         f"{None if h0 is None else h0.device}")
    if dev.type in ("cuda", "meta"):     # the wrappers validate
        if torch.is_grad_enabled() and any(
                x is not None and x.requires_grad for x in (a, b, h0)):
            return RglruScanFn.apply(a, b, h0)
        return scan_kernel.rglru_scan_cuda(a, b, h0)
    if dev.type != "cpu":
        raise ValueError(f"rglru_scan has no kernel for device {dev}")
    scan_kernel.validate(a, b, h0)
    return rglru_scan_ref(a, b, h0)
