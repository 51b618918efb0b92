"""Device dispatch of flash attention: a CUDA tensor launches the
hand-written kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``), a ``meta`` tensor (the dry run) goes through the same
calls as a CUDA one, its wrapper launching nothing, and any other device
raises.  There is no switch that sends
a CUDA tensor to the plain version.

On CUDA operands of which one requires grad, with grad mode on, the call
goes through ``FlashAttentionFn``: its forward is the same kernel and its
backward the hand-written backward kernel (``backward.py``).  Otherwise
the kernel runs as a plain call (serving).  On CPU tensors autograd
differentiates the plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import backward as fa_backward
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient on the card: the forward launches
    the kernel of the call's plan with its lse requested
    (``kernel.flash_attention_cuda(with_lse=True)``) and saves q, k, v, the
    output and the (B, H, Sq) f32 lse; the backward launches the backward
    kernels of its plan (``backward.flash_attention_bwd_cuda``) on them and
    returns dq, dk, dv in the operands' dtypes.  Both are looked up on
    their modules at call time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, logit_cap):
        opts = dict(causal=causal, window=window, scale=scale,
                    logit_cap=logit_cap)
        out, lse = fa_kernel.flash_attention_cuda(q, k, v, with_lse=True,
                                                  **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not dout.is_contiguous():  # e.g. the expanded gradient of a
            dout = dout.contiguous()  # sum; the tensor cores read it by TMA
        dq, dk, dv = fa_backward.flash_attention_bwd_cuda(q, k, v, out, dout,
                                                          lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_cap: Optional[float] = None):
    """q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D) in q's dtype."""
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention operands are on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if dev.type in ("cuda", "meta"):     # the wrappers validate
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                          logit_cap)
        return fa_kernel.flash_attention_cuda(
            q, k, v, causal=causal, window=window, scale=scale,
            logit_cap=logit_cap)
    if dev.type != "cpu":
        raise ValueError(f"flash_attention has no kernel for device {dev}")
    fa_kernel.validate(q, k, v)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale, logit_cap=logit_cap)
