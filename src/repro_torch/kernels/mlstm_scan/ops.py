"""Device dispatch of the chunkwise mLSTM: a CUDA tensor launches the
hand-written kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``), a ``meta`` tensor (the dry run) goes through the same
calls as a CUDA one, its wrapper launching nothing, and any other device
raises.  There is no switch that
sends a CUDA tensor to the plain version.

On CUDA operands of which one requires grad, with grad mode on, the call
goes through ``MlstmFn``: its forward is the same kernel, writing its row
stats, and its backward the hand-written backward kernel
(``backward.py``).  Otherwise the kernel runs as a plain call (serving,
no stats).  On CPU tensors autograd differentiates the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm_scan import backward as mlstm_backward
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel
from repro_torch.kernels.mlstm_scan.ref import mlstm_ref


class MlstmFn(torch.autograd.Function):
    """The chunkwise mLSTM with its gradient on the card: the forward
    launches the kernel of the call's plan with its row stats requested
    (``kernel.mlstm_cuda(with_stats=True)``) and saves q, k, v, log_i,
    log_f, the output and the stats (L, sg); the backward launches the
    backward kernels (``backward.mlstm_bwd_cuda``) on them and returns
    dq, dk, dv, d log_i and d log_f.  Both are looked up on their modules
    at call time."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f):
        out, lse, sg = mlstm_kernel.mlstm_cuda(q, k, v, log_i, log_f,
                                               with_stats=True)
        ctx.save_for_backward(q, k, v, log_i, log_f, out, lse, sg)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, log_i, log_f, out, lse, sg = ctx.saved_tensors
        if dout.stride(3) != 1:     # e.g. the expanded gradient of a sum
            dout = dout.contiguous()
        return mlstm_backward.mlstm_bwd_cuda(q, k, v, log_i, log_f, out,
                                             dout, lse, sg)


def mlstm(q, k, v, log_i, log_f):
    """q,k,v: (B,S,H,D); log_i/log_f: (B,S,H) f32 -> (B,S,H,D) in q's
    dtype."""
    dev = q.device
    if any(x.device != dev for x in (k, v, log_i, log_f)):
        raise ValueError("mlstm operands are on different devices: "
                         f"{[str(x.device) for x in (q, k, v, log_i, log_f)]}")
    if dev.type in ("cuda", "meta"):     # the wrappers validate
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v, log_i, log_f)):
            return MlstmFn.apply(q, k, v, log_i, log_f)
        return mlstm_kernel.mlstm_cuda(q, k, v, log_i, log_f)
    if dev.type != "cpu":
        raise ValueError(f"mlstm has no kernel for device {dev}")
    mlstm_kernel.validate(q, k, v, log_i, log_f)
    return mlstm_ref(q, k, v, log_i, log_f)
