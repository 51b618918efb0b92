"""Device dispatch of flash attention: a CUDA tensor launches the
hand-written kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``), and any other device raises.  There is no switch that sends
a CUDA tensor to the plain version.  The kernel has no backward yet: on
CUDA operands that require grad, with grad mode on, the call raises
(``repro_torch.kernels.refuse_autograd``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_cap: Optional[float] = None):
    """q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D) in q's dtype."""
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention operands are on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if dev.type == "cuda":      # the wrapper validates
        refuse_autograd("flash_attention", q, k, v)
        return fa_kernel.flash_attention_cuda(
            q, k, v, causal=causal, window=window, scale=scale,
            logit_cap=logit_cap)
    if dev.type != "cpu":
        raise ValueError(f"flash_attention has no kernel for device {dev}")
    fa_kernel.validate(q, k, v)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale, logit_cap=logit_cap)
