"""Device dispatch of the chunkwise mLSTM: a CUDA tensor launches the
hand-written kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``), and any other device raises.  There is no switch that
sends a CUDA tensor to the plain version.  The kernel has no backward
yet: on CUDA operands that require grad, with grad mode on, the call
raises (``repro_torch.kernels.refuse_autograd``)."""
from __future__ import annotations

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel
from repro_torch.kernels.mlstm_scan.ref import mlstm_ref


def mlstm(q, k, v, log_i, log_f):
    """q,k,v: (B,S,H,D); log_i/log_f: (B,S,H) f32 -> (B,S,H,D) in q's
    dtype."""
    dev = q.device
    if any(x.device != dev for x in (k, v, log_i, log_f)):
        raise ValueError("mlstm operands are on different devices: "
                         f"{[str(x.device) for x in (q, k, v, log_i, log_f)]}")
    if dev.type == "cuda":      # the wrapper validates
        refuse_autograd("mlstm", q, k, v, log_i, log_f)
        return mlstm_kernel.mlstm_cuda(q, k, v, log_i, log_f)
    if dev.type != "cpu":
        raise ValueError(f"mlstm has no kernel for device {dev}")
    mlstm_kernel.validate(q, k, v, log_i, log_f)
    return mlstm_ref(q, k, v, log_i, log_f)
