"""Device dispatch of the RG-LRU recurrence: a CUDA tensor launches the
hand-written kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.py``), and any other device raises.  There is no switch that
sends a CUDA tensor to the plain version.  The kernel has no backward
yet: on CUDA operands that require grad, with grad mode on, the call
raises (``repro_torch.kernels.refuse_autograd``).

The reference's ``ops.rglru_scan`` also computes the gates; here the
gates stay in ``models/rglru.py``, which calls this function with
``(a, b, h0)``, so the kernel package does not import the model."""
from __future__ import annotations

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W) f32, h0: (B, W) f32 or None -> (h (B,S,W),
    h_last (B,W))."""
    dev = a.device
    if b.device != dev or (h0 is not None and h0.device != dev):
        raise ValueError("rglru_scan operands are on different devices: "
                         f"{a.device}, {b.device}, "
                         f"{None if h0 is None else h0.device}")
    if dev.type == "cuda":      # the wrapper validates
        refuse_autograd("rglru_scan", a, b, h0)
        return scan_kernel.rglru_scan_cuda(a, b, h0)
    if dev.type != "cpu":
        raise ValueError(f"rglru_scan has no kernel for device {dev}")
    scan_kernel.validate(a, b, h0)
    return rglru_scan_ref(a, b, h0)
