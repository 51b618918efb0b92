"""The LM kernels' dispatchers and autograd, on the CPU.

The CUDA kernels have no backward yet, so on a CUDA operand that requires
grad, with grad mode on, ``flash_attention``, ``rglru_scan`` and ``mlstm``
raise (``repro_torch.kernels.refuse_autograd``; the card side is in
``tests/test_torch_cuda.py``).  On CPU tensors they take their plain
versions, which stay differentiable: the gradients through ``ops`` equal
those through the plain version, bit for bit, on inputs made from a numpy
seed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def _inputs(kernel, seed=0):
    """The kernel's operands as float32 leaves that require grad."""
    rng = np.random.default_rng(seed)

    def t(*shape, lo=None, hi=None):
        x = rng.uniform(lo, hi, size=shape) if lo is not None \
            else rng.normal(size=shape)
        return torch.tensor(x, dtype=torch.float32, requires_grad=True)

    if kernel == "flash_attention":
        return t(2, 5, 4, 16), t(2, 7, 2, 16), t(2, 7, 2, 16)
    if kernel == "rglru_scan":
        return t(2, 9, 8, lo=0.7, hi=0.99), t(2, 9, 8), t(2, 8)
    return (t(1, 6, 2, 16), t(1, 6, 2, 16), t(1, 6, 2, 16), t(1, 6, 2),
            torch.tensor(-np.abs(rng.normal(size=(1, 6, 2))) * 0.5,
                         dtype=torch.float32, requires_grad=True))


OPS = {"flash_attention": (fa_ops.flash_attention, flash_attention_ref),
       "rglru_scan": (lambda *x: rg_ops.rglru_scan(*x)[0],
                      lambda *x: rglru_scan_ref(*x)[0]),
       "mlstm": (ml_ops.mlstm, mlstm_ref)}


@pytest.mark.parametrize("kernel", sorted(OPS))
def test_cpu_ops_keep_the_plain_versions_gradients(kernel):
    op, plain = OPS[kernel]
    xs = _inputs(kernel)
    out = op(*xs)
    assert out.grad_fn is not None
    weight = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32))
    got = torch.autograd.grad((out * weight).sum(), xs)
    want = torch.autograd.grad((plain(*xs) * weight).sum(), xs)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
        assert torch.equal(g, w)


def test_refuse_autograd_raises_with_grad_mode_on():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="rglru_scan CUDA kernel has no "
                                           "backward"):
        refuse_autograd("rglru_scan", torch.zeros(3), x, None)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_leaf"])
def test_refuse_autograd_lets_the_kernel_run(mode):
    x = torch.zeros(3, requires_grad=mode != "no_leaf")
    if mode == "no_grad":
        with torch.no_grad():
            refuse_autograd("mlstm", x)
    elif mode == "inference_mode":
        with torch.inference_mode():
            refuse_autograd("mlstm", x)
    else:
        refuse_autograd("mlstm", x, None)
