"""The LM kernels' dispatchers and autograd, on the CPU.

On a CUDA operand that requires grad, with grad mode on, each of
``flash_attention``, ``rglru_scan`` and ``mlstm`` goes through its
autograd Function (``FlashAttentionFn``, ``RglruScanFn``, ``MlstmFn``),
whose backward is a hand-written backward kernel (the card side is in
``tests/test_torch_cuda.py``).  On CPU tensors they take their plain
versions, which stay differentiable: the gradients through ``ops`` equal
those through the plain version, bit for bit, on inputs made from a numpy
seed; and ``FlashAttentionFn`` with its kernels swapped for their plain
twins gives the plain version's gradient (within 1e-5 of the largest:
the twin sums by explicit formulas; ``RglruScanFn`` and ``MlstmFn`` are
held so in ``tests/test_torch_rglru_backward.py`` and
``tests/test_torch_mlstm_backward.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import backward as fa_backward
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
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


def test_flash_attention_differentiates_where_rglru_and_mlstm_refuse():
    """Nothing refuses any more: each dispatcher sends a CUDA call that
    needs a gradient through its autograd Function, whose forward and
    backward are the hand-written kernels, and no guard is left."""
    import inspect

    import repro_torch.kernels as kernels
    for ops, fn, fwd, bwd in (
            (fa_ops, "FlashAttentionFn", "flash_attention_cuda",
             "flash_attention_bwd_cuda"),
            (rg_ops, "RglruScanFn", "rglru_scan_cuda", "rglru_scan_bwd_cuda"),
            (ml_ops, "MlstmFn", "mlstm_cuda", "mlstm_bwd_cuda")):
        cls = getattr(ops, fn)
        assert issubclass(cls, torch.autograd.Function)
        assert f"{fn}.apply(" in inspect.getsource(ops)
        assert fwd in inspect.getsource(cls.forward)
        assert bwd in inspect.getsource(cls.backward)
        assert "refuse_autograd" not in inspect.getsource(ops)
    assert not hasattr(kernels, "refuse_autograd")


def test_flash_attention_fn_gives_the_plain_versions_gradient(monkeypatch):
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda",
                        flash_attention_ref)
    monkeypatch.setattr(fa_backward, "flash_attention_bwd_cuda",
                        flash_attention_bwd_ref)
    xs = _inputs("flash_attention", seed=2)
    out = fa_ops.FlashAttentionFn.apply(*xs, True, None, None, None)
    weight = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(out.shape)).astype(np.float32))
    # a non-contiguous incoming gradient (the expanded one of a sum)
    got = torch.autograd.grad((out * weight).sum() + out.sum(), xs)
    want = torch.autograd.grad(
        (flash_attention_ref(*xs) * weight).sum() +
        flash_attention_ref(*xs).sum(), xs)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
