"""The gradient of the port's RG-LRU scan against the JAX package's, on
the CPU.

- ``ref.rglru_scan_bwd_ref``, the backward kernel's plain twin (the
  reverse recurrence as the forward's doubling scan), and
  ``ref.rglru_scan_bwd_chunked_ref``, the backward kernel's order of
  operations (the forward's chunked scan run from the end), against
  ``jax.vjp`` of the reference's ``kernels/rglru_scan/ref.rglru_scan_ref``
  and against torch autograd of the port's ``rglru_scan_ref``, on the same
  numpy-seeded values: float32, max |port - reference| <= 1e-5 * max
  |reference| for da, db and dh0.  Cases: S ragged against the chunk, S
  under one chunk, more chunks than a group folds (the carry's two
  levels), with and without h0, with and without dh_last (the gradient
  of h_last, which enters the reverse recurrence as its initial carry).
- ``torch.autograd.gradcheck`` in float64 of ``ops.RglruScanFn`` with its
  two device kernels swapped, in this test only, for their plain twins:
  the backward is the forward's gradient, h_last's included.
- ``ops.RglruScanFn`` with its backward swapped for the chunked twin
  gives the plain version's gradient through the Function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro_torch.kernels.rglru_scan import backward as scan_backward
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_chunked_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_ref)

REL = 1e-5

# (b, s, w, chunk): S ragged against the chunk (100 = 6 x 16 + 4), S
# under one chunk, and 38 chunks of 8 (more than a group of 8 folds)
SHAPES = {"ragged": (2, 100, 12, 16), "one_chunk": (1, 8, 16, 64),
          "groups": (1, 300, 8, 8)}


def _inputs(b, s, w, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, (b, s, w)).astype(dtype),
            rng.normal(size=(b, s, w)).astype(dtype),
            rng.normal(size=(b, w)).astype(dtype),
            rng.normal(size=(b, s, w)).astype(dtype),
            rng.normal(size=(b, w)).astype(dtype))


def _jax_grads(a, b, h0, dy, dh_last):
    """jax.vjp of the reference's scan: (da, db, dh0 or None)."""
    args = (a, b) if h0 is None else (a, b, h0)
    out, vjp = jax.vjp(jax_scan_ref, *map(jnp.asarray, args))
    ct = (jnp.asarray(dy), jnp.zeros_like(out[1]) if dh_last is None
          else jnp.asarray(dh_last))
    grads = [np.asarray(g) for g in vjp(ct)]
    return grads + [None] * (3 - len(grads))


def _torch_grads(a, b, h0, dy, dh_last):
    """torch autograd of the port's plain scan: (da, db, dh0 or None)."""
    xs = [torch.from_numpy(x).requires_grad_() for x in
          ((a, b) if h0 is None else (a, b, h0))]
    h, h_last = rglru_scan_ref(*xs)
    loss = (h * torch.from_numpy(dy)).sum()
    if dh_last is not None:
        loss = loss + (h_last * torch.from_numpy(dh_last)).sum()
    grads = [g.numpy() for g in torch.autograd.grad(loss, xs)]
    return grads + [None] * (3 - len(grads))


def _close(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= REL * np.abs(w).max()


@pytest.mark.parametrize("against", ["jax_vjp", "torch_autograd"])
@pytest.mark.parametrize("twin", ["plain", "chunked"])
@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_matches_the_reference(shape, h0, dh_last, twin,
                                              against):
    b, s, w, chunk = SHAPES[shape]
    a, x, h_init, dy, dl = _inputs(b, s, w,
                                   seed=sorted(SHAPES).index(shape))
    h_init = h_init if h0 else None
    dl = dl if dh_last else None
    want = (_jax_grads if against == "jax_vjp" else _torch_grads)(
        a, x, h_init, dy, dl)
    ta, tx, tdy = map(torch.from_numpy, (a, x, dy))
    th0 = None if h_init is None else torch.from_numpy(h_init)
    tdl = None if dl is None else torch.from_numpy(dl)
    h, _ = rglru_scan_ref(ta, tx, th0)
    if twin == "plain":
        got = rglru_scan_bwd_ref(ta, h, tdy, tdl, th0)
    else:
        got = rglru_scan_bwd_chunked_ref(ta, h, tdy, tdl, th0, chunk=chunk)
    _close(got, want)


def test_chunked_backward_is_the_chunked_forward_run_from_the_end():
    """The backward's order of operations is the forward kernel's on the
    reversed sequence (decays one step ahead, dh_last as the carry): db
    equals the chunked forward on that sequence bit for bit, and da is
    one rounded product of g and the previous h."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_chunked_ref
    a, x, h_init, dy, dl = map(torch.from_numpy, _inputs(2, 77, 20, seed=4))
    h, _ = rglru_scan_chunked_ref(a, x, h_init, chunk=8)
    da, db, dh0 = rglru_scan_bwd_chunked_ref(a, h, dy, dl, h_init, chunk=8)
    ahead = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g, _ = rglru_scan_chunked_ref(ahead.flip(1), dy.flip(1), dl, chunk=8)
    assert torch.equal(db, g.flip(1))
    prev = torch.cat([h_init[:, None], h[:, :-1]], dim=1)
    assert torch.equal(da, db * prev)
    assert torch.equal(dh0, a[:, 0] * db[:, 0])


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_scan_fn_gradcheck_f64(h0, monkeypatch):
    monkeypatch.setattr(scan_kernel, "rglru_scan_cuda", rglru_scan_ref)
    monkeypatch.setattr(scan_backward, "rglru_scan_bwd_cuda",
                        rglru_scan_bwd_ref)
    a, x, h_init, _, _ = _inputs(2, 11, 3, seed=5, dtype=np.float64)
    xs = [torch.from_numpy(t).requires_grad_() for t in (a, x, h_init)]
    if not h0:
        xs[2] = None

    def fn(a, x, *rest):
        return scan_ops.RglruScanFn.apply(a, x, rest[0] if rest else None)

    assert torch.autograd.gradcheck(fn, [t for t in xs if t is not None],
                                    fast_mode=True)


def test_rglru_scan_fn_with_the_chunked_twin_gives_the_plain_gradient(
        monkeypatch):
    monkeypatch.setattr(scan_kernel, "rglru_scan_cuda", rglru_scan_ref)
    monkeypatch.setattr(
        scan_backward, "rglru_scan_bwd_cuda",
        lambda *args: rglru_scan_bwd_chunked_ref(*args, chunk=16))
    a, x, h_init, dy, dl = _inputs(2, 70, 9, seed=6)
    xs = [torch.from_numpy(t).requires_grad_() for t in (a, x, h_init)]
    h, h_last = scan_ops.RglruScanFn.apply(*xs)
    loss = (h * torch.from_numpy(dy)).sum() + \
        (h_last * torch.from_numpy(dl)).sum()
    got = torch.autograd.grad(loss, xs)
    _close(got, _torch_grads(a, x, h_init, dy, dl))
