"""The port's RG-LRU scan and recurrent block against the JAX package's, on
the CPU.

The same numpy-seeded inputs go through the JAX Pallas kernel
``rglru_scan_pallas`` (interpreted on the CPU), its oracle
``rglru_scan_ref`` and the port's ``ops.rglru_scan`` on CPU tensors, which
is the plain doubling scan.  Tolerance 1e-5, as ``tests/test_kernels.py``
holds the Pallas kernel against its oracle: float32 throughout, and the
three compute the recurrence in different orders (sequential, the JAX
tree, the doubling scan).  The model-level functions (gates, scan, step,
causal conv, the recurrent block) take parameters carried across from the
reference's reduced recurrentgemma and hold 1e-4 (the gates add block-
diagonal products, summed in another order by XLA and PyTorch).

``rglru_scan_chunked_ref`` is the CUDA kernel's order of operations in
plain PyTorch (the kernel equals it bit for bit on the card); it is held
here against the same JAX functions at 1e-5, and ``plan`` (the kernel's
launch shape) is checked on the shapes the models and chip_smoke.py give
it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as jax_reduced
from repro.kernels.rglru_scan.kernel import rglru_scan_pallas
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_ops
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.models import rglru as jax_rglru
from repro.models.params import ParamTable as JaxParamTable
from repro.parallel.sharding import Sharder
from repro.launch.mesh import make_mesh_of
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_chunked_ref,
                                                rglru_scan_ref)
from repro_torch.models import rglru

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _scan_inputs(seed, b, s, w, lo=0.7, hi=0.999):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, size=(b, s, w)).astype(np.float32)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return a, x, h0


# the reference's own cases (tests/test_kernels.py): partial blocks
# everywhere, a single chunk, and no h0
@pytest.mark.parametrize("b,s,w,bb,bs,bw", [
    (2, 64, 32, 2, 16, 32),
    (3, 100, 48, 2, 32, 16),   # partial blocks everywhere
    (1, 256, 128, 1, 256, 128),  # single chunk
])
def test_plain_scan_matches_the_pallas_kernel(b, s, w, bb, bs, bw):
    a, x, h0 = _scan_inputs(b * s + w, b, s, w)
    want, want_last = rglru_scan_pallas(
        jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0), block_b=bb,
        block_s=bs, block_w=bw, interpret=True)
    oracle, _ = jax_scan_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    got, got_last = rglru_scan(*(torch.from_numpy(v) for v in (a, x, h0)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)


def test_plain_scan_without_h0_matches_the_pallas_kernel():
    a, x, _ = _scan_inputs(7, 2, 37, 24, lo=0.5, hi=0.99)
    want, _ = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(x), block_b=2,
                                block_s=8, block_w=8, interpret=True)
    got, got_last = rglru_scan(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_last.numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("s", [1, 2, 5, 64])
def test_plain_scan_is_the_sequential_recurrence(s):
    """The doubling scan against the recurrence written out, in float64
    (so the reference loop itself is exact to the tolerance)."""
    a, x, h0 = _scan_inputs(s, 2, s, 8)
    h = h0.astype(np.float64)
    want = []
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        want.append(h)
    got, _ = rglru_scan_ref(*(torch.from_numpy(v).double()
                              for v in (a, x, h0)))
    np.testing.assert_allclose(got.numpy(), np.stack(want, axis=1),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bad", ["shape", "h0", "zero"])
def test_ops_validates_its_operands_on_the_cpu(bad):
    a = torch.rand((2, 5, 4))
    b = torch.rand((2, 5, 4))
    h0 = torch.rand((2, 4))
    if bad == "shape":
        b = b[:, :4]
    elif bad == "h0":
        h0 = h0[:, :3]
    else:
        a, b, h0 = a[:, :0], b[:, :0], h0
    with pytest.raises(ValueError):
        rglru_scan(a, b, h0)
    assert scan_kernel.LAUNCHES["rglru_scan"] == 0


# --------------------------------------------------------------------------- #
# the CUDA kernel's order of operations (rglru_scan_chunked_ref) and plan
# --------------------------------------------------------------------------- #
# (b, s, w, with h0): the reference's partial-block case, a ragged S, no
# h0, and S under every chunk but 1
CHUNKED_SHAPES = [(2, 64, 32, True), (3, 100, 48, True), (2, 37, 24, False),
                  (1, 5, 16, True)]


@functools.lru_cache(maxsize=None)
def _pallas_and_oracle(b, s, w, with_h0):
    """Inputs, the Pallas kernel's h (interpreted) and the JAX oracle's."""
    a, x, h0 = _scan_inputs(b * s + w + 11, b, s, w)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want, _ = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(x), jh0,
                                block_b=2, block_s=16, block_w=16,
                                interpret=True)
    oracle, _ = jax_scan_ref(jnp.asarray(a), jnp.asarray(x), jh0)
    return a, x, h0, np.asarray(want), np.asarray(oracle)


@pytest.mark.parametrize("chunk", [1, 7, 32, 64])
@pytest.mark.parametrize("b,s,w,with_h0", CHUNKED_SHAPES)
def test_chunked_ref_matches_the_pallas_kernel(b, s, w, with_h0, chunk):
    """The kernel's order (chunk aggregates, the carry composed in chunk
    order, each chunk again from its carry) within 1e-5 of the Pallas
    kernel and of the JAX oracle: the products of up to 64 decays and the
    composition round differently from both."""
    a, x, h0, want, oracle = _pallas_and_oracle(b, s, w, with_h0)
    got, got_last = rglru_scan_chunked_ref(
        torch.from_numpy(a), torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0), chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    np.testing.assert_array_equal(got_last.numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("s,chunk", [(1, 1), (5, 5), (5, 64), (64, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_ref_with_one_chunk_is_the_sequential_recurrence(
        s, chunk, with_h0):
    """With chunk >= S there is one chunk: its carry is h0 (or 0) and its
    steps are the recurrence in order, each op rounded, bit for bit."""
    a, x, h0 = (torch.from_numpy(v) for v in _scan_inputs(s + 3, 2, s, 8))
    h0 = h0 if with_h0 else None
    h = h0 if h0 is not None else torch.zeros((2, 8))
    want = []
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        want.append(h)
    got, got_last = rglru_scan_chunked_ref(a, x, h0, chunk)
    assert torch.equal(got, torch.stack(want, dim=1))
    assert torch.equal(got_last, want[-1])


@pytest.mark.parametrize("shape,aligned,want", [
    # recurrentgemma-9b's forward: 64 chunks x 32 tiles, 63 chunk slots
    # and 7 group slots
    ((1, 4096, 4096), True, (64, 64, 32, 2048, "bulk", 70)),
    # S under one chunk: one chunk of S steps, no workspace but the ticket
    ((2, 8, 4096), True, (8, 1, 32, 64, "bulk", 0)),
    # W % TILE != 0 and a ragged S: one partial tile
    ((3, 100, 48), True, (64, 2, 1, 6, "bulk", 1)),
    # W % 4 != 0: rows are not 16-byte aligned, so no bulk copies
    ((2, 77, 50), True, (64, 2, 1, 4, "cp_async", 1)),
    # a misaligned base takes the cp.async path too
    ((1, 4096, 4096), False, (64, 64, 32, 2048, "cp_async", 70)),
    ((1, 1, 7), True, (1, 1, 1, 1, "cp_async", 0)),
    # 17 chunks: 16 chunk slots and 2 group slots (groups 0 and 1)
    ((1, 17 * 64, 128), True, (64, 17, 1, 17, "bulk", 18)),
])
def test_plan_picks_the_launch_shape(shape, aligned, want):
    pl = scan_kernel.plan(*shape, aligned=aligned)
    assert (pl.chunk, pl.chunks, pl.tiles, pl.blocks, pl.load,
            pl.slots) == want
    b, s, w = shape
    assert pl.chunk <= scan_kernel.CHUNK
    assert (pl.chunks - 1) * pl.chunk < s <= pl.chunks * pl.chunk
    assert pl.tiles * scan_kernel.TILE >= w
    assert pl.ws_words == 1 + b * pl.slots * w


def test_plan_takes_a_probes_chunk():
    """Probes time shorter chunks: the chunk caps at S and at CHUNK."""
    assert scan_kernel.plan(1, 4096, 4096, chunk=32).chunks == 128
    assert scan_kernel.plan(1, 20, 64, chunk=32).chunk == 20
    with pytest.raises(ValueError, match="chunk"):
        scan_kernel.plan(1, 4096, 4096, chunk=scan_kernel.CHUNK + 1)


def test_chunked_ref_folds_groups_as_the_kernel_does():
    """With fold >= chunks there is one group and the carry composes every
    earlier chunk in order; with fold 8 it composes group aggregates
    first.  The two orders round differently, and both stay within 1e-5
    of the sequential recurrence in float64."""
    a, x, h0 = (torch.from_numpy(v) for v in _scan_inputs(21, 2, 700, 16))
    exact, _ = rglru_scan_ref(a.double(), x.double(), h0.double())
    two, _ = rglru_scan_chunked_ref(a, x, h0, 16)
    one, _ = rglru_scan_chunked_ref(a, x, h0, 16, fold=64)
    for got in (two, one):
        np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                                   **TOL)
    assert torch.equal(two[:, :16 * 8], one[:, :16 * 8])
    assert not torch.equal(two, one)


# --------------------------------------------------------------------------- #
# the model's functions, with the reference's parameters carried across
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def rec_params():
    """(port cfg, port params, JAX cfg, JAX params) of one reduced
    recurrentgemma recurrent block."""
    jcfg = jax_reduced("recurrentgemma-9b")
    table = JaxParamTable(jcfg)
    jax_rglru.add_recurrent_params(table, jcfg, "rec", None)
    jp = table.init(jax.random.key(0))["rec"]
    # a and the gates in their working range: lam from the lru_a rule, but
    # the gate biases random so that r and i are not all 1/2
    rng = np.random.default_rng(1)
    jp = dict(jp, a_gate_b=jnp.asarray(rng.normal(size=jp["a_gate_b"].shape),
                                       jnp.float32),
              x_gate_b=jnp.asarray(rng.normal(size=jp["x_gate_b"].shape),
                                   jnp.float32),
              conv_b=jnp.asarray(rng.normal(size=jp["conv_b"].shape),
                                 jnp.float32))
    p = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    return reduced_config("recurrentgemma-9b"), p, jcfg, jp


def _x(seed, b, s, w):
    return np.random.default_rng(seed).normal(size=(b, s, w)).astype(
        np.float32)


def test_gates_match_the_reference(rec_params):
    cfg, p, jcfg, jp = rec_params
    x = _x(2, 2, 9, cfg.lru_width)
    wa, wb = jax_rglru.rglru_gates(jp, jnp.asarray(x))
    a, b = rglru.rglru_gates(p, torch.from_numpy(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(wa), **MODEL_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(wb), **MODEL_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_model_scan_matches_the_reference_ops(rec_params, with_h0):
    """``models.rglru.rglru_scan`` (gates, then the recurrence through
    ``ops``) against the reference's kernel-backed ``ops.rglru_scan``
    (Pallas, interpreted) and its model oracle."""
    cfg, p, jcfg, jp = rec_params
    x = _x(3, 2, 48, cfg.lru_width)
    h0 = np.random.default_rng(4).normal(
        size=(2, cfg.lru_width)).astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want, want_last = jax_rglru_ops(jp, jnp.asarray(x), jh0, interpret=True)
    oracle, _ = jax_rglru.rglru_scan(jp, jnp.asarray(x), jh0)
    got, got_last = rglru.rglru_scan(
        p, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **MODEL_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **MODEL_TOL)


def test_step_chain_matches_the_full_scan(rec_params):
    """``rglru_step`` token by token gives the full scan's outputs, and
    each step equals the reference's step."""
    cfg, p, jcfg, jp = rec_params
    x = _x(5, 2, 12, cfg.lru_width)
    full, last = rglru.rglru_scan(p, torch.from_numpy(x))
    h = torch.zeros((2, cfg.lru_width))
    jh = jnp.zeros((2, cfg.lru_width))
    for t in range(x.shape[1]):
        y, h = rglru.rglru_step(p, torch.from_numpy(x[:, t:t + 1]), h)
        wy, jh = jax_rglru.rglru_step(jp, jnp.asarray(x[:, t:t + 1]), jh)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **MODEL_TOL)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                   **MODEL_TOL)
    np.testing.assert_allclose(h.numpy(), last.numpy(), **MODEL_TOL)


def test_causal_conv1d_with_a_carried_state(rec_params):
    """The conv over a whole sequence equals the reference's, and equals
    two pieces with the state carried from the first to the second."""
    cfg, p, jcfg, jp = rec_params
    x = _x(6, 2, 11, cfg.lru_width)
    state = _x(7, 2, cfg.conv1d_width - 1, cfg.lru_width)
    for st in (None, state):
        want, want_state = jax_rglru.causal_conv1d(
            jnp.asarray(x), jp["conv_w"], jp["conv_b"],
            None if st is None else jnp.asarray(st))
        got, got_state = rglru.causal_conv1d(
            torch.from_numpy(x), p["conv_w"], p["conv_b"],
            None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        np.testing.assert_array_equal(got_state.numpy(),
                                      np.asarray(want_state))
    whole, whole_state = rglru.causal_conv1d(
        torch.from_numpy(x), p["conv_w"], p["conv_b"])
    first, carry = rglru.causal_conv1d(torch.from_numpy(x[:, :4]),
                                       p["conv_w"], p["conv_b"])
    second, carry = rglru.causal_conv1d(torch.from_numpy(x[:, 4:]),
                                        p["conv_w"], p["conv_b"], carry)
    torch.testing.assert_close(torch.cat([first, second], dim=1), whole,
                               rtol=0, atol=0)
    torch.testing.assert_close(carry, whole_state, rtol=0, atol=0)


@pytest.mark.parametrize("decode", [False, True])
def test_recurrent_block_matches_the_reference(decode):
    """The whole Griffin temporal block (projections, conv, RG-LRU, gelu
    branch, output projection) with its carried state."""
    jcfg = jax_reduced("recurrentgemma-9b")
    table = JaxParamTable(jcfg)
    jax_rglru.add_recurrent_params(table, jcfg, "rec", None)
    jp = table.init(jax.random.key(3))["rec"]
    p = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    cfg = reduced_config("recurrentgemma-9b")
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    s = 1 if decode else 10
    x = _x(8, 2, s, cfg.d_model)
    h0 = _x(9, 1, 2, cfg.lru_width)[0]
    conv = _x(10, 2, cfg.conv1d_width - 1, cfg.lru_width)
    want, (wh, wc) = jax_rglru.recurrent_block(
        jcfg, jp, jnp.asarray(x), shd, h0=jnp.asarray(h0),
        conv_state=jnp.asarray(conv), decode=decode)
    got, (gh, gc) = rglru.recurrent_block(
        cfg, p, torch.from_numpy(x), h0=torch.from_numpy(h0),
        conv_state=torch.from_numpy(conv), decode=decode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **MODEL_TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **MODEL_TOL)
