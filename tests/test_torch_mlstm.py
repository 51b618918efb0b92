"""The port's chunkwise mLSTM and the xLSTM blocks against the JAX
package's, on the CPU.

The same numpy-seeded inputs go through the JAX Pallas kernel
``mlstm_pallas`` (interpreted on the CPU), its oracle ``mlstm_ref`` and the
port's ``ops.mlstm`` on CPU tensors, which is the port of
``mlstm_parallel``.  Tolerance 5e-4 in float32, as ``tests/test_kernels.py``
holds the Pallas kernel against its oracle: the tiles differ (the kernel's
128-row blocks, the oracle's chunks), so the running max and the sums
advance in other steps.  In bfloat16 the port's plain version and the JAX
oracle round at the same places (``q * scale`` and ``a``), but XLA and
PyTorch sum in other orders: 2e-2, as the bf16 attention tests.  The
blocks take parameters carried across from the reference's reduced
xlstm-350m and hold 1e-4 (float32).  Chunkwise against recurrent decode
inside the port holds 2e-3, as the reference's own test of the two
formulations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as jax_reduced
from repro.kernels.mlstm_scan.kernel import mlstm_pallas
from repro.kernels.mlstm_scan.ref import mlstm_ref as jax_mlstm_ref
from repro.launch.mesh import make_mesh_of
from repro.models import xlstm as jax_xlstm
from repro.models.params import ParamTable as JaxParamTable
from repro.parallel.sharding import Sharder
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel
from repro_torch.kernels.mlstm_scan.ops import mlstm
from repro_torch.kernels.mlstm_scan.ref import mlstm_ref
from repro_torch.models import xlstm

TOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, h, d):
    """q, k, v ~ N(0, 1); log_i ~ N(0, 1); log_f = -|N(0, 1)| / 2, as the
    reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    log_i = rng.normal(size=(b, s, h)).astype(np.float32)
    log_f = (-np.abs(rng.normal(size=(b, s, h))) * 0.5).astype(np.float32)
    return q, k, v, log_i, log_f


# the reference's own cases (tests/test_kernels.py)
@pytest.mark.parametrize("b,s,h,d,bq,bk", [
    (1, 64, 2, 16, 16, 16),
    (2, 96, 4, 32, 32, 16),   # partial blocks
    (1, 128, 1, 64, 64, 64),
])
def test_plain_version_matches_the_pallas_kernel(b, s, h, d, bq, bk):
    arrays = _inputs(b * s + d, b, s, h, d)
    jx = [jnp.asarray(a) for a in arrays]
    want = mlstm_pallas(*jx, block_q=bq, block_k=bk, interpret=True)
    oracle = jax_mlstm_ref(*jx, chunk_size=32)
    got = mlstm(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    # the port's plain version over several chunks
    chunked = mlstm_ref(*(torch.from_numpy(a) for a in arrays),
                        chunk_size=32)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("chunk", [32, 1024])
def test_plain_version_pads_a_ragged_tail_as_the_oracle(chunk):
    """S = 100 is no multiple of the chunk: the tail chunk is padded (log_i
    with -1e30, F with its last value).  Held against the oracle only: the
    Pallas kernel reads past S in its last key block, which interpret mode
    fills with NaN (C-ref7)."""
    arrays = _inputs(5, 2, 100, 2, 16)
    want = jax_mlstm_ref(*(jnp.asarray(a) for a in arrays), chunk_size=chunk)
    got = mlstm_ref(*(torch.from_numpy(a) for a in arrays), chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_in_bfloat16_matches_the_oracle():
    arrays = _inputs(11, 2, 70, 2, 32)
    qkv = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]]
    want = jax_mlstm_ref(*qkv, jnp.asarray(arrays[3]), jnp.asarray(arrays[4]),
                         chunk_size=32)
    got = mlstm_ref(*(torch.from_numpy(a).to(torch.bfloat16)
                      for a in arrays[:3]),
                    torch.from_numpy(arrays[3]), torch.from_numpy(arrays[4]),
                    chunk_size=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("bad", ["qkv", "gates", "zero"])
def test_ops_validates_its_operands_on_the_cpu(bad):
    q, k, v, li, lf = (torch.from_numpy(a) for a in _inputs(0, 1, 8, 2, 16))
    if bad == "qkv":
        v = v[:, :7]
    elif bad == "gates":
        li = li[..., :1]
    else:
        q, k, v, li, lf = (x[:, :0] for x in (q, k, v, li, lf))
    with pytest.raises(ValueError):
        mlstm(q, k, v, li, lf)
    assert mlstm_kernel.LAUNCHES["mlstm"] == 0


# --------------------------------------------------------------------------- #
# the blocks, with the reference's parameters carried across
# --------------------------------------------------------------------------- #
def _block_params(kind, seed):
    """(port cfg, port params, JAX cfg, JAX params, shd) of one reduced
    xlstm-350m block of ``kind``."""
    jcfg = jax_reduced("xlstm-350m")
    table = JaxParamTable(jcfg)
    (jax_xlstm._add_mlstm if kind == "mlstm" else jax_xlstm._add_slstm)(
        table, jcfg, "m", 1)
    jp = jax.tree.map(lambda a: a[0], table.init(jax.random.key(seed))["m"])
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    return reduced_config("xlstm-350m"), p, jcfg, jp, shd


def _x(seed, b, s, d, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, d)) *
            scale).astype(np.float32)


def test_mlstm_block_matches_the_reference():
    cfg, p, jcfg, jp, shd = _block_params("mlstm", 0)
    x = _x(1, 2, 20, cfg.d_model)
    want = jax_xlstm.mlstm_block(jcfg, jp, jnp.asarray(x), shd)
    got = xlstm.mlstm_block(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_mlstm_decode_matches_the_reference():
    cfg, p, jcfg, jp, shd = _block_params("mlstm", 1)
    d, inner, h, hd, _ = xlstm._dims(cfg)
    b, s = 2, 6
    x = _x(2, b, s, cfg.d_model)
    state = xlstm.init_cache(cfg, b, 8, "cpu")
    st = {key: state[key][0, 0] for key in ("C", "n", "m", "conv")}
    jst = {key: jnp.asarray(v.numpy()) for key, v in st.items()}
    for t in range(s):
        want, jst = jax_xlstm.mlstm_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                           jst, shd)
        got, st = xlstm.mlstm_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                     st)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for key in ("C", "n", "m", "conv"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]),
                                   **MODEL_TOL)


def test_mlstm_matches_recurrent_decode():
    """Chunkwise block at position t == the recurrent decode state at t
    (the two mLSTM formulations agree inside the port)."""
    cfg, p, _, _, _ = _block_params("mlstm", 0)
    b, s = 2, 12
    x = torch.from_numpy(_x(3, b, s, cfg.d_model, scale=0.1))
    y_par = xlstm.mlstm_block(cfg, p, x)
    d, inner, h, hd, _ = xlstm._dims(cfg)
    state = {"C": torch.zeros((b, h, hd, hd)), "n": torch.zeros((b, h, hd)),
             "m": torch.full((b, h), -1e30),
             "conv": torch.zeros((b, cfg.conv1d_width - 1, inner))}
    outs = []
    for i in range(s):
        y_i, state = xlstm.mlstm_decode(cfg, p, x[:, i:i + 1], state)
        outs.append(y_i)
    torch.testing.assert_close(torch.cat(outs, dim=1), y_par, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("decode", [False, True])
def test_slstm_block_matches_the_reference(decode):
    cfg, p, jcfg, jp, shd = _block_params("slstm", 2)
    s = 1 if decode else 9
    x = _x(4, 2, s, cfg.d_model)
    if decode:
        rng = np.random.default_rng(5)
        state = {k: rng.normal(size=(2, cfg.d_model)).astype(np.float32)
                 for k in ("c", "h", "m")}
        state["n"] = np.abs(rng.normal(size=(2, cfg.d_model))).astype(
            np.float32) + 0.5
        jstate = {k: jnp.asarray(v) for k, v in state.items()}
        tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    else:
        jstate = tstate = None
    want, wst = jax_xlstm.slstm_block(jcfg, jp, jnp.asarray(x), shd,
                                      state=jstate, decode=decode)
    got, gst = xlstm.slstm_block(cfg, p, torch.from_numpy(x), state=tstate,
                                 decode=decode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    for key in ("c", "n", "h", "m"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **MODEL_TOL)
