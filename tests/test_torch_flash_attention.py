"""The port's flash attention against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX ``flash_attention``
(Pallas, interpreted on the CPU as ``tests/test_kernels.py`` runs it) and
through the port's ``ops.flash_attention`` on CPU tensors, which is the
plain version.  The port's plain ``models.attention.attention`` is also
held against the reference's on explicit positions (empty slots, the
chunked path).  Tolerances as ``tests/test_kernels.py``: 2e-4 in float32
(the sums run in another order), 2e-2 in bfloat16 (the Pallas kernel keeps
``q * scale`` and ``p`` in f32, the plain version rounds both to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_fa
from repro.models.attention import attention as jax_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import attention

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else dict(
        rtol=2e-4, atol=2e-4)


def _qkv(seed, b, sq, sk, h, kh, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * scale).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))


def _both(arrays, dtype, *, block_q=128, block_k=128, **kw):
    """(JAX Pallas output, port output), both as float32 numpy."""
    want = jax_fa(*(jnp.asarray(a, dtype) for a in arrays), block_q=block_q,
                  block_k=block_k, **kw)
    got = flash_attention(*(torch.from_numpy(a).to(TORCH_DTYPES[dtype])
                            for a in arrays), **kw)
    assert got.dtype == TORCH_DTYPES[dtype]
    assert tuple(got.shape) == arrays[0].shape
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,bq,bk", [
    (1, 64, 64, 4, 4, 32, 16, 16),     # MHA square
    (2, 128, 128, 8, 2, 64, 32, 64),   # GQA 4:1
    (1, 96, 96, 4, 1, 32, 32, 32),     # MQA, non-pow2 seq
    (2, 32, 128, 4, 2, 16, 16, 32),    # cross Sq < Sk (decode-ish)
])
def test_flash_attention_sweep(b, sq, sk, h, kh, d, bq, bk, dtype):
    want, got = _both(_qkv(b * sq + sk + h, b, sq, sk, h, kh, d), dtype,
                      block_q=bq, block_k=bk, causal=True)
    np.testing.assert_allclose(got, want, **_tol(dtype))


@pytest.mark.parametrize("window", [16, 40])
def test_flash_attention_window(window):
    want, got = _both(_qkv(window, 1, 128, 128, 4, 2, 32), jnp.float32,
                      block_q=32, block_k=32, causal=True, window=window)
    np.testing.assert_allclose(got, want, **_tol(jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_softcap(causal):
    want, got = _both(_qkv(7, 2, 64, 64, 4, 4, 32, scale=3.0), jnp.float32,
                      block_q=16, block_k=16, causal=causal, logit_cap=30.0)
    np.testing.assert_allclose(got, want, **_tol(jnp.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("sk", [1, 9, 24])
def test_flash_attention_decode(sk, dtype):
    """One query at the last of Sk positions: the decode call on the
    filled prefix of the ring cache."""
    want, got = _both(_qkv(sk, 2, 1, sk, 8, 2, 16), dtype, causal=True)
    np.testing.assert_allclose(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("sq,sk", [(24, 24), (1, 9), (5, 40)])
def test_flash_attention_full_head_geometry(sq, sk, dtype):
    """qwen3-14b's heads: 48 (40 real, zero-padded) q heads over 8 kv
    heads of 128, with the reference's h // 6 grouping (C-ref4)."""
    q, k, v = _qkv(sq + sk, 1, sq, sk, 48, 8, 128)
    q[:, :, 40:] = 0.0
    # one block over each axis: the Pallas kernel reads past a ragged
    # edge (NaN when interpreted), which the port has no counterpart of
    want, got = _both((q, k, v), dtype, causal=True)
    np.testing.assert_allclose(got, want, **_tol(dtype))


@pytest.mark.parametrize("chunk_size", [1024, 16])
@pytest.mark.parametrize("window", [None, 6])
def test_plain_attention_matches_reference_on_positions(chunk_size, window):
    """The port's plain attention on explicit positions, with empty (-1)
    slots in a ring order, through the single-block path and the chunked
    path (Sk = 40 over chunks of 16, padded)."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(11, 2, 3, 40, 4, 2, 16)
    k_pos = rng.permutation(40).astype(np.int32) - 5   # -5..34: some empty
    k_pos[k_pos < 0] = -1
    q_pos = np.array([20, 30, 34], np.int32)
    kw = dict(causal=True, window=window, logit_cap=20.0,
              chunk_size=chunk_size)
    want = jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                         q_positions=jnp.asarray(q_pos),
                         k_positions=jnp.asarray(k_pos), **kw)
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                    q_positions=torch.from_numpy(q_pos),
                    k_positions=torch.from_numpy(k_pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ops_validates_shapes_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 4, 3, 2, 16))
    with pytest.raises(ValueError, match="do not group"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 4, 4, 2, 16))
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError, match="zero-sized"):
        flash_attention(q[:, :0], k, v)
    launches = dict(fa_kernel.LAUNCHES)
    flash_attention(q, k, v)
    assert fa_kernel.LAUNCHES == launches   # the CPU takes the plain path
