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
from repro_torch.kernels.flash_attention.ref import flash_attention_split_ref
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


# ------------------------------ the variant and split plan --------------- #
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("sq", [1, 300])
def test_plan_sends_f32_to_the_cuda_core_kernel(sq, d):
    assert fa_kernel.plan(2, sq, 300, 8, 2, d, F32).variant == "simt"


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("sq", [1, 300])
def test_plan_sends_small_head_dims_to_the_cuda_core_kernel(sq, d):
    assert fa_kernel.plan(2, sq, 300, 8, 2, d, BF16).variant == "simt"


@pytest.mark.parametrize("args,variant,n_splits", [
    # qwen3-14b: 48 (padded) q heads over 8 kv heads of 128
    ((2, 1, 24, 48, 8, 128), "decode", 1),          # generate
    ((1, 2048, 2048, 48, 8, 128), "wgmma", 1),      # forward
    ((2, 1, 4096, 48, 8, 128), "decode", 8),        # a long ring
    # recurrentgemma-9b: 16 q heads over 1 kv head of 256, window 2048
    ((2, 1, 24, 16, 1, 256), "decode", 1),          # generate
    ((1, 4096, 4096, 16, 1, 256), "wgmma", 1),      # forward
    ((2, 1, 2048, 16, 1, 256), "decode", 32),       # the full ring
    # a short Sq that still packs: 6 heads x 2 queries
    ((1, 2, 40, 12, 2, 64), "decode", 1),
    ((1, 3, 40, 12, 2, 64), "wgmma", 1),            # 18 rows do not
])
def test_plan_sends_the_model_shapes_to_the_intended_kernels(args, variant,
                                                             n_splits):
    window = 2048 if args[3] == 16 else None
    pl = fa_kernel.plan(*args, BF16, True, window)
    assert pl.variant == variant
    assert len(pl.splits) == n_splits


@pytest.mark.parametrize("sk", [1, 9, 24, 64, 255, 256, 257, 1000, 2048,
                                4096, 5000])
@pytest.mark.parametrize("b,h,kh", [(1, 16, 1), (2, 48, 8), (8, 8, 8)])
@pytest.mark.parametrize("window", [None, 100])
def test_plan_splits_tile_the_key_range_exactly(sk, b, h, kh, window):
    pl = fa_kernel.plan(b, 1, sk, h, kh, 128, BF16, True, window)
    lo, hi = fa_kernel.key_range(1, sk, True, window)
    assert pl.splits[0][0] == lo and pl.splits[-1][1] == hi
    for (a0, a1), (b0, b1) in zip(pl.splits, pl.splits[1:]):
        assert a1 == b0                       # no gap, no overlap
    for i, (a0, a1) in enumerate(pl.splits):
        assert a0 < a1
        if i < len(pl.splits) - 1:
            assert a1 - a0 == pl.chunk
    if len(pl.splits) > 1:
        assert pl.chunk % fa_kernel.DECODE_TILE == 0
    assert b * kh * len(pl.splits) <= max(fa_kernel.H100_SMS, b * kh)


@pytest.mark.parametrize("sk", [1, 2, 9, 24])
def test_plan_keeps_short_decode_calls_to_one_split(sk):
    for h, kh, d in ((48, 8, 128), (16, 1, 256), (8, 2, 64)):
        assert fa_kernel.plan(2, 1, sk, h, kh, d, BF16).splits == ((0, sk),)


def test_plan_key_range_follows_the_window():
    # the query at position 99 sees keys 60..99 under a window of 40
    assert fa_kernel.key_range(1, 100, True, 40) == (60, 100)
    assert fa_kernel.key_range(1, 100, True, None) == (0, 100)
    assert fa_kernel.key_range(1, 100, True, 500) == (0, 100)
    # a window that masks every key still leaves one range to mask
    assert fa_kernel.key_range(1, 100, True, 0) == (99, 100)
    assert fa_kernel.key_range(4, 100, False, 9) == (0, 100)


# ------------------------------ the plain split-K model ------------------ #
def _splits(lo, hi, n):
    """n ranges tiling [lo, hi), all but the last of one length."""
    chunk = -(-(hi - lo) // n)
    return tuple((lo + i * chunk, min(lo + (i + 1) * chunk, hi))
                 for i in range(n) if lo + i * chunk < hi)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n_splits", [1, 2, 7])
@pytest.mark.parametrize("h,kh,d", [(12, 2, 64),     # GQA 6:1
                                    (16, 1, 32)])    # MQA 16:1
def test_split_model_matches_the_jax_kernel(h, kh, d, n_splits, dtype):
    """The decode kernel's split arithmetic (guard, P in two terms of the
    working dtype, merge in split order) against the Pallas kernel,
    interpreted."""
    q, k, v = _qkv(n_splits + h, 2, 1, 100, h, kh, d)
    want = jax_fa(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=True,
                  block_q=128, block_k=128)
    got = flash_attention_split_ref(
        *(torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (q, k, v)),
        splits=_splits(0, 100, n_splits), causal=True)
    assert got.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("sq", [1, 2])
def test_split_model_merges_fully_masked_splits(sq, dtype):
    """A window of 10 over 70 keys, cut into 7 splits of 10: the first
    splits hold no valid key for any query, and merge to nothing."""
    q, k, v = _qkv(sq, 1, sq, 70, 6, 1, 16, scale=2.0)
    want = jax_fa(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=True,
                  window=10, block_q=128, block_k=128)
    got = flash_attention_split_ref(
        *(torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (q, k, v)),
        splits=_splits(0, 70, 7), causal=True, window=10)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("sk,window", [(24, None), (2048, 2048),
                                       (4096, None), (300, 40)])
def test_split_model_on_the_plans_splits_matches_the_plain_version(sk,
                                                                   window):
    """The splits the plan gives a decode call (one at Sk 24, 32 over
    recurrentgemma's ring, 8 over qwen3's 4096), in f32 against the plain
    version at 2e-4."""
    h, kh, d = (16, 1, 32) if window == 2048 else (12, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(sk, 2, 1, sk, h, kh, d))
    pl = fa_kernel.plan(2, 1, sk, h, kh, 128, BF16, True, window)
    got = flash_attention_split_ref(q, k, v, splits=pl.splits, causal=True,
                                    window=window)
    want = flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
