"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a CUDA device every test here skips.  On the
card run ``python -m pytest -m cuda tests/test_torch_cuda.py``; the file
imports neither JAX nor the JAX package, so it runs where only the port
is installed."""
import numpy as np
import pytest
import torch

from repro_torch.configs.geps_events import reduced
from repro_torch.core import events as ev
from repro_torch.core import merge as merge_lib
from repro_torch.core.backend import SpmdBackend
from repro_torch.core.brick import create_store
from repro_torch.core.catalog import MetadataCatalog
from repro_torch.kernels.event_filter import kernel as ef_kernel
from repro_torch.kernels.event_filter import ops as ef_ops
from repro_torch.kernels.event_filter.ref import (calibrate_tracks,
                                                  event_filter_batch_ref,
                                                  event_filter_ref)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

pytestmark = pytest.mark.cuda
BAND_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc "
                    "and run only there")
    return torch.device("cuda")


def _operands(dev, n, t, v, k, cap, seed):
    rng = np.random.default_rng(seed)
    sc = np.abs(rng.normal(size=(n, 8)) * 50).astype(np.float32)
    tr = rng.normal(size=(n, t, v)).astype(np.float32)
    tr[:, :, 0] = rng.exponential(size=(n, t)) * 10
    nt = rng.integers(0, t + 3, size=(n,)).astype(np.int32)  # some 0, some > T
    th = np.stack([rng.uniform(20, 60, k), rng.uniform(5, 25, k),
                   np.floor(rng.uniform(0, 5, k)),
                   rng.uniform(2, 8, k) * t if cap else -np.ones(k)])
    vi = rng.integers(0, 8, size=(k,)).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                 (sc, tr, nt, th.astype(np.float32), vi))


def _band(tr, nt, th, calib):
    pt = calibrate_tracks(tr, calib)[..., 0].double()
    valid = torch.arange(pt.shape[1], device=pt.device)[None, :] < \
        nt[:, None]
    b, d = th[1].double(), th[3].double()
    near = ((pt[..., None] - b).abs() <= BAND_RTOL * b.abs()) & \
        valid[..., None]
    ssum = torch.where(valid, pt, 0.0).sum(-1)
    near_sum = ((ssum[:, None] - d).abs() <= BAND_RTOL * d.abs()) & (d > 0)
    return near.any(dim=(1, 2)) | near_sum.any(dim=1)


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("calib", [0, 4])
@pytest.mark.parametrize("n,t,v,k", [(64, 4096, 63, 17), (37, 1000, 63, 4),
                                     (300, 70, 5, 1), (1, 1, 1, 3)])
def test_batch_kernel_matches_plain_version(cuda, n, t, v, k, calib, cap):
    sc, tr, nt, th, vi = _operands(cuda, n, t, v, k, cap, seed=n + k + calib)
    before = ef_kernel.LAUNCHES["event_filter_batch"]
    mask, var = ef_ops.event_filter_batch(sc, tr, nt, th, vi,
                                          calib_iters=calib)
    torch.cuda.synchronize()
    assert ef_kernel.LAUNCHES["event_filter_batch"] == before + 1
    want, want_var = event_filter_batch_ref(sc, tr, nt, th, var_idx=vi,
                                            calib_iters=calib)
    assert torch.equal(var, want_var)
    rows = (mask != want).any(dim=1)
    if calib == 0 and not cap:
        assert not bool(rows.any())
    else:
        assert not bool((rows & ~_band(tr, nt, th, calib)).any())
    # run to run the kernel gives the same bits
    again, _ = ef_ops.event_filter_batch(sc, tr, nt, th, vi,
                                         calib_iters=calib)
    assert torch.equal(again, mask)


@pytest.mark.parametrize("calib", [0, 4])
def test_single_kernel_matches_plain_version(cuda, calib):
    sc, tr, nt, th, vi = _operands(cuda, 256, 512, 7, 1, False, seed=calib)
    before = ef_kernel.LAUNCHES["event_filter"]
    mask, var = ef_ops.event_filter(sc, tr, nt, th[:, 0].contiguous(), vi,
                                    calib_iters=calib)
    torch.cuda.synchronize()
    assert ef_kernel.LAUNCHES["event_filter"] == before + 1
    a, b, c, d = th[:, 0].tolist()
    want, want_var = event_filter_ref(sc, tr, nt, var_idx=int(vi[0]),
                                      scalar_thresh=a, pt_thresh=b,
                                      min_count=c, sum_cap=d,
                                      calib_iters=calib)
    assert torch.equal(var, want_var)
    diff = mask != want
    if calib:
        diff &= ~_band(tr, nt, th, calib)
    assert not bool(diff.any())


def test_kernel_wrapper_checks_its_operands(cuda):
    sc, tr, nt, th, vi = _operands(cuda, 8, 16, 3, 2, False, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        ef_kernel.event_filter_batch_cuda(sc, tr.transpose(1, 2).contiguous()
                                          .transpose(1, 2), nt, th, vi,
                                          calib_iters=0)
    with pytest.raises(ValueError, match="int32"):
        ef_kernel.event_filter_batch_cuda(sc, tr, nt.long(), th, vi,
                                          calib_iters=0)
    with pytest.raises(ValueError, match="var_idx"):
        ef_kernel.event_filter_batch_cuda(sc, tr, nt, th, vi[:1],
                                          calib_iters=0)
    # a scalar index outside the row selects nothing and reads nothing
    th[0] = -1.0
    th[2] = 0.0
    bad = torch.tensor([8, -1], dtype=torch.int32, device=cuda)
    mask, _ = ef_kernel.event_filter_batch_cuda(sc, tr, nt, th, bad,
                                                calib_iters=0)
    good, _ = ef_kernel.event_filter_batch_cuda(sc, tr, nt, th, vi,
                                                calib_iters=0)
    torch.cuda.synchronize()
    assert not bool(mask.any()) and bool(good.all())


def test_spmd_scan_goes_through_the_kernel(cuda):
    schema = ev.EventSchema.from_config(reduced())
    store = create_store(schema, n_events=96, n_nodes=4,
                         events_per_brick=16, seed=7)
    assert store.bricks[0]["tracks"].is_cuda
    exprs = ["e_total > 40 && count(pt > 15) >= 2",
             "pt_lead > 60 || n_tracks >= 8", "e_t_miss > 25"]
    out = []
    for use_pallas in (True, False):
        spmd = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                           chunk_events=32, use_pallas=use_pallas)
        jids = [spmd.catalog.submit(e, 0, tuple(sorted(store.bricks)))
                for e in exprs]
        before = ef_kernel.LAUNCHES["event_filter_batch"]
        merged, stats = spmd.run_batch(jids)
        out.append(merged)
        assert ef_kernel.LAUNCHES["event_filter_batch"] - before == \
            (stats.packets if use_pallas else 0)
    for a, b in zip(*out):
        assert merge_lib.results_identical(a, b)


# ------------------------------ flash attention -------------------------- #
# bf16: the kernel keeps q * scale and p in f32, the plain version rounds
# both to bf16 (as tests/test_kernels.py:22); f32: sums in another order,
# the plain version's f32 products without TF32
FA_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
          torch.float32: dict(rtol=2e-4, atol=2e-4)}


def _fa_inputs(dev, b, sq, sk, h, kh, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,kw", [
    (2, 1, 24, 48, 8, 128, {}),                    # decode, full width
    (1, 300, 300, 48, 8, 128, {}),                 # prefill, ragged tiles
    (2, 37, 100, 4, 2, 16, {}),                    # sq < sk
    (1, 96, 96, 8, 2, 64, {"window": 40}),
    (2, 64, 64, 4, 4, 32, {"logit_cap": 30.0}),
    (1, 50, 50, 4, 1, 16, {"causal": False, "window": 9}),
])
def test_flash_attention_kernel_matches_plain_version(cuda, b, sq, sk, h,
                                                      kh, d, kw, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(cuda, b, sq, sk, h, kh, d, dtype, seed=sq + sk)
    before = fa_kernel.LAUNCHES["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), **FA_TOL[dtype])
    # run to run the kernel gives the same bits
    assert torch.equal(fa_ops.flash_attention(q, k, v, **kw), out)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """A decode call on the filled prefix of a ring cache: k/v are views
    with the cache's strides, read without a copy."""
    q, _, _ = _fa_inputs(cuda, 2, 1, 1, 48, 8, 128, torch.bfloat16, seed=1)
    cache = torch.randn((2, 2, 256, 8, 128), device=cuda).to(torch.bfloat16)
    k, v = cache[0, :, :9], cache[1, :, :9]
    assert not k.is_contiguous()
    out = fa_kernel.flash_attention_cuda(q, k, v)
    want = flash_attention_ref(q, k.contiguous(), v.contiguous())
    torch.testing.assert_close(out.float(), want.float(),
                               **FA_TOL[torch.bfloat16])


def test_flash_attention_wrapper_checks_its_operands(cuda):
    q, k, v = _fa_inputs(cuda, 1, 4, 4, 4, 2, 16, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dim 24"):
        fa_kernel.flash_attention_cuda(*(x[..., :12].repeat(1, 1, 1, 2)
                                         for x in (q, k, v)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        fa_kernel.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa_kernel.flash_attention_cuda(q.transpose(1, 3).contiguous()
                                       .transpose(1, 3), k, v)


def test_dense_lm_on_the_card_goes_through_the_kernel(cuda, monkeypatch):
    """Reduced qwen3-14b in f32 on the card: forward and decode launch the
    kernel once per layer and agree with the same model on the plain
    attention (f32, 1e-4 as tests/test_torch_lm.py)."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import model_zoo, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config("qwen3-14b")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator(device=cuda).manual_seed(0),
                              cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))

    def run():
        logits, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(2, 8, cuda)
        steps = []
        for s in range(toks.shape[1]):
            step, cache = model.decode_step(params, cache, toks[:, s:s + 1])
            steps.append(step)
        return logits, torch.cat(steps, dim=1)

    before = fa_kernel.LAUNCHES["flash_attention"]
    logits, steps = run()
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] - before == \
        cfg.num_layers * (1 + toks.shape[1])
    monkeypatch.setattr(transformer, "flash_attention", flash_attention_ref)
    plain_logits, plain_steps = run()
    torch.testing.assert_close(logits, plain_logits, rtol=0, atol=1e-4)
    torch.testing.assert_close(steps, plain_steps, rtol=0, atol=1e-4)
