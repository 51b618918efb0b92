"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: without a CUDA device every test here skips.  On the
card run ``python -m pytest -m cuda tests/test_torch_cuda.py``; the file
imports neither JAX nor the JAX package, so it runs where only the port
is installed."""
import json

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
from repro_torch.kernels.flash_attention import backward as fa_backward
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_bwd_split_ref,
    flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.mlstm_scan import backward as ml_backward
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan.ref import (mlstm_bwd_ref,
                                                mlstm_bwd_split_ref,
                                                mlstm_ref)
from repro_torch.kernels.rglru_scan import backward as rg_backward
from repro_torch.kernels.rglru_scan import kernel as rg_kernel
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_chunked_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_chunked_ref,
                                                rglru_scan_ref)

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
                                     (300, 70, 5, 1), (1, 1, 1, 3),
                                     # T past one or two rounds of 4096
                                     # tracks (8 loads a thread), and no
                                     # multiple of a round
                                     (16, 4097, 7, 17), (8, 8193, 3, 6),
                                     (5, 9000, 2, 17)])
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


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("n,t,v,k,calib,cap", [
    (64, 4096, 63, 6, 0, False),        # the query path's chunk
    (37, 1000, 63, 17, 4, True),        # ragged, calibrated, with a cap
    (8, 8193, 3, 3, 0, False),          # more rounds than at 512 threads
    (600, 70, 5, 600, 0, False)])       # K past 512: the epilogue's loop
def test_batch_kernel_launch_shapes_match_plain_version(cuda, threads, n, t,
                                                        v, k, calib, cap):
    """Every block size the launch-shape sweep may pick, against the plain
    version: masks equal at calib 0 without a cap, otherwise off only on
    band events (the sum's tree follows the block size)."""
    sc, tr, nt, th, vi = _operands(cuda, n, t, v, k, cap, seed=n + threads)
    before = ef_kernel.LAUNCHES["event_filter_batch"]
    mask, var = ef_ops.event_filter_batch(sc, tr, nt, th, vi,
                                          calib_iters=calib, threads=threads)
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
    again, _ = ef_ops.event_filter_batch(sc, tr, nt, th, vi,
                                         calib_iters=calib, threads=threads)
    assert torch.equal(again, mask)


def test_batch_kernel_refuses_other_launch_shapes(cuda):
    sc, tr, nt, th, vi = _operands(cuda, 8, 16, 3, 2, False, seed=0)
    before = ef_kernel.LAUNCHES["event_filter_batch"]
    for threads in (64, 1024, 384):
        with pytest.raises(ValueError, match="threads a block"):
            ef_kernel.event_filter_batch_cuda(sc, tr, nt, th, vi,
                                              calib_iters=0, threads=threads)
    assert ef_kernel.LAUNCHES["event_filter_batch"] == before


def test_autotuned_spmd_scan_is_identical_to_the_plain_path(cuda):
    """SpmdBackend(autotune=True): one sweep per shape class (each
    candidate: one warm-up and three timed launches), every kernel chunk
    launched with the winner, finals identical to the plain path."""
    from repro_torch.kernels.event_filter import tune
    schema = ev.EventSchema.from_config(reduced())
    store = create_store(schema, n_events=96, n_nodes=4,
                         events_per_brick=16, seed=7)
    exprs = ["e_total > 40 && count(pt > 15) >= 2",
             "pt_lead > 60 || n_tracks >= 8", "e_t_miss > 25"]
    tune.clear_cache()
    out = []
    for kw in ({"use_pallas": True, "autotune": True}, {}):
        spmd = SpmdBackend(MetadataCatalog(store.n_nodes), store,
                           chunk_events=32, **kw)
        jids = [spmd.catalog.submit(e, 0, tuple(sorted(store.bricks)))
                for e in exprs]
        before = ef_kernel.LAUNCHES["event_filter_batch"]
        merged, stats = spmd.run_batch(jids)
        launched = ef_kernel.LAUNCHES["event_filter_batch"] - before
        out.append(merged)
        if kw:
            tuned = spmd.last_autotune
            assert tuned.threads in ef_kernel.LAUNCH_THREADS
            assert tuned.speedup_vs_default >= 1.0
            assert [t for t, _ in tuned.measurements] == [128, 256, 512]
            assert launched == stats.packets + 3 * (1 + tune.REPEATS)
    tune.clear_cache()
    for a, b in zip(*out):
        assert merge_lib.results_identical(a, b)


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


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("calib", [0, 4])
@pytest.mark.parametrize("n,t,v", [(256, 4096, 63), (9, 2049, 5),
                                   (3, 4097, 2)])
def test_single_kernel_edge_cases_repeat_their_bits(cuda, n, t, v, calib,
                                                    cap):
    """B2, the K = 1 form: n_tracks 0 and past T (``_operands``), T no
    multiple of the load batch, with and without a cap; two launches give
    the same bits."""
    sc, tr, nt, th, vi = _operands(cuda, n, t, v, 1, cap, seed=n + t + calib)
    nt[0], nt[-1] = 0, t + 2
    mask, var = ef_kernel.event_filter_cuda(sc, tr, nt, th[:, 0].contiguous(),
                                            vi, calib_iters=calib)
    again, var2 = ef_kernel.event_filter_cuda(sc, tr, nt,
                                              th[:, 0].contiguous(), vi,
                                              calib_iters=calib)
    torch.cuda.synchronize()
    assert torch.equal(mask, again) and torch.equal(var, var2)
    a, b, c, d = th[:, 0].tolist()
    want, want_var = event_filter_ref(sc, tr, nt, var_idx=int(vi[0]),
                                      scalar_thresh=a, pt_thresh=b,
                                      min_count=c, sum_cap=d,
                                      calib_iters=calib)
    assert torch.equal(var, want_var)
    diff = mask != want
    if calib or cap:
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


def test_fleet_on_the_spmd_backend_goes_through_the_kernel(cuda):
    from repro_torch.fabric import Fleet, FragmentRegistry
    from repro_torch.obs.trace import validate_records
    store = create_store(ev.EventSchema.from_config(reduced()),
                         n_events=128, n_nodes=4, events_per_brick=16,
                         seed=3)
    exprs = ["e_total > 40 && count(pt > 15) >= 2", "e_t_miss > 30",
             "pt_lead > 60 || n_tracks >= 8", "e_total > 40 && "
             "count(pt > 15) >= 2", "e_total > 50 && count(pt > 15) >= 3"]
    runs = []
    for use_pallas in (True, False):
        fleet = Fleet(store, 2, registry=FragmentRegistry(), backend="spmd",
                      backend_kwargs={"use_pallas": use_pallas}, obs=True,
                      single_flight=True)
        before = ef_kernel.LAUNCHES["event_filter_batch"]
        gtids = [fleet.submit(e, tenant=f"t{i % 2}", stream=True)
                 for i, e in enumerate(exprs)]
        fleet.drain()
        launched = ef_kernel.LAUNCHES["event_filter_batch"] - before
        scanned = fleet.fleet_stats()["events_scanned"]
        assert launched > 0 if use_pallas else launched == 0
        assert scanned > 0 and not validate_records(fleet.trace_records())
        runs.append([fleet.result(g) for g in gtids])
        fleet.close()
    for a, b in zip(*runs):
        assert a.status == b.status == "SERVED"
        assert a.result.n_processed == store.n_events
        assert merge_lib.results_identical(a.result, b.result)


# ------------------------------ flash attention -------------------------- #
# bf16: the kernels keep q * scale in f32 (the scale is applied to the f32
# scores) while the plain version rounds it to bf16 (as
# tests/test_kernels.py:22); the plain version also rounds p to bf16
# before p.v, while the tensor-core kernels feed p as two bf16 terms (~16
# bits) and the CUDA-core kernel keeps it in f32.  f32: sums in another
# order, the plain version's f32 products without TF32
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
    (2, 1, 24, 16, 1, 256, {}),                    # recurrentgemma decode
    (1, 300, 300, 16, 1, 256, {"window": 128}),    # MQA, D 256, window
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


# the tensor-core kernels: (b, sq, sk, h, kh, d, flags, variant)
TC_CASES = [
    (1, 300, 300, 48, 8, 128, {}, "wgmma"),        # Sq no multiple of 64
    (2, 100, 300, 8, 2, 128, {}, "wgmma"),         # 64 <= Sq < Sk
    (1, 200, 200, 8, 2, 64, {}, "wgmma"),          # head dim 64
    (1, 260, 260, 8, 4, 64, {"window": 70, "logit_cap": 30.0}, "wgmma"),
    (1, 300, 300, 16, 1, 256, {"window": 128}, "wgmma"),
    (1, 150, 150, 4, 1, 128, {"causal": False, "window": 33}, "wgmma"),
    (2, 1, 24, 48, 8, 128, {}, "decode"),          # qwen3-14b generate
    (2, 1, 24, 16, 1, 256, {}, "decode"),          # recurrentgemma generate
    (2, 1, 4096, 48, 8, 128, {}, "decode"),        # split K, qwen3 ring
    (2, 1, 2048, 16, 1, 256, {"window": 2048}, "decode"),   # split K, rg
    (1, 2, 300, 12, 2, 64, {"logit_cap": 20.0}, "decode"),  # 6 heads x 2
    (2, 1, 700, 16, 1, 128, {"window": 100}, "decode"),     # masked splits
    # whisper-medium (16 heads of 64, full MHA): the non-causal 1500-frame
    # encoder, cross-attention over 1500 keys at decode (ragged last tile,
    # 4 splits) and in the decoder's 448-token forward
    (2, 1500, 1500, 16, 16, 64, {"causal": False}, "wgmma"),
    (2, 1, 1500, 16, 16, 64, {"causal": False}, "decode"),
    (1, 448, 1500, 16, 16, 64, {"causal": False}, "wgmma"),
    # pixtral-12b and phi3.5-moe: 32 q heads over 8 kv heads of 128
    (1, 300, 300, 32, 8, 128, {}, "wgmma"),
    (2, 1, 24, 32, 8, 128, {}, "decode"),
]


@pytest.mark.parametrize("b,sq,sk,h,kh,d,kw,variant", TC_CASES)
def test_tensor_core_kernels_match_plain_version(cuda, b, sq, sk, h, kh, d,
                                                 kw, variant):
    """Each bf16 variant at the shapes chip_smoke.py's FA_CASES give it,
    against the plain version in f32 on the same values (FA_TOL bf16), one
    launch count a call, and the same bits twice."""
    q, k, v = _fa_inputs(cuda, b, sq, sk, h, kh, d, torch.bfloat16,
                         seed=sq + sk + d)
    assert fa_kernel.plan(b, sq, sk, h, kh, d, torch.bfloat16,
                          kw.get("causal", True),
                          kw.get("window")).variant == variant
    before = dict(fa_kernel.VARIANT_CALLS)
    launches = fa_kernel.LAUNCHES["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] == launches + 1
    assert fa_kernel.VARIANT_CALLS[variant] == before[variant] + 1
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), want, **FA_TOL[torch.bfloat16])
    assert torch.equal(fa_ops.flash_attention(q, k, v, **kw), out)


@pytest.mark.parametrize("n,h,kh,d", [(9, 48, 8, 128),      # one split
                                      (2000, 48, 8, 128),   # split K
                                      (2048, 16, 1, 256)])
def test_decode_kernel_reads_the_ring_cache_view(cuda, n, h, kh, d):
    """The decode call on the filled prefix k_i[:, :n] of a (B, W, K, D)
    ring cache, read through its strides without a copy, on one split
    and on the split-K path with its merge."""
    q, _, _ = _fa_inputs(cuda, 2, 1, 1, h, kh, d, torch.bfloat16, seed=n)
    cache = torch.randn((2, 2, 2048, kh, d), device=cuda).to(torch.bfloat16)
    k, v = cache[0, :, :n], cache[1, :, :n]
    assert not k.is_contiguous() or n == 2048
    out = fa_kernel.flash_attention_cuda(q, k, v)
    want = flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, **FA_TOL[torch.bfloat16])


def test_tensor_core_wrapper_refuses_misaligned_operands(cuda):
    q, k, v = _fa_inputs(cuda, 1, 128, 128, 4, 2, 64, torch.bfloat16, seed=0)
    wide = torch.zeros((1, 128, 2, 68), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="misaligned"):   # stride 136 bytes
        fa_kernel.flash_attention_cuda(q, wide[..., :64], v)
    flat = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)                      # base + 2 bytes
    with pytest.raises(ValueError, match="misaligned"):
        fa_kernel.flash_attention_cuda(shifted, k, v)
    with pytest.raises(ValueError, match="misaligned"):   # the decode kernel
        fa_kernel.flash_attention_cuda(shifted[:, :1], k, v)


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-9b"])
def test_bf16_models_take_the_tensor_core_kernels(cuda, monkeypatch, arch):
    """Reduced dense and recurrent models in bf16 at head dim 128: every
    attention call of forward takes the wgmma kernel and every call of a
    decode step the decode kernel, and each agrees with the plain version
    in f32 on its own inputs (FA_TOL bf16)."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import model_zoo, transformer
    cfg = reduced_config(arch, head_dim=128, dtype="bfloat16",
                         param_dtype="bfloat16")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator(device=cuda).manual_seed(0),
                              cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 80), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    kernel = transformer.flash_attention
    calls = []

    def checked(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(out.float(), want,
                                   **FA_TOL[torch.bfloat16])
        calls.append(q.shape[1])
        return out

    monkeypatch.setattr(transformer, "flash_attention", checked)
    before = dict(fa_kernel.VARIANT_CALLS)
    model.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    n_fwd = len(calls)
    assert n_fwd > 0
    assert fa_kernel.VARIANT_CALLS["wgmma"] - before["wgmma"] == n_fwd
    cache = model.init_cache(2, 32, cuda)
    for s in range(6):
        _, cache = model.decode_step(params, cache, toks[:, s:s + 1])
    torch.cuda.synchronize()
    got = {k: fa_kernel.VARIANT_CALLS[k] - before[k] for k in before}
    assert got == {"wgmma": n_fwd, "decode": len(calls) - n_fwd, "simt": 0}
    assert len(calls) - n_fwd == 6 * n_fwd


@pytest.mark.parametrize("arch,head_dim", [("whisper-medium", 64),
                                           ("phi3.5-moe-42b-a6.6b", 128)])
def test_encdec_and_moe_models_take_the_tensor_core_kernels(cuda,
                                                           monkeypatch,
                                                           arch, head_dim):
    """Reduced whisper (encoder, causal decoder, cross-attention) and
    phi3.5-moe in bf16 at their head dims: every attention call of the
    forward takes the wgmma kernel and every call of a decode step the
    decode kernel, each within FA_TOL of the plain version in f32 on its
    own inputs; whisper's cross-attention calls are non-causal."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo, transformer
    cfg = reduced_config(arch, head_dim=head_dim, dtype="bfloat16",
                         param_dtype="bfloat16", encoder_seq_len=300) \
        if arch == "whisper-medium" else \
        reduced_config(arch, head_dim=head_dim, dtype="bfloat16",
                       param_dtype="bfloat16")
    model = model_zoo.build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.table.init(gen, cuda)
    # 128 tokens: two of phi3.5-moe's reduced routing groups of 64
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                         generator=gen)
    kernel = transformer.flash_attention
    calls = []

    def checked(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.testing.assert_close(out.float(), want,
                                   **FA_TOL[torch.bfloat16])
        calls.append(kw["causal"])
        return out

    monkeypatch.setattr(transformer, "flash_attention", checked)
    before = dict(fa_kernel.VARIANT_CALLS)
    enc_dec = cfg.is_encoder_decoder
    batch = {"tokens": toks}
    with torch.inference_mode():
        if enc_dec:
            gen.manual_seed(1)
            cache, batch["frames"] = serve.encoder_cache(
                cfg, model, params, 2, gen, cache_len=32)
        else:
            cache = model.init_cache(2, 32, cuda)
        model.forward(params, batch)
        torch.cuda.synchronize()
        n_fwd = len(calls)
        # whisper: the encoder twice (the cross cache, then the forward's),
        # then self- and cross-attention in each decoder layer
        assert n_fwd == (2 * (cfg.num_encoder_layers + cfg.num_layers)
                         if enc_dec else cfg.num_layers)
        for s in range(6):
            _, cache = model.decode_step(params, cache, toks[:, s:s + 1])
        torch.cuda.synchronize()
    got = {k: fa_kernel.VARIANT_CALLS[k] - before[k] for k in before}
    per_step = (2 if enc_dec else 1) * cfg.num_layers
    assert got == {"wgmma": n_fwd, "decode": 6 * per_step, "simt": 0}
    if enc_dec:
        # decode: the causal self-attention, then the non-causal cross
        assert calls[n_fwd:n_fwd + 2] == [True, False]


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


# ------------------------------ RG-LRU scan ------------------------------ #
# (b, s, w, with h0): recurrentgemma-9b's forward with and without h0, a
# ragged S, one step, S under one chunk, W no multiple of 4 (the cp.async
# load path), a ragged S over a partial last tile of the bulk path, two
# batch rows whose chunks form groups on the cp.async path, and more than
# 16 groups (the carry reads group aggregates in two batches)
SCAN_SHAPES = [(1, 4096, 4096, False), (1, 4096, 4096, True),
               (3, 100, 48, True), (2, 1, 7, True), (2, 8, 4096, True),
               (2, 77, 50, True), (2, 200, 4100, False),
               (2, 1500, 300, True), (1, 9000, 128, True)]


def _scan_inputs(dev, b, s, w, with_h0):
    g = torch.Generator(device=dev).manual_seed(s + w)
    a = torch.rand((b, s, w), generator=g, device=dev) * 0.3 + 0.7
    x = torch.randn((b, s, w), generator=g, device=dev)
    h0 = torch.randn((b, w), generator=g, device=dev) if with_h0 else None
    return a, x, h0


@pytest.mark.parametrize("b,s,w,with_h0", SCAN_SHAPES)
def test_rglru_scan_kernel_matches_plain_version(cuda, b, s, w, with_h0):
    """f32 within 1e-5: the kernel composes chunk aggregates and runs each
    chunk in order, the plain version is a doubling scan."""
    a, x, h0 = _scan_inputs(cuda, b, s, w, with_h0)
    before = rg_kernel.LAUNCHES["rglru_scan"]
    h, last = rg_ops.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rg_kernel.LAUNCHES["rglru_scan"] == before + 1
    want, want_last = rglru_scan_ref(a, x, h0)
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last, want_last, rtol=1e-5, atol=1e-5)
    assert torch.equal(rg_ops.rglru_scan(a, x, h0)[0], h)


@pytest.mark.parametrize("b,s,w,with_h0", SCAN_SHAPES)
def test_rglru_scan_kernel_equals_its_chunked_order(cuda, b, s, w, with_h0):
    """The kernel equals rglru_scan_chunked_ref at its plan's chunk (the
    same rounded operations in the same order, as torch ops on the card)
    bit for bit, and two launches give the same bits."""
    a, x, h0 = _scan_inputs(cuda, b, s, w, with_h0)
    pl = rg_kernel.plan(b, s, w)
    h, last = rg_kernel.rglru_scan_cuda(a, x, h0)
    again, _ = rg_kernel.rglru_scan_cuda(a, x, h0)
    want, want_last = rglru_scan_chunked_ref(a, x, h0, pl.chunk)
    torch.cuda.synchronize()
    assert torch.equal(h, want) and torch.equal(last, want_last)
    assert torch.equal(again, h)


def test_rglru_scan_misaligned_base_takes_the_cp_async_path(cuda):
    """a and b one float past a 16-byte boundary: no bulk copies, the same
    bits as the chunked order."""
    b, s, w = 1, 300, 256
    a0, x0, h0 = _scan_inputs(cuda, b, s * w + 1, 1, True)
    a = a0.flatten()[1:].view(b, s, w)
    x = x0.flatten()[1:].view(b, s, w)
    h0 = h0.expand(b, w).contiguous()
    assert rg_kernel.plan(b, s, w, aligned=a.data_ptr() % 16 == 0).load \
        == "cp_async"
    h, _ = rg_kernel.rglru_scan_cuda(a, x, h0)
    want, _ = rglru_scan_chunked_ref(a, x, h0, rg_kernel.plan(b, s, w).chunk)
    torch.cuda.synchronize()
    assert torch.equal(h, want)


def test_rglru_scan_kernel_under_cuda_graph_replay(cuda):
    """Two scans captured in one CUDA graph and replayed on new inputs:
    every replay starts from a zeroed ticket and flags and gives the
    chunked order's bits."""
    shapes = [(1, 1000, 512, True), (2, 300, 260, False)]
    static = [_scan_inputs(cuda, *sh) for sh in shapes]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a, x, h0 in static:
            rg_kernel.rglru_scan_cuda(a, x, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [rg_kernel.rglru_scan_cuda(a, x, h0)[0]
                for a, x, h0 in static]
    for seed in range(3):
        g = torch.Generator(device=cuda).manual_seed(100 + seed)
        for a, x, h0 in static:
            a.copy_(torch.rand(a.shape, generator=g, device=cuda) * 0.3 + 0.7)
            x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        for (a, x, h0), out in zip(static, outs):
            want, _ = rglru_scan_chunked_ref(
                a, x, h0, rg_kernel.plan(*a.shape).chunk)
            assert torch.equal(out, want)


def test_rglru_scan_wrapper_checks_its_operands(cuda):
    a = torch.rand((2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        rg_kernel.rglru_scan_cuda(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        rg_kernel.rglru_scan_cuda(a.transpose(0, 1), a.transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rg_kernel.rglru_scan_cuda(a, a, torch.zeros((2, 16)))


# ------------------------------ mLSTM ------------------------------------ #
def _mlstm_inputs(dev, b, s, h, d, dtype, seed, i_shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    log_i = torch.randn((b, s, h), generator=g, device=dev) + i_shift
    log_f = -torch.randn((b, s, h), generator=g, device=dev).abs() * 0.5
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("b,s,h,d,dtype", [
    (1, 2048, 4, 512, torch.bfloat16),     # xlstm-350m's forward shape
    (1, 64, 2, 16, torch.float32),
    (2, 100, 2, 16, torch.float32),        # S no multiple of the tile
    (2, 96, 4, 32, torch.float32),
    (1, 100, 1, 64, torch.float32),
    (2, 70, 2, 512, torch.float32),
])
def test_mlstm_kernel_matches_plain_version(cuda, b, s, h, d, dtype):
    """Against the plain version evaluated in f32 on the same values (the
    kernel's arithmetic, and the Pallas kernel's): 5e-4 in f32 as
    tests/test_kernels.py, 2e-2 for a bf16 output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _mlstm_inputs(cuda, b, s, h, d, dtype, seed=s + d)
    before = ml_kernel.LAUNCHES["mlstm"]
    out = ml_ops.mlstm(*ops)
    torch.cuda.synchronize()
    assert ml_kernel.LAUNCHES["mlstm"] == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    q, k, v, log_i, log_f = ops
    want = mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f)
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-4
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
    assert torch.equal(ml_ops.mlstm(*ops), out)


# the tensor-core kernel (bf16, head dim 512) off xlstm-350m's shape: a
# ragged S, S under one 64-row tile, two batch rows, and input gates low
# enough that exp(-m) wins the normaliser
@pytest.mark.parametrize("b,s,h,i_shift", [(1, 300, 4, 0.0), (1, 37, 4, 0.0),
                                           (2, 512, 4, 0.0),
                                           (1, 300, 4, -3.0),
                                           # one tile exactly, one row past
                                           # it, a long call of no split
                                           (1, 64, 1, 0.0), (3, 65, 2, 0.0),
                                           (1, 4096, 4, 0.0)])
def test_mlstm_tensor_core_kernel_matches_plain_version(cuda, b, s, h,
                                                        i_shift):
    """Against the plain version in f32 on the same values within 2e-2
    (chip_smoke.py's MLSTM_TOL for a bf16 output); one call a launch on
    the tensor-core kernel; two launches give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _mlstm_inputs(cuda, b, s, h, 512, torch.bfloat16, seed=s + b,
                        i_shift=i_shift)
    before = dict(ml_kernel.VARIANT_CALLS)
    out = ml_ops.mlstm(*ops)
    torch.cuda.synchronize()
    assert ml_kernel.plan(b, s, h, 512, torch.bfloat16).variant == "wgmma"
    assert ml_kernel.VARIANT_CALLS["wgmma"] == before["wgmma"] + 1
    q, k, v, log_i, log_f = ops
    want = mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f)
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
    assert torch.equal(ml_ops.mlstm(*ops), out)


def test_mlstm_tensor_core_kernel_reads_strided_views(cuda):
    """q, k, v as views of one (B, S, 3, H, 512) bf16 projection."""
    qkv = torch.randn((2, 200, 3, 4, 512), device=cuda).bfloat16()
    q, k, v = qkv.unbind(2)
    _, _, _, log_i, log_f = _mlstm_inputs(cuda, 2, 200, 4, 512,
                                          torch.bfloat16, seed=5)
    out = ml_kernel.mlstm_cuda(q, k, v, log_i, log_f)
    want = mlstm_ref(q.float(), k.float(), v.float(), log_i, log_f)
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
    assert torch.equal(ml_kernel.mlstm_cuda(q, k, v, log_i, log_f), out)


def test_mlstm_tensor_core_wrapper_refuses_misaligned_operands(cuda):
    """TMA needs 16-byte aligned bases and strides: the wrapper raises
    rather than copying."""
    big = torch.randn((1, 64, 4, 520), device=cuda).bfloat16()
    q = big[..., 1:513]                     # base 2 bytes off
    k = v = big[..., 8:520]
    _, _, _, log_i, log_f = _mlstm_inputs(cuda, 1, 64, 4, 512,
                                          torch.bfloat16, seed=6)
    with pytest.raises(ValueError, match="misaligned"):
        ml_kernel.mlstm_cuda(q, k, v, log_i, log_f)


def test_mlstm_kernel_reads_strided_views(cuda):
    """q, k, v as views of one (B, S, 3, H, D) projection."""
    qkv = torch.randn((2, 40, 3, 2, 32), device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _, _, _, log_i, log_f = _mlstm_inputs(cuda, 2, 40, 2, 32, torch.float32,
                                          seed=3)
    out = ml_kernel.mlstm_cuda(q, k, v, log_i, log_f)
    want = mlstm_ref(q.contiguous(), k.contiguous(), v.contiguous(), log_i,
                     log_f)
    torch.testing.assert_close(out, want, rtol=5e-4, atol=5e-4)


def test_mlstm_wrapper_checks_its_operands(cuda):
    q, k, v, li, lf = _mlstm_inputs(cuda, 1, 8, 2, 16, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dim 24"):
        ml_kernel.mlstm_cuda(*(torch.zeros((1, 8, 2, 24), device=cuda)
                               for _ in range(3)), li, lf)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ml_kernel.mlstm_cuda(q.half(), k.half(), v.half(), li, lf)
    with pytest.raises(ValueError, match="log_i must be float32"):
        ml_kernel.mlstm_cuda(q, k, v, li.double(), lf)
    with pytest.raises(ValueError, match="contiguous head dim"):
        ml_kernel.mlstm_cuda(q.transpose(1, 3).contiguous().transpose(1, 3),
                             k, v, li, lf)


# ------------------------------ recurrent LMs ---------------------------- #
@pytest.mark.parametrize("arch,atol", [("recurrentgemma-9b", 2e-3),
                                       ("xlstm-350m", 1e-4)])
def test_recurrent_lm_on_the_card_goes_through_its_kernels(cuda, monkeypatch,
                                                           arch, atol):
    """Reduced recurrentgemma-9b / xlstm-350m in f32 on the card: forward
    launches rglru_scan once per recurrent layer and flash_attention once
    per attention layer (recurrentgemma), mlstm once per mLSTM layer
    (xlstm); decode launches flash_attention per attention layer and step
    and no scan kernel.  Both agree with the same model on the plain
    versions, within tests/test_torch_recurrent_lm.py's logit tolerance
    (2e-3 where the attention is nearly hard, 1e-4 without attention)."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import hybrid, model_zoo, rglru, transformer
    from repro_torch.models import xlstm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator(device=cuda).manual_seed(0),
                              cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))

    def run():
        logits, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(2, 32, cuda)
        steps = []
        for s in range(toks.shape[1]):
            step, cache = model.decode_step(params, cache, toks[:, s:s + 1])
            steps.append(step)
        return logits, torch.cat(steps, dim=1)

    counters = (fa_kernel.LAUNCHES, rg_kernel.LAUNCHES, ml_kernel.LAUNCHES)
    before = [dict(c) for c in counters]
    logits, steps = run()
    torch.cuda.synchronize()
    got = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c}
    if cfg.family == "hybrid":
        unit, n_super, tail = hybrid._pattern(cfg)
        n_attn = n_super * unit.count("attn")
        n_rec = n_super * unit.count("rec") + tail.count("rec")
        want = {"flash_attention": n_attn * (1 + toks.shape[1]),
                "rglru_scan": n_rec, "mlstm": 0}
    else:
        unit, n_super = xlstm._pattern(cfg)
        want = {"flash_attention": 0, "rglru_scan": 0,
                "mlstm": n_super * unit.count("mlstm")}
    assert got == want
    monkeypatch.setattr(transformer, "flash_attention", flash_attention_ref)
    monkeypatch.setattr(rglru, "linear_scan", rglru_scan_ref)
    monkeypatch.setattr(xlstm, "mlstm_scan", mlstm_ref)
    plain_logits, plain_steps = run()
    torch.testing.assert_close(logits, plain_logits, rtol=0, atol=atol)
    torch.testing.assert_close(steps, plain_steps, rtol=0, atol=atol)


# --------------------------- flash backward ----------------------------- #
# max |kernel - plain| <= BWD_TOL * max |plain| per gradient, the plain
# backward (flash_attention_bwd_ref) evaluated in f32 on the same values:
# bf16 rounds the gradients (and the forward's output, which delta reads),
# f32 sums in another order with TF32 off
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
BWD_CASES = [
    (2, 96, 96, 4, 2, 64, {}),                     # causal, ragged tiles
    (1, 70, 70, 4, 2, 64, {"causal": False}),
    (2, 37, 100, 4, 2, 128, {}),                   # sq < sk
    (1, 130, 130, 4, 1, 128, {"window": 40}),
    (1, 64, 64, 2, 2, 64, {"logit_cap": 5.0}),
    (1, 33, 33, 32, 2, 128, {}),                   # GQA 16:1
    (1, 40, 40, 6, 1, 256, {"window": 17}),        # GQA 6:1, D 256
    (1, 5, 3, 2, 1, 64, {"causal": False, "window": 1}),  # masked rows
    (2, 19, 19, 4, 2, 16, {}),
    (1, 45, 45, 2, 1, 32, {"logit_cap": 3.0}),
]


def _bwd(q, k, v, **kw):
    """(out, dq, dk, dv) through ops.flash_attention under autograd, with
    a seeded incoming gradient, and that gradient."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa_ops.flash_attention(q, k, v, **kw)
    g = torch.Generator(device=q.device).manual_seed(7)
    dout = torch.randn(out.shape, generator=g, device=q.device).to(q.dtype)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    return out, grads, dout


def _bwd_variant(q, k):
    """The backward variant ``backward.plan`` gives these operands."""
    return fa_backward.plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                            k.shape[2], q.shape[3], q.dtype).variant


def _held_to_plain(got, want, dtype):
    """dq, dk, dv each within BWD_TOL of the largest plain value."""
    for name, x, w in zip("qkv", got, want):
        assert x.dtype == dtype and bool(torch.isfinite(x).all()), name
        err = float((x.detach().float() - w).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.abs().max()) + 1e-30, \
            (name, err, float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,kw", BWD_CASES)
def test_flash_backward_kernel_matches_plain_version(cuda, b, sq, sk, h, kh,
                                                     d, kw, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(cuda, b, sq, sk, h, kh, d, dtype, seed=sq * 3 + d)
    variant = _bwd_variant(q, k)
    assert variant == ("wgmma" if dtype == torch.bfloat16 and
                       d in fa_backward.TC_HEAD_DIMS else "simt")
    before = dict(fa_backward.LAUNCHES)
    calls = dict(fa_backward.VARIANT_CALLS)
    out, got, dout = _bwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_backward.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert fa_backward.VARIANT_CALLS[variant] == calls[variant] + 1
    want = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out,
                                                        dout)), **kw)
    _held_to_plain(got, want, dtype)
    # run to run the kernels give the same bits
    out2, lse = fa_kernel.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    assert torch.equal(out2, out)
    again = fa_backward.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                 **kw)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


# the tensor-core backward off the models' shapes: head dim 64 and 128,
# Sq and Sk no multiple of the 64/128-row tiles, Sq < Sk, windows, caps,
# not causal, G = 1 (one run: bf16 straight from the dK/dV kernel), 5 and
# 16 (runs of heads summed by the sum kernel), rows that see no key, and a
# run through many query tiles of the ring; then head dim 256 (the
# kernels whose warpgroups split the products by role): MQA 16:1 at a
# ragged S, a window, a softcap, S under one 64-row tile, G = 1, Sq < Sk,
# not causal, and rows that see no key
TC_BWD_CASES = [
    (2, 100, 100, 4, 4, 64, {}),
    (1, 130, 200, 10, 2, 128, {}),
    (1, 300, 300, 32, 2, 128, {"window": 70}),
    (2, 77, 77, 16, 1, 64, {"logit_cap": 5.0}),
    (1, 150, 150, 5, 1, 128, {"causal": False}),
    (1, 200, 200, 16, 1, 128, {"window": 33, "logit_cap": 20.0}),
    (1, 190, 190, 4, 2, 64, {"causal": False, "window": 50}),
    (1, 5, 3, 2, 1, 64, {"causal": False, "window": 1}),
    (1, 7, 3, 16, 1, 128, {"causal": False, "window": 1}),
    (2, 1024, 1024, 8, 2, 128, {}),
    (1, 300, 300, 16, 1, 256, {}),
    (1, 260, 260, 4, 1, 256, {"window": 70}),
    (2, 130, 130, 4, 2, 256, {"logit_cap": 30.0}),
    (1, 40, 40, 6, 1, 256, {}),
    (2, 17, 17, 2, 1, 256, {"window": 5}),
    (1, 200, 200, 4, 4, 256, {}),
    (2, 70, 200, 8, 1, 256, {}),
    (1, 150, 190, 8, 2, 256, {"causal": False, "window": 50}),
    (1, 7, 3, 16, 1, 256, {"causal": False, "window": 1}),
]


@pytest.mark.parametrize("b,sq,sk,h,kh,d,kw", TC_BWD_CASES)
def test_tensor_core_backward_matches_plain_version(cuda, b, sq, sk, h, kh,
                                                    d, kw):
    """The wgmma variant against the plain backward in f32 on the same
    values (BWD_TOL bf16), dk and dv also against the plain backward
    summed in the plan's runs of heads (flash_attention_bwd_split_ref),
    its lse from the forward launch; rows that see no key get a dq of
    exactly 0; two launches give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(cuda, b, sq, sk, h, kh, d, torch.bfloat16,
                         seed=sq + 7 * h + d)
    pl = fa_backward.plan(b, sq, sk, h, kh, d, torch.bfloat16)
    assert pl.variant == "wgmma"
    calls = fa_backward.VARIANT_CALLS["wgmma"]
    out, got, dout = _bwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_backward.VARIANT_CALLS["wgmma"] == calls + 1
    f32 = [x.float() for x in (q, k, v, out, dout)]
    _held_to_plain(got, flash_attention_bwd_ref(*f32, **kw), torch.bfloat16)
    _, dk_runs, dv_runs = flash_attention_bwd_split_ref(
        *f32, splits=pl.splits, **kw)
    _held_to_plain(got[1:], (dk_runs, dv_runs), torch.bfloat16)
    if kw.get("window") == 1:      # queries from Sk on see no key
        assert float(got[0][:, sk:].float().abs().max()) == 0.0
    _, lse = fa_kernel.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    a = fa_backward.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    b2 = fa_backward.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    for x, y, z in zip(got, a, b2):
        assert torch.equal(x, y) and torch.equal(y, z)


@pytest.mark.parametrize("dtype,b,sq,sk,h,kh,d,kw", [
    (torch.bfloat16, 1, 300, 300, 32, 2, 128, {}),          # wgmma
    (torch.bfloat16, 2, 1, 24, 48, 8, 128, {}),             # decode shape
    (torch.bfloat16, 1, 200, 200, 8, 4, 64, {"window": 70,
                                              "logit_cap": 30.0}),
    (torch.bfloat16, 1, 100, 100, 6, 1, 256, {"window": 33}),
    (torch.bfloat16, 1, 5, 3, 2, 1, 64, {"causal": False, "window": 1}),
    (torch.bfloat16, 2, 37, 100, 4, 2, 16, {}),             # simt, bf16
    (torch.float32, 1, 130, 130, 4, 1, 128, {"window": 40}),
    (torch.float32, 1, 45, 45, 2, 1, 32, {"logit_cap": 3.0}),
])
def test_forward_lse_matches_plain_version(cuda, dtype, b, sq, sk, h, kh, d,
                                           kw):
    """The lse the forward writes for the backward, against
    flash_attention_lse_ref in f32 on the same values: +inf exactly where
    a row sees no key, elsewhere within 1e-4 + 1e-5 |lse|.  A bf16 call
    that would take the decode kernel takes the prefill kernel when lse
    is asked for; its output is the plain call's within FA_TOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _fa_inputs(cuda, b, sq, sk, h, kh, d, dtype, seed=sq + d)
    pl = fa_kernel.plan(b, sq, sk, h, kh, d, dtype, kw.get("causal", True),
                        kw.get("window"), with_lse=True)
    assert pl.variant == ("simt" if dtype == torch.float32 or d < 64
                          else "wgmma")
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    want = flash_attention_lse_ref(q.float(), k.float(), **kw)
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), inf) and bool((lse[inf] > 0).all())
    torch.testing.assert_close(lse[~inf], want[~inf], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q.float(), k.float(), v.float(),
                                         **kw), **FA_TOL[dtype])


def test_flash_backward_of_a_row_with_no_key_is_zero(cuda):
    """Non-causal, window 1, Sq 5 over Sk 3: queries 3 and 4 see no key;
    their out and dq are 0, never NaN, and they add nothing to dk, dv."""
    q, k, v = _fa_inputs(cuda, 1, 5, 3, 2, 1, 64, torch.float32, seed=3)
    out, (dq, dk, dv), dout = _bwd(q, k, v, causal=False, window=1)
    assert bool(torch.isfinite(dq).all()) and bool(torch.isfinite(dk).all())
    assert float(out[:, 3:].abs().max()) == 0.0
    assert float(dq[:, 3:].abs().max()) == 0.0
    _, (_, dk3, dv3), _ = _bwd(q[:, :3], k, v, causal=False, window=1)
    torch.testing.assert_close(dk, dk3, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv3, rtol=0, atol=0)


def test_flash_backward_wrapper_checks_its_operands(cuda):
    q, k, v = _fa_inputs(cuda, 1, 8, 8, 2, 1, 64, torch.bfloat16, seed=1)
    out = torch.zeros_like(q)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fa_backward.flash_attention_bwd_cuda(q.cpu(), k.cpu(), v.cpu(),
                                             out.cpu(), out.cpu(), lse.cpu())
    with pytest.raises(ValueError, match="dout is"):
        fa_backward.flash_attention_bwd_cuda(q, k, v, out, out.float(), lse)
    with pytest.raises(ValueError, match="must have q's shape"):
        fa_backward.flash_attention_bwd_cuda(q, k, v, out[:, :4], out, lse)
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa_backward.flash_attention_bwd_cuda(
            q, k, v, out, out.transpose(1, 3).contiguous().transpose(1, 3),
            lse)
    with pytest.raises(ValueError, match="lse must be"):
        fa_backward.flash_attention_bwd_cuda(q, k, v, out, out, lse[:, :1])
    wide = torch.zeros((1, 8, 2, 68), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="misaligned"):   # stride 136 bytes
        fa_backward.flash_attention_bwd_cuda(q, k, v, out, wide[..., :64],
                                             lse)


# reduced models whose end-to-end train check holds a metric only where
# two plain runs (attention in bf16 and in f32) agree on it
TRAIN_IF_STABLE = ("starcoder2-3b",)
TRAIN_REL_TOL = 2e-2


@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-3b"])
def test_reduced_train_step_on_the_card(cuda, monkeypatch, arch):
    """One train step of a reduced model at head dim 64 in bf16 (the
    tensor-core forward and the backward kernel; two microbatches, remat
    "full"): every attention layer launches the forward twice (the remat
    recompute) and the backward once per microbatch, and the loss and grad
    norm are finite.  They are held within TRAIN_REL_TOL of the same step
    with the plain attention evaluated in f32 on the same values.  For
    qwen3-14b always: qk-norm keeps the scores small.  Reduced
    starcoder2-3b has no qk-norm and the reference's initialisation makes
    it chaotic (C-ref5), so a metric is held only where the plain
    attention in bf16 agrees with it in f32 within TRAIN_REL_TOL
    (chip_smoke's E2E_IF_STABLE rule).  The readings are printed as one
    JSON line (``-s`` shows them)."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import model_zoo, transformer
    from repro_torch.optim.adamw import init_opt_state, AdamW
    from repro_torch.train.steps import make_train_step
    cfg = reduced_config(arch, head_dim=64, dtype="bfloat16",
                         param_dtype="bfloat16", microbatches=2)
    model = model_zoo.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device=cuda,
                         generator=g)
    batch = {"tokens": toks, "labels": toks}

    def step():
        params = model.table.init(
            torch.Generator(device=cuda).manual_seed(0), cuda)
        fn = make_train_step(cfg, model, AdamW())
        _, _, metrics = fn(params, init_opt_state(params, AdamW()), batch)
        return {k: float(v) for k, v in metrics.items()}

    fwd, bwd = fa_kernel.LAUNCHES["flash_attention"], \
        fa_backward.LAUNCHES["flash_attention_bwd"]
    tc = fa_backward.VARIANT_CALLS["wgmma"]
    got = step()
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] - fwd == \
        cfg.num_layers * 2 * 2
    assert fa_backward.LAUNCHES["flash_attention_bwd"] - bwd == \
        cfg.num_layers * 2
    # every backward call on the tensor cores (bf16, head dim 64)
    assert fa_backward.VARIANT_CALLS["wgmma"] - tc == cfg.num_layers * 2

    def plain_f32(q, k, v, **kw):
        return flash_attention_ref(q.float(), k.float(), v.float(),
                                   **kw).to(q.dtype)

    monkeypatch.setattr(transformer, "flash_attention", plain_f32)
    want = step()
    monkeypatch.setattr(transformer, "flash_attention", flash_attention_ref)
    plain = step()
    readings = {}
    for key in ("loss", "grad_norm"):
        assert np.isfinite(got[key]), (key, got[key])
        readings[key] = {
            "kernel": got[key], "plain": plain[key], "plain_f32": want[key],
            "kernel_vs_plain_f32": abs(got[key] - want[key]) / abs(want[key]),
            "plain_vs_plain_f32":
                abs(plain[key] - want[key]) / abs(want[key])}
    print(json.dumps({"reduced_train_step": arch, **readings}))
    for key, r in readings.items():
        if arch in TRAIN_IF_STABLE and \
                r["plain_vs_plain_f32"] > TRAIN_REL_TOL:
            continue
        assert r["kernel_vs_plain_f32"] <= TRAIN_REL_TOL, (key, r)


# -------------- backward on the card: B3, B4 and B5 ---------------------- #
def _lm_kernel_call(name, dev):
    """(dispatcher call, its LAUNCHES dict and key) on small operands."""
    g = torch.Generator(device=dev).manual_seed(5)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev)

    if name == "flash_attention":
        q, k, v = (t(1, 8, 2, 64).bfloat16() for _ in range(3))
        return (lambda: fa_ops.flash_attention(q, k, v)), (q, k, v), \
            fa_kernel.LAUNCHES
    if name == "rglru_scan":
        a, x = torch.rand((1, 70, 16), generator=g, device=dev), t(1, 70, 16)
        return (lambda: rg_ops.rglru_scan(a, x)), (a, x), rg_kernel.LAUNCHES
    q, k, v = (t(1, 40, 2, 16) for _ in range(3))
    li, lf = t(1, 40, 2), -t(1, 40, 2).abs()
    return (lambda: ml_ops.mlstm(q, k, v, li, lf)), (q, k, v, li, lf), \
        ml_kernel.LAUNCHES


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan", "mlstm"])
def test_lm_kernels_refuse_autograd_on_the_card(cuda, name):
    """With grad mode on and a CUDA operand that requires grad, each LM
    kernel goes through its autograd Function (FlashAttentionFn,
    RglruScanFn, MlstmFn): the kernel forward, a grad_fn whose backward
    launches the backward kernel once; none refuses any more.  Under
    inference_mode each call launches its kernel once."""
    call, operands, launches = _lm_kernel_call(name, cuda)
    operands[0].requires_grad_(True)
    before = launches[name]
    bwd_launches, bwd_name = {
        "flash_attention": (fa_backward.LAUNCHES, "flash_attention_bwd"),
        "rglru_scan": (rg_backward.LAUNCHES, "rglru_scan_bwd"),
        "mlstm": (ml_backward.LAUNCHES, "mlstm_bwd")}[name]
    bwd = bwd_launches[bwd_name]
    out = call()
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None and launches[name] == before + 1
    (grad,) = torch.autograd.grad(out.float().sum(), operands[0])
    torch.cuda.synchronize()
    assert bwd_launches[bwd_name] == bwd + 1
    assert bool(torch.isfinite(grad.float()).all())
    before += 1
    with torch.inference_mode():
        out = call()
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    out = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(out.float()).all())


# ---------------------- B4 and B5 backward kernels ------------------------ #
@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("b,s,w,with_h0", SCAN_SHAPES)
def test_rglru_scan_backward_equals_its_chunked_order(cuda, b, s, w, with_h0,
                                                      dh_last):
    """The backward kernel (the forward's chunked scan run from the end)
    equals rglru_scan_bwd_chunked_ref at its plan's chunk bit for bit, is
    within 1e-5 of the largest plain gradient (rglru_scan_bwd_ref, a
    doubling scan), and two launches give the same bits."""
    a, x, h0 = _scan_inputs(cuda, b, s, w, with_h0)
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn((b, s, w), generator=g, device=cuda)
    dl = torch.randn((b, w), generator=g, device=cuda) if dh_last else None
    h, _ = rg_kernel.rglru_scan_cuda(a, x, h0)
    before = rg_backward.LAUNCHES["rglru_scan_bwd"]
    got = rg_backward.rglru_scan_bwd_cuda(a, h, dy, dl, h0)
    again = rg_backward.rglru_scan_bwd_cuda(a, h, dy, dl, h0)
    torch.cuda.synchronize()
    assert rg_backward.LAUNCHES["rglru_scan_bwd"] == before + 2
    want = rglru_scan_bwd_chunked_ref(a, h, dy, dl, h0,
                                      chunk=rg_kernel.plan(b, s, w).chunk)
    plain = rglru_scan_bwd_ref(a, h, dy, dl, h0)
    for x1, x2, w1, p1 in zip(got, again, want, plain):
        if w1 is None:
            assert x1 is None and x2 is None
            continue
        assert torch.equal(x1, w1) and torch.equal(x2, x1)
        assert float((x1 - p1).abs().max()) <= 1e-5 * float(p1.abs().max())


def test_rglru_scan_backward_misaligned_base_takes_the_cp_async_path(cuda):
    """a and dy one float past a 16-byte boundary: no bulk copies (the
    decays one row ahead come by cp.async too), the same bits as the
    chunked order."""
    b, s, w = 1, 300, 256
    a0, x0, h0 = _scan_inputs(cuda, b, s * w + 1, 1, True)
    a = a0.flatten()[1:].view(b, s, w)
    dy = x0.flatten()[1:].view(b, s, w)
    h0 = h0.expand(b, w).contiguous()
    h, _ = rg_kernel.rglru_scan_cuda(a, dy, h0)
    got = rg_backward.rglru_scan_bwd_cuda(a, h, dy, None, h0)
    want = rglru_scan_bwd_chunked_ref(a, h, dy, None, h0,
                                      chunk=rg_kernel.plan(b, s, w).chunk)
    torch.cuda.synchronize()
    for x1, w1 in zip(got, want):
        assert torch.equal(x1, w1)


# (b, s, h, d, dtype): xlstm-350m's training microbatch (the tensor-core
# forward), its forward shape, the tensor-core forward off it (ragged S,
# under one tile), then the CUDA-core forward: small f32 cases whose S is
# no multiple of the tiles at every head dim, f32 at 512, bf16 at 64
MLSTM_BWD_SHAPES = [(2, 2048, 4, 512, torch.bfloat16),
                    (1, 300, 4, 512, torch.bfloat16),
                    (1, 37, 2, 512, torch.bfloat16),
                    (1, 64, 2, 16, torch.float32),
                    (2, 100, 2, 16, torch.float32),
                    (2, 96, 4, 32, torch.float32),
                    (1, 100, 1, 64, torch.float32),
                    (2, 70, 2, 512, torch.float32),
                    (2, 37, 4, 64, torch.bfloat16)]


@pytest.mark.parametrize("i_shift", [0.0, -3.0])
@pytest.mark.parametrize("b,s,h,d,dtype", MLSTM_BWD_SHAPES)
def test_mlstm_forward_stats_match_plain_version(cuda, b, s, h, d, dtype,
                                                 i_shift):
    """The forward launch's row stats (L, sg) against the plain version's
    in f32 on the same values, and the output bit-equal to a launch
    without stats.  L = m + log n is held within 1e-4 (1 + cond_t), cond_t
    = sum_s |a_ts| / n_t: n sums signed terms, and a row whose terms
    cancel has a log n as ill-conditioned as that (the tensor-core kernel
    feeds a as two bf16 terms, ~2^-16 each).  sg is held on every row
    whose |den| and exp(-m) lie further apart than that band, where sums
    in another order may pick the other side."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _mlstm_inputs(cuda, b, s, h, d, dtype, seed=s + d,
                        i_shift=i_shift)
    out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
    plain = ml_kernel.mlstm_cuda(*ops)
    q, k, v, log_i, log_f = ops
    _, want_lse, want_sg = mlstm_ref(q.float(), k.float(), v.float(), log_i,
                                     log_f, with_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    fcum = torch.cumsum(log_f, dim=1)
    causal = torch.ones((s, s), dtype=torch.bool, device=cuda).tril()
    logw = torch.where(causal[None, :, :, None], fcum[:, :, None] -
                       fcum[:, None] + log_i[:, None], -1e30)
    m = logw.amax(dim=2)
    a = torch.exp(logw - m[:, :, None]) * torch.einsum(
        "bthd,bshd->btsh", q.float(), k.float()) * d ** -0.5
    den, mass = a.sum(dim=2), a.abs().sum(dim=2)
    norm = torch.maximum(den.abs(), torch.exp(-m))
    band = 1e-4 * (norm + mass)
    assert bool(((lse - want_lse).abs() <= band / norm).all()), \
        float(((lse - want_lse).abs() / (band / norm)).max())
    tie = (den.abs() - torch.exp(-m)).abs() <= band
    assert torch.equal(sg[~tie], want_sg[~tie])
    if i_shift < 0:
        assert float((sg == 0).float().mean()) > 0.5


@pytest.mark.parametrize("i_shift", [0.0, -3.0])
@pytest.mark.parametrize("b,s,h,d,dtype", MLSTM_BWD_SHAPES)
def test_mlstm_backward_matches_plain_version(cuda, b, s, h, d, dtype,
                                              i_shift):
    """dq, dk, dv, d log_i and d log_f of the backward kernel, on the
    forward launch's stats, each within 2e-2 (bf16) or 2e-4 (f32) of the
    largest value of the plain backward (mlstm_bwd_ref) in f32 on the same
    values and stats (the stats are held against the plain ones above):
    chip_smoke.py's BWD_TOL; two launches give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _mlstm_inputs(cuda, b, s, h, d, dtype, seed=s + d + 1,
                        i_shift=i_shift)
    out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
    g = torch.Generator(device=cuda).manual_seed(9)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    before = ml_backward.LAUNCHES["mlstm_bwd"]
    got = ml_backward.mlstm_bwd_cuda(*ops, out, dout, lse, sg)
    again = ml_backward.mlstm_bwd_cuda(*ops, out, dout, lse, sg)
    torch.cuda.synchronize()
    assert ml_backward.LAUNCHES["mlstm_bwd"] == before + 2
    q, k, v, log_i, log_f = ops
    want = mlstm_bwd_ref(q.float(), k.float(), v.float(), log_i, log_f,
                         out.float(), dout.float(), (lse, sg))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    for name, x, y, w in zip(("dq", "dk", "dv", "dli", "dlf"), got, again,
                             want):
        assert torch.equal(x, y), name
        assert x.dtype == (dtype if name in ("dq", "dk", "dv")
                           else torch.float32)
        err = float((x.float() - w).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err,
                                                   float(w.abs().max()))


# (b, s, h, flags): the tensor-core backward off xlstm-350m's training
# shape: S no multiple of 64, S under one 64-key block, input gates low
# enough that sg = 0 on most rows, q, k, v as views of one fused
# projection, and the model's forget gates (logsigmoid(3 + 2.6 N(0, 1)):
# F ~ -600 at S = 2048)
MLSTM_TC_BWD_CASES = [(1, 300, 4, {}), (1, 37, 2, {}),
                      (1, 300, 4, {"i_shift": -3.0}),
                      (2, 200, 4, {"fused": True}),
                      (1, 2048, 4, {"f_bias": 3.0})]
# chip_smoke.py's TWIN_TOL: the tensor-core backward against its
# arithmetic in plain PyTorch (mlstm_bwd_split_ref), dq, dk, dv (bf16: one
# unit in the last place of the largest value is up to 2^-7 of it),
# d log_i, d log_f
TWIN_TOL = (8e-3, 8e-3, 8e-3, 2e-4, 2e-4)


def _mlstm_tc_inputs(dev, b, s, h, seed, i_shift=0.0, fused=False,
                     f_bias=None):
    """bf16 q, k, v at head dim 512 (with ``fused`` views of one (B, S, 3,
    H, 512) tensor), log i ~ N(i_shift, 1), log f = -|N(0, 1)| / 2 or,
    with ``f_bias``, logsigmoid(f_bias + 2.6 N(0, 1))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if fused:
        q, k, v = torch.randn((b, s, 3, h, 512), generator=g,
                              device=dev).bfloat16().unbind(2)
    else:
        q, k, v = (torch.randn((b, s, h, 512), generator=g,
                               device=dev).bfloat16() for _ in range(3))
    log_i = torch.randn((b, s, h), generator=g, device=dev) + i_shift
    log_f = torch.randn((b, s, h), generator=g, device=dev)
    log_f = -log_f.abs() * 0.5 if f_bias is None else \
        torch.nn.functional.logsigmoid(f_bias + 2.6 * log_f)
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("b,s,h,flags", MLSTM_TC_BWD_CASES)
def test_mlstm_tensor_core_backward_matches_plain_version(cuda, b, s, h,
                                                          flags):
    """bf16 at head dim 512 takes the tensor-core variant (the plan and
    VARIANT_CALLS say so): dq, dk, dv, d log_i and d log_f within 2e-2 of
    the largest value of the plain backward (mlstm_bwd_ref) in f32 on the
    same values and the forward launch's stats, and within TWIN_TOL of the
    kernels' arithmetic in plain PyTorch (mlstm_bwd_split_ref); two
    launches give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = _mlstm_tc_inputs(cuda, b, s, h, seed=s + b, **flags)
    out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
    g = torch.Generator(device=cuda).manual_seed(9)
    dout = torch.randn(out.shape, generator=g, device=cuda).bfloat16()
    assert ml_backward.plan(b, s, h, 512, torch.bfloat16) == "wgmma"
    before = dict(ml_backward.VARIANT_CALLS)
    got = ml_backward.mlstm_bwd_cuda(*ops, out, dout, lse, sg)
    again = ml_backward.mlstm_bwd_cuda(*ops, out, dout, lse, sg)
    torch.cuda.synchronize()
    assert ml_backward.VARIANT_CALLS == {
        "wgmma": before["wgmma"] + 2, "simt": before["simt"]}
    q, k, v, log_i, log_f = ops
    want = mlstm_bwd_ref(q.float(), k.float(), v.float(), log_i, log_f,
                         out.float(), dout.float(), (lse, sg))
    twin = mlstm_bwd_split_ref(q, k, v, log_i, log_f, out, dout, (lse, sg))
    for name, x, y, w, e, tol in zip(("dq", "dk", "dv", "dli", "dlf"), got,
                                     again, want, twin, TWIN_TOL):
        assert torch.equal(x, y), name
        assert x.dtype == e.dtype, name
        err = float((x.float() - w).abs().max())
        assert err <= 2e-2 * float(w.abs().max()), (name, err)
        err = float((x.float() - e.float()).abs().max())
        assert err <= tol * float(e.float().abs().max()), (name, err)


@pytest.mark.parametrize("d,dtype,variant", [
    (512, torch.bfloat16, "wgmma"), (512, torch.float32, "simt"),
    (64, torch.bfloat16, "simt"), (16, torch.float32, "simt")])
def test_mlstm_backward_counts_its_variant(cuda, d, dtype, variant):
    """Each call adds one to LAUNCHES and to the plan's variant."""
    ops = _mlstm_inputs(cuda, 1, 70, 2, d, dtype, seed=d)
    out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
    before = (ml_backward.LAUNCHES["mlstm_bwd"],
              dict(ml_backward.VARIANT_CALLS))
    ml_backward.mlstm_bwd_cuda(*ops, out, torch.ones_like(out), lse, sg)
    torch.cuda.synchronize()
    assert ml_backward.plan(1, 70, 2, d, dtype) == variant
    assert ml_backward.LAUNCHES["mlstm_bwd"] == before[0] + 1
    assert ml_backward.VARIANT_CALLS == {
        key: n + (key == variant) for key, n in before[1].items()}


def test_mlstm_tensor_core_backward_raises_where_it_cannot_launch(cuda):
    """A bf16 head-dim-512 call whose q is not 16-byte aligned (TMA) raises
    before any launch: no fallback to the CUDA-core variant or the plain
    version."""
    ops = _mlstm_tc_inputs(cuda, 1, 64, 2, seed=5)
    out, lse, sg = ml_kernel.mlstm_cuda(*ops, with_stats=True)
    wide = torch.zeros((1, 64, 2, 520), device=cuda, dtype=torch.bfloat16)
    wide[..., 1:513] = ops[0]
    q = wide[..., 1:513]
    before = (ml_backward.LAUNCHES["mlstm_bwd"],
              dict(ml_backward.VARIANT_CALLS))
    with pytest.raises(ValueError, match="misaligned"):
        ml_backward.mlstm_bwd_cuda(q, *ops[1:], out, torch.ones_like(out),
                                   lse, sg)
    assert (ml_backward.LAUNCHES["mlstm_bwd"],
            ml_backward.VARIANT_CALLS) == before


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_reduced_recurrent_train_step_on_the_card(cuda, arch):
    """One train step of a reduced recurrent model in bf16 (two
    microbatches): every RG-LRU scan or mLSTM of each microbatch launches
    its forward kernel once and its backward kernel once, and the loss and
    grad norm are finite.  End to end the recurrent models are not held
    against the plain path (C-ref5, C-ref6: two plain runs already
    disagree), chip_smoke holds each backward call instead."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.optim.adamw import AdamW, init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = reduced_config(arch, dtype="bfloat16", param_dtype="bfloat16",
                         microbatches=2)
    model = model_zoo.build_model(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 96), device=cuda,
                         generator=g)
    params = model.table.init(torch.Generator(device=cuda).manual_seed(0),
                              cuda)
    fn = make_train_step(cfg, model, AdamW())
    if arch == "recurrentgemma-9b":
        from repro_torch.models import hybrid
        unit, n_super, tail = hybrid._pattern(cfg)
        per_mb = n_super * unit.count("rec") + len(tail)
        fwd, bwd, name = rg_kernel.LAUNCHES, rg_backward.LAUNCHES, \
            "rglru_scan"
    else:
        from repro_torch.models import xlstm
        unit, n_super = xlstm._pattern(cfg)
        per_mb = n_super * unit.count("mlstm")
        fwd, bwd, name = ml_kernel.LAUNCHES, ml_backward.LAUNCHES, "mlstm"
    f0, b0 = fwd[name], bwd[name + "_bwd"]
    _, _, metrics = fn(params, init_opt_state(params, AdamW()),
                       {"tokens": toks, "labels": toks})
    torch.cuda.synchronize()
    assert fwd[name] - f0 == 2 * per_mb
    assert bwd[name + "_bwd"] - b0 == 2 * per_mb
    for key in ("loss", "grad_norm"):
        assert np.isfinite(float(metrics[key])), (key, metrics)
