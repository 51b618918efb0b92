"""AdamW's two CUDA passes (``kernels/adamw``) on the card, against the
plain version of ``optim/adamw.py`` run on the card's own eager ops.

- The update bit for bit with ``_update_slice`` over flat slices, p, m
  and v, over 3 carried steps, for every dtype instance (p bf16 or f32, g
  f32 or bf16, moments f32 or bf16), with the clip factor 1 and below 1,
  on ragged leaves (0-dim, 1 element, sizes no multiple of the vector
  width, a misaligned view, a leaf of zeros that must stay zero).
- A leaf of more than 2^31 elements (bf16 p, f32 g, m and v: ~30 GB, and
  as much again for the plain copy) bit for bit, and its norm.
- The norm within one f32 ulp of ``global_norm_plain``, the same bits over
  two runs, finite where the f32 sum of squares overflows (C-ref13); the
  clip factor bit for bit the eager formula on the kernel's norm.
- ``adamw_update`` on the card equal to the plain step given the same
  norm, its launches counted (one norm and one update a non-empty leaf,
  one final sum), the ``train.optimizer`` span's ``kernel_launches``, and
  no ``cudaStreamSynchronize`` beyond the plain step's.
- The wrapper refuses what it does not take before any launch.

Marked ``cuda``: without a CUDA device every test here skips.  The file
imports neither JAX nor the JAX package."""
import collections
import json

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.obs import trace
from repro_torch.optim import adamw

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
#: leaf shapes: 0-dim, one element, under one vector, ragged tails, one
#: larger than a grid's step of the plan at 528 blocks
SHAPES = [(), (1,), (7,), (3, 5, 7), (2049,), (4, 1000, 37), (8, 1 << 17)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc "
                    "and run only there")
    return torch.device("cuda")


def _state(dev, p_dtype, g_dtype, m_dtype, gain, seed, shapes=SHAPES):
    """Leaves (p, g, m, v) on the card: p ~ N(0, 1), g spread over
    1e-9..1 times ``gain``, m ~ N(0, 1e-2), v ~ N(0, 1e-2)^2."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    leaves = []
    for shape in shapes:
        g = draw(shape, gain) * torch.pow(10.0, -9 * torch.rand(
            shape, generator=gen, device=dev))
        leaves.append((draw(shape).to(p_dtype), g.to(g_dtype),
                       draw(shape, 1e-2).to(m_dtype),
                       draw(shape, 1e-2).square().to(m_dtype)))
    # a leaf of zeros (the padded heads' slots) must stay zero
    z = (4099,)
    leaves.append(tuple(torch.zeros(z, dtype=dt, device=dev)
                        for dt in (p_dtype, g_dtype, m_dtype, m_dtype)))
    # views whose bases are 2 or 4 bytes off 16: the plan's scalar path
    wide = [draw((4097,), scale).to(dt) for scale, dt in
            ((1.0, p_dtype), (gain, g_dtype), (1e-2, m_dtype))]
    wide.append(draw((4097,), 1e-2).square().to(m_dtype))
    leaves.append(tuple(w[1:] for w in wide))
    return leaves


def _copy(leaves):
    return [tuple(x.clone() for x in leaf) for leaf in leaves]


def _scalars(dev, opt, count):
    cf = torch.tensor(float(count), device=dev)
    c1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=F32, device=dev), cf)
    c2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=F32, device=dev), cf)
    return c1, c2, torch.tensor(3e-4, dtype=F32, device=dev)


def _plain_update(leaves, clip, c1, c2, lr, opt):
    for leaf in leaves:
        for p, g, m, v in zip(*map(adamw._flat_slices, leaf)):
            adamw._update_slice(p, g, m, v, clip=clip, c1=c1, c2=c2, lr=lr,
                                opt=opt)


def _eager_clip(gnorm, opt):
    return torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia, ib = (int(x.reshape(1).view(torch.int32)) for x in (a, b))
    return abs(ia - ib)


def _equal(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip("pgmv", a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), (i, name)


@pytest.mark.parametrize("gain", [1e-4, 1e2], ids=["clip_1", "clip_below_1"])
@pytest.mark.parametrize("m_dtype", [F32, BF16], ids=["m_f32", "m_bf16"])
@pytest.mark.parametrize("g_dtype", [F32, BF16], ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("p_dtype", [BF16, F32], ids=["p_bf16", "p_f32"])
def test_update_equals_the_plain_slices_bit_for_bit(cuda, p_dtype, g_dtype,
                                                    m_dtype, gain):
    opt = adamw.AdamW()
    kern = _state(cuda, p_dtype, g_dtype, m_dtype, gain, seed=0)
    plain = _copy(kern)
    gen = torch.Generator(device=cuda).manual_seed(1)
    clips = []
    for step in range(1, 4):
        if step > 1:    # fresh gradients, the same on both sides; the
            # zeros' gradient stays zero
            for a, b in zip(kern[:-2] + kern[-1:], plain[:-2] + plain[-1:]):
                g = (torch.randn(a[1].shape, generator=gen, device=cuda) *
                     gain).to(g_dtype)
                a[1].copy_(g)
                b[1].copy_(g)
        gnorm, clip = adamw_kernel.norm_and_clip([leaf[1] for leaf in kern],
                                                 opt.grad_clip)
        assert torch.equal(clip, _eager_clip(gnorm, opt))
        c1, c2, lr = _scalars(cuda, opt, step)
        adamw_kernel.update(kern, clip, c1, c2, lr, opt)
        _plain_update(plain, clip, c1, c2, lr, opt)
        clips.append(float(clip))
        _equal(kern, plain)
    if gain < 1:
        assert clips == [1.0] * 3
    else:
        assert all(c < 1.0 for c in clips)
    assert all(int(x.count_nonzero()) == 0 for x in kern[-2])


def test_a_leaf_of_more_than_2_31_elements(cuda):
    """bf16 p and f32 g, m, v: the main path's instance, 64-bit indices
    (2^31 + 29 elements: the vector path and a ragged tail past 2^31)."""
    n = (1 << 31) + 29
    opt = adamw.AdamW()
    gen = torch.Generator(device=cuda).manual_seed(2)
    leaf = (torch.randn(n, generator=gen, device=cuda, dtype=BF16),
            torch.randn(n, generator=gen, device=cuda) * 1e-5,
            torch.randn(n, generator=gen, device=cuda) * 1e-2,
            torch.rand(n, generator=gen, device=cuda) * 1e-4)
    gnorm, clip = adamw_kernel.norm_and_clip([leaf[1]], opt.grad_clip)
    assert _ulps(gnorm, adamw.global_norm_plain({"g": leaf[1]})) <= 1
    c1, c2, lr = _scalars(cuda, opt, 1)
    plain = tuple(x.clone() for x in leaf)
    adamw_kernel.update([leaf], clip, c1, c2, lr, opt)
    _plain_update([plain], clip, c1, c2, lr, opt)
    _equal([leaf], [plain])
    tail = slice((1 << 31) - 8, n)
    assert not torch.equal(leaf[2][tail], torch.zeros_like(leaf[2][tail]))


@pytest.mark.parametrize("g_dtype", [F32, BF16], ids=["g_f32", "g_bf16"])
def test_norm_within_an_ulp_and_the_same_bits_twice(cuda, g_dtype):
    for seed, gain in enumerate((1e-3, 1.0, 1e3)):
        leaves = _state(cuda, BF16, g_dtype, F32, gain, seed=seed)
        grads = [leaf[1] for leaf in leaves]
        one, _ = adamw_kernel.norm_and_clip(grads, 1.0)
        two, _ = adamw_kernel.norm_and_clip(grads, 1.0)
        want = adamw.global_norm_plain({str(i): g
                                        for i, g in enumerate(grads)})
        assert torch.equal(one, two)
        assert _ulps(one, want) <= 1, (float(one), float(want))
        # the dispatcher's norm on a tree of CUDA tensors is the kernel's
        assert torch.equal(adamw.global_norm(
            {f"{i:02d}": g for i, g in enumerate(grads)}), one)


def test_norm_is_finite_where_the_f32_sum_overflows(cuda):
    """Gradients of ~1e21 (C-ref13): squares of ~1e42 overflow f32."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    grads = [torch.randn(s, generator=gen, device=cuda) * 1e21
             for s in ((1000,), (3, 77))]
    gnorm, clip = adamw_kernel.norm_and_clip(grads, 1.0)
    exact = torch.sqrt(sum(torch.sum(g.double().square()) for g in grads))
    assert torch.isinf(sum(torch.sum(g.square()) for g in grads))
    assert torch.isfinite(gnorm)
    assert float(gnorm) == pytest.approx(float(exact), rel=1e-6)
    assert 0 < float(clip) < 1e-20


def _runtime_calls(fn) -> collections.Counter:
    """The host's runtime calls while ``fn`` runs, by name, and the
    device kernels (``kernel:<name>``), from a profile of the CUDA
    activity."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            out[e.name()] += 1
        elif e.name().startswith(("Memcpy", "Memset")):
            out[e.name()] += 1
        else:
            out["kernel:" + e.name()] += 1
    return out


def test_adamw_update_takes_the_kernels_and_adds_no_synchronize(cuda):
    """Under the clip (factor exactly 1) the whole step equals the plain
    step bit for bit; the kernels launch once a non-empty leaf for each
    pass and once for the final sum, which the ``train.optimizer`` span
    reports; the step makes no more ``cudaStreamSynchronize`` calls than
    the plain step (the scalars' host copies make them)."""
    opt = adamw.AdamW()
    leaves = _state(cuda, BF16, F32, F32, 1e-4, seed=4)
    leaves.append(tuple(torch.empty(0, dtype=dt, device=cuda)
                        for dt in (BF16, F32, F32, F32)))
    tree = {f"l{i:02d}": leaf for i, leaf in enumerate(leaves)}

    def trees(src):
        return ({k: v[0] for k, v in src.items()},
                {k: v[1] for k, v in src.items()},
                {"m": {k: v[2] for k, v in src.items()},
                 "v": {k: v[3] for k, v in src.items()},
                 "count": torch.zeros((), dtype=torch.int32, device=cuda)})

    other = {k: tuple(x.clone() for x in v) for k, v in tree.items()}
    params, grads, state = trees(tree)
    k = len(leaves) - 1                      # the non-empty leaves
    before = dict(adamw_kernel.LAUNCHES)

    def fused():
        adamw.adamw_update(params, grads, state, 3e-4, opt)

    calls = _runtime_calls(fused)
    assert adamw_kernel.LAUNCHES["adamw_norm"] - before["adamw_norm"] == \
        k + 1
    assert adamw_kernel.LAUNCHES["adamw_update"] - \
        before["adamw_update"] == k
    kernels = {name: n for name, n in calls.items()
               if name.startswith("kernel:")}
    assert sum(n for name, n in kernels.items()
               if "adamw_sumsq_kernel" in name) == k
    assert sum(n for name, n in kernels.items()
               if "adamw_norm_final_kernel" in name) == 1
    assert sum(n for name, n in kernels.items()
               if "adamw_update_kernel" in name) == k

    # the plain step on the same inputs, on the card's eager ops, in
    # adamw_update's order
    p2, g2, s2 = trees(other)

    def plain():
        count = s2["count"] + 1
        gnorm = adamw.global_norm_plain(g2)
        clip = _eager_clip(gnorm, opt)
        cf = count.to(F32)
        c1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=F32, device=cuda),
                             cf)
        c2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=F32, device=cuda),
                             cf)
        lr = torch.as_tensor(3e-4, dtype=F32, device=cuda)
        _plain_update(list(zip(p2.values(), g2.values(), s2["m"].values(),
                               s2["v"].values())), clip, c1, c2, lr, opt)
        s2["count"].copy_(count)

    plain_calls = _runtime_calls(plain)
    assert calls["cudaStreamSynchronize"] == \
        plain_calls["cudaStreamSynchronize"]
    for key in tree:
        assert torch.equal(params[key], p2[key])
        assert torch.equal(state["m"][key], s2["m"][key])
        assert torch.equal(state["v"][key], s2["v"][key])
    assert int(state["count"]) == 1
    print(json.dumps({"adamw_step_runtime_calls": {
        name: n for name, n in calls.items()
        if "Synchronize" in name or "LaunchKernel" in name},
        "plain_step_runtime_calls": {
        name: n for name, n in plain_calls.items()
        if "Synchronize" in name or "LaunchKernel" in name}}))

    # the span's count of the step's launches
    with profile(activities=[ProfilerActivity.CUDA]):
        with trace.step_root("train.step", cuda):
            fused()
        torch.cuda.synchronize()
    recs = trace.drain_steps()
    (span,) = [r for r in recs if r["name"] == "train.optimizer"]
    assert span["attrs"]["kernel_launches"] == 2 * k + 1
    assert span["attrs"]["slices"] == 0


def test_the_wrapper_refuses_before_any_launch(cuda):
    opt = adamw.AdamW()
    good = _state(cuda, BF16, F32, F32, 1.0, seed=5, shapes=[(64, 8)])[0]
    c1, c2, lr = _scalars(cuda, opt, 1)
    clip = torch.ones((), device=cuda)
    bad = {
        "size": (good[0], good[1][:32], good[2], good[3]),
        "dtype": (good[0].half(), good[1], good[2], good[3]),
        "moments": (good[0], good[1], good[2], good[3].to(BF16)),
        "strides": (good[0].t(), good[1].t(), good[2].t(), good[3].t()),
    }
    before = dict(adamw_kernel.LAUNCHES)
    for name, leaf in bad.items():
        with pytest.raises(ValueError):
            adamw_kernel.update([good, leaf], clip, c1, c2, lr, opt)
    with pytest.raises(ValueError, match="0-dim float32"):
        adamw_kernel.update([good], clip.double(), c1, c2, lr, opt)
    with pytest.raises(ValueError):
        adamw_kernel.norm_and_clip([good[1], good[1].t()], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adamw_kernel.norm_and_clip([good[1].cpu()], 1.0)
    assert adamw_kernel.LAUNCHES == before
