"""AdamW's CUDA passes (``kernels/adamw``) where no card is needed: the
wrapper's validation, its launch plan and the calls it plans, that CPU and
``meta`` tensors take the plain version and launch nothing, and the dry
run's stand-in for the card's calls (``OpTrace.fused``,
``trace_mismatch``).  The kernels themselves run in
``tests/test_torch_adamw_cuda.py`` on the card."""
import collections
import copy
import json

import pytest
import torch

from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.launch import dryrun
from repro_torch.optim import adamw

BF16, F32 = torch.bfloat16, torch.float32


def _leaf(shape=(4, 6), p=BF16, g=F32, m=F32, device="cpu"):
    return (torch.zeros(shape, dtype=p, device=device),
            torch.zeros(shape, dtype=g, device=device),
            torch.zeros(shape, dtype=m, device=device),
            torch.zeros(shape, dtype=m, device=device))


def _bad_leaves(case):
    good = _leaf()
    p, g, m, v = good
    return [good, {
        "grad_size": (p, g[:2], m, v),
        "moment_size": (p, g, m, v.reshape(-1)[:5]),
        "p_float16": (p.half(), g, m, v),
        "g_float64": (p, g.double(), m, v),
        "m_int32": (p, g, m.int(), v.int()),
        "m_v_dtypes_differ": (p, g, m, v.to(BF16)),
        "p_strided": (p.t(), g.t(), m.t(), v.t()),
        "g_strided": (p, torch.zeros(6, 4).t(), m, v),
        "second_device": _leaf(device="meta"),
    }[case]]


@pytest.mark.parametrize("case", [
    "grad_size", "moment_size", "p_float16", "g_float64", "m_int32",
    "m_v_dtypes_differ", "p_strided", "g_strided", "second_device"])
def test_validation_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        adamw_kernel.validate(_bad_leaves(case))


@pytest.mark.parametrize("case", ["float16", "strided", "second_device"])
def test_the_norms_validation_raises(case):
    g = torch.zeros(4, 6)
    bad = {"float16": g.half(), "strided": g.t(),
           "second_device": g.to("meta")}[case]
    with pytest.raises(ValueError):
        adamw_kernel.validate_grads([g, bad])


@pytest.mark.parametrize("m", [F32, BF16])
@pytest.mark.parametrize("g", [F32, BF16])
@pytest.mark.parametrize("p", [BF16, F32])
def test_every_dtype_instance_is_taken(p, g, m):
    leaves = [_leaf(p=p, g=g, m=m, device="meta")]
    adamw_kernel.validate(leaves)
    (call,) = adamw_kernel.update_calls(leaves)
    assert call == ("adamw_update", "/".join(
        str(x).removeprefix("torch.") for x in (p, g, m)),
        {"n": 24, "blocks": 1, "vec": True})


def test_the_wrappers_refuse_cpu_tensors_before_any_launch():
    before = dict(adamw_kernel.LAUNCHES)
    leaf = _leaf()
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA tensors"):
        adamw_kernel.norm_and_clip([leaf[1]], 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        adamw_kernel.update([leaf], one, one, one, one, adamw.AdamW())
    assert adamw_kernel.LAUNCHES == before


@pytest.mark.parametrize("n,want", [(1, 1), (2048, 1), (2049, 2),
                                    (528 * 2048, 528), (1 << 31, 528)])
def test_blocks_follow_the_elements_up_to_four_an_sm(n, want):
    assert adamw_kernel.blocks(n, 132) == want


def test_the_planned_calls_skip_empty_leaves_and_count_every_partial():
    leaves = [_leaf(s, device="meta") for s in ((), (0,), (3, 7),
                                                (5, 1 << 20))]
    norm = adamw_kernel.norm_calls([leaf[1] for leaf in leaves])
    upd = adamw_kernel.update_calls(leaves)
    sizes = [1, 21, 5 << 20]
    assert [c[2]["n"] for c in norm[:-1]] == sizes
    assert [c[2]["n"] for c in upd] == sizes
    assert norm[-1] == ("adamw_norm", "final", {
        "partials": sum(adamw_kernel.blocks(n, 132) for n in sizes)})
    assert all(c[1] == "float32" for c in norm[:-1])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_version(device):
    params = {"a": torch.ones(3, 5, device=device),
              "b": torch.ones(7, device=device)}
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    state = adamw.init_opt_state(params, adamw.AdamW())
    before = dict(adamw_kernel.LAUNCHES)
    adamw.adamw_update(params, grads, state, 1e-3, adamw.AdamW())
    assert adamw_kernel.LAUNCHES == before
    if device == "cpu":
        assert float(params["a"][0, 0]) < 1.0


def _meta_trace():
    shapes = {"a": (3, 5), "b": (7,), "c": ()}
    params = {k: torch.empty(s, dtype=BF16, device="meta")
              for k, s in shapes.items()}
    grads = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    state = adamw.init_opt_state(params, adamw.AdamW())
    trace = dryrun.OpTrace()
    trace.arguments((params, grads, state))
    with trace.recording():
        adamw.adamw_update(params, grads, state, 3e-4, adamw.AdamW())
    return trace, params, grads, state


def test_the_dry_run_holds_the_plain_ops_as_the_stand_in_for_the_calls():
    """On ``meta`` the norm and the update run their plain ops, which stay
    in the trace (the dry run's bytes and temporaries), inside two
    stand-ins whose calls are the ones the card launches."""
    trace, params, grads, state = _meta_trace()
    assert len(trace.fused_ops) == 2
    inside = [op[0] for a, b in trace.fused_ops for op in trace.ops[a:b]]
    assert "aten.sqrt.default" in inside and "aten.sum.default" in inside
    assert not trace.kernels
    leaves = list(zip(*(adamw._leaves(t) for t in (
        params, grads, state["m"], state["v"]))))
    want = adamw_kernel.norm_calls([leaf[1] for leaf in leaves]) + \
        adamw_kernel.update_calls(leaves)
    got = trace.as_dict()["fused"]["calls"]
    assert got == collections.Counter(json.dumps(c, sort_keys=True)
                                      for c in want)
    assert len(want) == 2 * 3 + 1


def test_trace_mismatch_compares_the_stand_ins_calls_not_their_ops():
    a = _meta_trace()[0].as_dict()
    b = copy.deepcopy(a)
    first, end = b["fused"]["ops"][0]
    # the card's side: the wrapper's own ops where meta ran the plain ones
    b["ops"][first:end] = [["aten.empty.memory_format", [], [], 0, 0]]
    shift = (end - first) - 1
    b["fused"]["ops"] = [[first, first + 1]] + [
        [x - shift, y - shift] for x, y in b["fused"]["ops"][1:]]
    assert dryrun.trace_mismatch(a, b) is None
    c = copy.deepcopy(b)
    key = next(iter(c["fused"]["calls"]))
    c["fused"]["calls"][key] += 1
    assert "stand-ins' calls differ" in dryrun.trace_mismatch(a, c)
    d = copy.deepcopy(b)
    d["ops"].insert(0, ["aten.add.Tensor", [], [], 0, 0])
    d["fused"]["ops"] = [[x + 1, y + 1] for x, y in d["fused"]["ops"]]
    assert dryrun.trace_mismatch(a, d).startswith("ops differ from 0")
