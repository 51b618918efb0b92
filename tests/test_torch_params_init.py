"""``ParamTable.init``'s memory on the card, read on the CPU: a leaf too
large for one f32 draw beside the rest of the largest model one card
holds (qwen3-32b's stacked MLP weights) is drawn in slices of its first
axis of at most ``DRAW_SLICE`` elements, and a leaf up to ``DRAW_SLICE``
elements in one piece.  The draws are recorded by a stand-in for
``torch.randn`` that returns ``meta`` tensors, so no memory is taken."""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import model_zoo, params as params_lib


def _draws(monkeypatch, table):
    """The f32 draws ``table.init`` makes, as (leaf path, shape) in order,
    on ``meta``, and the tree it returns."""
    draws, leaf = [], [None]
    randn, draw = torch.randn, params_lib.ParamTable._draw

    def record(shape, *, generator=None, device=None, dtype=None):
        draws.append((leaf[0], tuple(shape)))
        return randn(shape, device="meta", dtype=dtype)

    def traced(self, d, gen, device):
        leaf[0] = d
        return draw(self, d, gen, device)

    monkeypatch.setattr(torch, "randn", record)
    monkeypatch.setattr(params_lib.ParamTable, "_draw", traced)
    tree = table.init(torch.Generator(), "meta")
    return draws, tree


def _peak_bytes(table, draws):
    """The most bytes live during ``init``: the leaves drawn so far (in
    the sorted order ``init`` draws them), the leaf being drawn, and its
    largest f32 transient."""
    live, peak = 0, 0
    for path in sorted(table.defs):
        d = table.defs[path]
        size = math.prod(d.shape) * table.dtype(d).itemsize
        f32 = max((4 * math.prod(s) for leaf, s in draws if leaf is d),
                  default=0)
        peak = max(peak, live + size + f32)
        live += size
    return peak


def test_qwen3_32b_init_fits_one_card(monkeypatch):
    """qwen3-32b whole: 65.5 GB of bf16 weights, whose three stacked MLP
    leaves of 8.4e9 elements each would take a 33.6 GB f32 transient
    apiece, drawn last among the layers: 98 GB at the peak, more than the
    card's 80 GB.  Sliced, no draw is over DRAW_SLICE elements, and
    init's peak is the weights and 4.3 GB; every leaf comes out whole, in
    its shape and dtype."""
    cfg = get_config("qwen3-32b")
    table = model_zoo.build_model(cfg).table
    draws, tree = _draws(monkeypatch, table)
    assert 2 * table.num_params() / 1e9 == pytest.approx(65.5, abs=0.1)
    assert max(math.prod(s) for _, s in draws) <= params_lib.DRAW_SLICE
    peak = _peak_bytes(table, draws)
    assert peak <= 2 * table.num_params() + 4 * params_lib.DRAW_SLICE
    assert peak < 80e9
    flat = params_lib._flatten(tree)
    for path, d in table.defs.items():
        assert tuple(flat[path].shape) == d.shape, path
        assert flat[path].dtype == table.dtype(d), path
    # (64, 5120, 25600) and (64, 25600, 5120): slices of 8 layers
    mlp = [s for _, s in draws if s[1:] in ((5120, 25600), (25600, 5120))]
    assert len(mlp) == 3 * 8 and {s[0] for s in mlp} == {8}


def test_each_leaf_is_drawn_in_its_slice_count(monkeypatch):
    """qwen3-14b's leaves: one of up to DRAW_SLICE elements is one draw of
    its whole shape (the weights a seed gave before slicing); a larger one
    (the MLP's 40 x 5120 x 17408, 3.6e9 elements) is drawn in consecutive
    slices of its first axis, as many indices as DRAW_SLICE holds: 12,
    12, 12 and 4 layers."""
    cfg = get_config("qwen3-14b")
    table = model_zoo.build_model(cfg).table
    draws, _ = _draws(monkeypatch, table)
    drawn = {}
    for leaf, s in draws:
        drawn.setdefault(id(leaf), []).append(s)
    leaves = [d for d in table.defs.values()
              if d.init in ("normal", "fan_in")]
    assert len(drawn) == len(leaves)
    for d in leaves:
        size = math.prod(d.shape)
        rows = max(1, params_lib.DRAW_SLICE // (size // d.shape[0]))
        want = [(min(rows, d.shape[0] - lo),) + d.shape[1:]
                for lo in range(0, d.shape[0], rows)]
        assert drawn[id(d)] == want, d.shape
        assert len(want) == (1 if size <= params_lib.DRAW_SLICE
                             else -(-d.shape[0] // rows))
    mlp = [drawn[id(d)] for d in leaves if d.shape[0] == 40 and
           d.shape[1:] in ((5120, 17408), (17408, 5120))]
    assert len(mlp) == 3
    assert all([s[0] for s in m] == [12, 12, 12, 4] for m in mlp)


def test_sliced_draw_keeps_the_rule_and_the_padding():
    """Past DRAW_SLICE (lowered here so the leaf is small), the sliced
    draw gives a fan_in leaf with scale 1/sqrt(shape[-2]) whose padded
    heads are zero, on the CPU; the slices are consecutive draws of one
    generator."""
    cfg = dataclasses.replace(get_config("qwen3-14b"), param_dtype="float32")
    table = params_lib.ParamTable(cfg)
    table.add("w", (6, 64, 8, 32), ("null",) * 4, init="fan_in",
              zero_pad=(2, 5))
    gen = torch.Generator().manual_seed(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(params_lib, "DRAW_SLICE", 2 * 64 * 8 * 32)
        got = table.init(gen, "cpu")["w"]
    gen.manual_seed(3)
    want = torch.cat([torch.randn((2, 64, 8, 32), generator=gen)
                      for _ in range(3)]) / math.sqrt(8)
    want[:, :, 5:] = 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert float(got[:, :, 5:].abs().max()) == 0.0
