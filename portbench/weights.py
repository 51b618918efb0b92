"""The inputs of a cell, made from its seed: weights and tokens.

Both sides are handed the same values: the program gets them written
into its parameter tree, the reference draws them again, layer by layer,
after the window.  Each layer's weights are one ``torch.randn`` call on
the device in the served dtype, split into the leaves in a fixed order,
each scaled by 1/sqrt(fan_in) over its true input axis: a projection's
model width, the output projection's published heads times the head dim
(padded heads are zero), the MLP's width for ``w_out``, and the model
width for the embedding, its input axis were it tied as the output head
(at one, a one-hot's, a bf16 embedding of magnitude 1 would not move:
an update of lr 3e-4 is below half its rounding step).  Norm scales are zero: the decoder
multiplies by ``1 + scale``, which is the published models' unit
initialisation.  Every draw has a seed of its own, derived from the run's
seed and what it draws, so one layer can be drawn again alone.

The layout (paths and shapes) is the port's parameter tree, worked out
here from the configuration's numbers; nothing of the program is
imported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: tags of the draws, one a kind of input
EMBED_TAG, LAYER_TAG, PROMPT_TAG = 1, 2, 3


def padded(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def heads_padded(m: dict) -> int:
    """q heads held: the published count padded to ``pad_heads_to``
    (qwen3-14b's 40 to 48, zero-masked)."""
    pad = m.get("pad_heads_to", 0)
    return padded(m["num_heads"], pad) if pad else m["num_heads"]


def vocab_padded(m: dict) -> int:
    """Rows of the embedding: the vocabulary padded to 256."""
    return padded(m["vocab_size"], 256)


def served_dtype(m: dict) -> torch.dtype:
    """The dtype the weights are served in: the configuration's
    ``param_dtype``."""
    return getattr(torch, m.get("param_dtype", "bfloat16"))


def draw_seed(seed: int, *tags: int) -> int:
    """A 64-bit seed for one draw of the run with ``seed``."""
    words = [int(seed) % 2 ** 64, *tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0])


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def layer_leaves(m: dict) -> list:
    """Each leaf of one layer: (path under ``layers/``, shape, fan_in or
    None for a zero leaf, (axis, real size) of zero padding or None)."""
    d, h, k, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                      m["head_dim"], m["d_ff"])
    hp = heads_padded(m)
    pad_q = None if hp == h else (1, h)
    pad_o = None if hp == h else (0, h)
    leaves = [("ln1/scale", (d,), None, None),
              ("ln2/scale", (d,), None, None),
              ("attn/wq", (d, hp, hd), d, pad_q),
              ("attn/wk", (d, k, hd), d, None),
              ("attn/wv", (d, k, hd), d, None),
              ("attn/wo", (hp, hd, d), h * hd, pad_o)]
    if m.get("qk_norm"):
        leaves += [("attn/q_norm", (hd,), None, None),
                   ("attn/k_norm", (hd,), None, None)]
    leaves += [("mlp/w_gate", (d, f), d, None),
               ("mlp/w_in", (d, f), d, None),
               ("mlp/w_out", (f, d), f, None)]
    return leaves


def global_groups(m: dict) -> list:
    """The leaves outside the layers, as :func:`layer_leaves`, in the
    groups that are drawn together: the embedding, then the output head
    with the final norm's scale."""
    d, vp = m["d_model"], vocab_padded(m)
    return [[("embed/table", (vp, d), d, None)],
            [("out/head", (d, vp), d, None),
             ("final_norm/scale", (d,), None, None)]]


def _draw(leaves, seed, device, dtype) -> dict:
    """The leaves from one ``randn`` call of their total size."""
    total = sum(math.prod(shape) for _, shape, fan, _ in leaves if fan)
    buf = torch.randn(total, generator=generator(seed, device),
                      device=device, dtype=dtype)
    out, at = {}, 0
    for path, shape, fan, pad in leaves:
        if fan is None:
            out[path] = torch.zeros(shape, device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        w = buf[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan))
        at += n
        if pad is not None:
            axis, real = pad
            w.narrow(axis, real, shape[axis] - real).zero_()
        out[path] = w
    return out


def draw_layer(m: dict, seed: int, i: int, device,
               dtype=torch.bfloat16) -> dict:
    """Layer ``i``'s weights, path under ``layers/`` -> tensor."""
    return _draw(layer_leaves(m), draw_seed(seed, LAYER_TAG, i), device,
                 dtype)


def draw_global(m: dict, seed: int, device, dtype=torch.bfloat16,
                groups=None) -> dict:
    """The embedding, the output head and the final norm's scale (or only
    the groups of :func:`global_groups` whose indices ``groups`` lists)."""
    out = {}
    for j, leaves in enumerate(global_groups(m)):
        if groups is None or j in groups:
            out.update(_draw(leaves, draw_seed(seed, EMBED_TAG, j), device,
                             dtype))
    return out


def prompt(seed: int, k: int, length: int, vocab: int,
           device) -> torch.Tensor:
    """Prompt ``k`` of the run: (1, length) int64 tokens of the real
    vocabulary."""
    return torch.randint(0, vocab, (1, length), device=device,
                         dtype=torch.int64,
                         generator=generator(draw_seed(seed, PROMPT_TAG, k),
                                             device))
