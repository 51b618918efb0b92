"""The yardstick's arithmetic: the H100's peaks, the useful flops of a
step, and the work of one attention call.

Copied from the port's ``analysis/flops.py`` (``model_flops``) and
``analysis/roofline.py`` (the peaks, ``attention_pairs``,
``flash_attention_work``, ``flash_attention_bwd_work``, ``bound``), with
one change: heads are the published ones.  The port holds qwen3-14b's 40
q heads as 48, 8 of them zero; the copies here count 40, so the padded
heads are waste in every share, and a kernel that skips them is credited
for it.  ``model_flops`` also counts the published vocabulary, not the
padded one, and a prefill's unembedding at the served position only.  Parameter counts come from the configuration's numbers, not
from the program's parameter table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12       # bf16 tensor cores, dense, one H100 SXM at 700 W
PEAK_FLOPS_FP32 = 67e12   # float32 outside the tensor cores
HBM_BW = 3.35e12          # bytes/s of HBM3

PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS,
                 "float32": PEAK_FLOPS_FP32}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_params(m: dict) -> int:
    """Parameters of one dense decoder layer at the published heads."""
    d, h, k, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                      m["head_dim"], m["d_ff"])
    attn = 2 * d * h * hd + 2 * d * k * hd
    norms = 2 * d + (2 * hd if m.get("qk_norm") else 0)
    return attn + 3 * d * f + norms


def active_params(m: dict) -> int:
    """Parameters outside the embedding and the output head (plus the
    final norm), as ``analysis/flops.param_counts`` counts them."""
    return m["num_layers"] * layer_params(m) + m["d_model"]


def model_flops(m: dict, kind: str, tokens: int, sequences: int) -> float:
    """Useful flops of ``sequences`` sequences of ``tokens`` tokens in
    all.  A train step: 6 N D, and the unembedding's 6 d V D (every
    position's logits feed the loss).  A prefill: the forward's 2 N D,
    and one unembedding a sequence (2 d V): only the last position's
    logits are served, so the port's logits of every other position are
    waste, as the padded vocabulary's rows (V here is the published
    vocabulary) and the padded heads are."""
    unembed = m["d_model"] * m["vocab_size"]
    if kind == "train":
        return 6.0 * (active_params(m) + unembed) * tokens
    if kind == "prefill":
        return 2.0 * active_params(m) * tokens + 2.0 * unembed * sequences
    raise ValueError(f"no model flops for kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do: ``flops`` on operands of ``dtype``
    and ``bytes`` moved (each input read once, each output written
    once)."""
    flops: float
    bytes: float
    dtype: str


def bound_s(work: Work) -> float:
    """The least time the card could take for ``work``: bytes at the HBM
    rate or flops at the peak of its dtype, whichever is longer."""
    return max(work.bytes / HBM_BW, work.flops / PEAK_BY_DTYPE[work.dtype])


def attention_pairs(sq: int, sk: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """Valid (query, key) pairs of one head: causal, the keys up to the
    query's position (the queries are the last Sq of Sk positions), a
    window leaving the last ``window`` of them; not causal, every key."""
    if not causal:
        return sq * sk
    return sum(min(sk, i + sk - sq + 1, window or sk) for i in range(sq))


def flash_attention_work(b, sq, sk, h, kh, d, dtype="bfloat16", window=None,
                         causal=True, with_lse=False) -> Work:
    """The attention forward: q, k, v read and the output (and the f32
    lse when asked) written once; 4 flops per (query, valid key, head,
    head-dim): the S and P.V products."""
    nbytes = ITEMSIZE[dtype] * (2 * b * sq * h * d + 2 * b * sk * kh * d)
    if with_lse:
        nbytes += 4 * b * h * sq
    flops = 4 * b * h * attention_pairs(sq, sk, causal, window) * d
    return Work(flops, nbytes, dtype)


def flash_attention_bwd_work(b, sq, sk, h, kh, d, dtype="bfloat16",
                             window=None, causal=True) -> Work:
    """The attention backward: q, k, v, out and dout read and dq, dk, dv
    written once; 10 flops per (query, valid key, head, head-dim), the
    five products any backward needs (S, dP, dV, dK, dQ)."""
    nbytes = ITEMSIZE[dtype] * (4 * b * sq * h * d + 4 * b * sk * kh * d)
    flops = 10 * b * h * attention_pairs(sq, sk, causal, window) * d
    return Work(flops, nbytes, dtype)


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals inside [lo, hi]:
    time covered by at least one of them, counted once."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total
