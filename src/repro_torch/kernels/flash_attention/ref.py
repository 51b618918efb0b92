"""Plain PyTorch version of the flash-attention kernel: the repeat-KV GQA
attention of ``models/attention.py`` with the kernel's signature (port of
``kernels/flash_attention/ref.py``).  A wrapper runs it for CPU tensors,
and the CUDA kernel is held against it on the card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attention


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        logit_cap=None):
    """q (B,Sq,H,D), k/v (B,Sk,K,D) -> (B,Sq,H,D); the queries are the
    last Sq of the Sk positions when causal."""
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, dtype=torch.int64, device=q.device) + \
        (sk - sq if causal else 0)
    k_pos = torch.arange(sk, dtype=torch.int64, device=q.device)
    return attention(q, k, v, q_positions=q_pos, k_positions=k_pos,
                     causal=causal, window=window, scale=scale,
                     logit_cap=logit_cap)
