"""Plain PyTorch version of the mLSTM kernel: the port of the reference's
``models/xlstm.py:mlstm_parallel``, its oracle, with the kernel's
signature (the reference's ``kernels/mlstm_scan/ref.py`` re-exports it).
It lives here, and ``models/xlstm.py:mlstm_parallel`` calls it, so the
kernel package does not import the model.  A wrapper runs it for CPU
tensors, and the CUDA kernel is held against it on the card."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30


def mlstm_ref(q, k, v, log_i, log_f, *, chunk_size: int = 1024):
    """Chunkwise-parallel mLSTM, tiled over queries and keys as the
    reference: q,k,v (B,S,H,hd); log_i/log_f (B,S,H) f32 -> (B,S,H,hd) in
    q's dtype.

    As the reference: ``chunk = min(chunk_size, S)``, the sequence padded
    to a multiple of it (``log_i`` with -1e30, ``F`` with its last value),
    ``q * scale`` rounded to q's dtype, the dots in f32, and ``a`` rounded
    to v's dtype before the second product.  Key chunks after the query
    chunk are skipped: they are fully masked, so under the reference's
    running max they change neither m (``max(m, -1e30) = m``), nor num or
    den (weights ``exp(-1e30 - m) = 0``, correction 1), bit for bit."""
    b, s, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    fcum = torch.cumsum(log_f, dim=1)  # (B,S,H): sum of log f up to t

    c = min(chunk_size, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG)
        fcum = torch.cat([fcum, fcum[:, -1:].expand(b, pad, h)], dim=1)
    sp = n_chunks * c

    qf = (q.float() * scale).to(q.dtype)
    qc = qf.reshape(b, n_chunks, c, h, hd)
    kc = k.reshape(b, n_chunks, c, h, hd)
    vc = v.reshape(b, n_chunks, c, h, hd)
    ic = log_i.reshape(b, n_chunks, c, h)
    fc = fcum.reshape(b, n_chunks, c, h)
    idx = torch.arange(sp, device=q.device).reshape(n_chunks, c)

    outs = []
    for i in range(n_chunks):
        q_i, f_i, qidx = qc[:, i].float(), fc[:, i], idx[i]
        m = torch.full((b, c, h), NEG, dtype=torch.float32, device=q.device)
        num = torch.zeros((b, c, h, hd), dtype=torch.float32,
                          device=q.device)
        den = torch.zeros((b, c, h), dtype=torch.float32, device=q.device)
        for j in range(i + 1):
            k_j, v_j = kc[:, j], vc[:, j]
            logw = (f_i[:, :, None, :] - fc[:, j][:, None, :, :]
                    + ic[:, j][:, None, :, :])  # (B,c,c,H)
            mask = idx[j][None, :] <= qidx[:, None]  # (c,c)
            logw = torch.where(mask[None, :, :, None], logw, NEG)
            logw = logw.permute(0, 1, 3, 2)  # (B,c,H,c)
            m_new = torch.maximum(m, logw.amax(dim=-1))
            wts = torch.exp(logw - m_new[..., None])
            corr = torch.exp(m - m_new)
            sc = torch.einsum("bqhd,bchd->bqhc", q_i, k_j.float())
            a = wts * sc  # (B,c,H,c)
            num = num * corr[..., None] + torch.einsum(
                "bqhc,bchd->bqhd", a.to(v_j.dtype).float(), v_j.float())
            den = den * corr + a.sum(dim=-1)
            m = m_new
        normalizer = torch.maximum(den.abs(), torch.exp(-m))
        outs.append((num / normalizer[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :s]
