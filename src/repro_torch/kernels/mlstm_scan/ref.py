"""Plain PyTorch version of the mLSTM kernel: the port of the reference's
``models/xlstm.py:mlstm_parallel``, its oracle, with the kernel's
signature (the reference's ``kernels/mlstm_scan/ref.py`` re-exports it).
It lives here, and ``models/xlstm.py:mlstm_parallel`` calls it, so the
kernel package does not import the model.  A wrapper runs it for CPU
tensors, and the CUDA kernel is held against it on the card."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


def mlstm_ref(q, k, v, log_i, log_f, *, chunk_size: int = 1024,
              with_stats: bool = False):
    """Chunkwise-parallel mLSTM, tiled over queries and keys as the
    reference: q,k,v (B,S,H,hd); log_i/log_f (B,S,H) f32 -> (B,S,H,hd) in
    q's dtype; with ``with_stats``, (out, L, sg) with the row stats the
    backward reads, (B,S,H) f32 each: ``L_t = m_t + log n_t`` and ``sg_t =
    sign(den_t)`` where ``|den_t| > exp(-m_t)``, else 0, for the row
    stabiliser m and the normaliser ``n_t = max(|den_t|, exp(-m_t))``.

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

    def q_block(i, q_i, f_i):
        """Query chunk ``i`` over key chunks 0..i: (out, L, sg)."""
        q_i, qidx = q_i.float(), idx[i]
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
        return ((num / normalizer[..., None]).to(q.dtype),
                m + torch.log(normalizer),
                torch.where(den.abs() > torch.exp(-m), torch.sign(den), 0.0))

    # as the reference's jax.checkpoint of q_block: under autograd each
    # query chunk keeps its inputs and is recomputed in the backward
    block = (functools.partial(checkpoint, q_block, use_reentrant=False)
             if torch.is_grad_enabled() else q_block)
    parts = [block(i, qc[:, i], fc[:, i]) for i in range(n_chunks)]
    out = torch.cat([x[0] for x in parts], dim=1)[:, :s]
    if not with_stats:
        return out
    return (out, torch.cat([x[1] for x in parts], dim=1)[:, :s],
            torch.cat([x[2] for x in parts], dim=1)[:, :s])


def mlstm_bwd_ref(q, k, v, log_i, log_f, out, dout, stats=None, *,
                  rows: int = 256):
    """The gradient of the mLSTM in closed form, in plain PyTorch: dq, dk,
    dv (B,S,H,D), d log_i, d log_f (B,S,H), all in the operands' dtype
    (the caller upcasts: f32, or f64 for an exact value).  ``out`` is the
    forward's output, ``dout`` the gradient of the loss with respect to
    it, and ``stats`` the forward's row stats ``(L, sg)``
    (``mlstm_ref(with_stats=True)``); None computes them here from the
    gates' row max.

    ``out_t = num_t / n_t`` does not depend on the stabiliser m: every
    term of num, den and exp(-m) scales by exp(-m).  So m is a constant
    here, and with ``sc_ts = q_t.k_s / sqrt(D)``, ``logw_ts = F_t - F_s +
    i_s`` (s <= t), ``E_ts = exp(logw_ts - L_t)``:

    - ``P = E sc``, ``dP_ts = do_t.v_s``, ``delta_t = sg_t (do_t.out_t)``;
    - ``dv_s = sum_t P_ts do_t``;
    - ``dsc = E (dP - delta)``, so ``dq_t = sum_s dsc_ts k_s / sqrt(D)``
      and ``dk_s = sum_t dsc_ts q_t / sqrt(D)``;
    - ``dlogw = P (dP - delta)``: ``d log_i`` is its column sum, ``dF``
      its row sum minus its column sum, and ``d log_f`` the reverse
      cumulative sum of ``dF`` (F is the cumulative sum of log f).

    Flash attention's backward with a signed P and no softmax.  Query rows
    go ``rows`` at a time (memory)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    fcum = torch.cumsum(log_f, dim=1)
    pos = torch.arange(s, device=q.device)
    qs = q * scale
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    col = torch.zeros_like(log_i)
    row = torch.empty_like(log_i)
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s)
        causal = (pos[None, :] <= pos[r0:r1, None])[None, :, :, None]
        logw = (fcum[:, r0:r1, None, :] - fcum[:, None, :, :]
                + log_i[:, None, :, :])                       # (B,R,S,H)
        logw = torch.where(causal, logw, NEG)
        sc = torch.einsum("bthd,bshd->btsh", qs[:, r0:r1], k)
        if stats is None:
            m = logw.amax(dim=2)
            den = (torch.exp(logw - m[:, :, None]) * sc).sum(dim=2)
            norm = torch.maximum(den.abs(), torch.exp(-m))
            lse = m + torch.log(norm)
            sg = torch.where(den.abs() > torch.exp(-m), torch.sign(den),
                             0.0)
        else:
            lse, sg = (x[:, r0:r1] for x in stats)
        e = torch.where(causal, torch.exp(logw - lse[:, :, None]), 0.0)
        p = e * sc
        dp = torch.einsum("bthd,bshd->btsh", dout[:, r0:r1], v)
        delta = sg * (dout[:, r0:r1] * out[:, r0:r1]).sum(dim=-1)
        dpd = dp - delta[:, :, None]
        dsc = e * dpd
        dlogw = p * dpd
        dv += torch.einsum("btsh,bthd->bshd", p, dout[:, r0:r1])
        dk += torch.einsum("btsh,bthd->bshd", dsc, qs[:, r0:r1])
        dq[:, r0:r1] = torch.einsum("btsh,bshd->bthd", dsc, k) * scale
        col += dlogw.sum(dim=1)
        row[:, r0:r1] = dlogw.sum(dim=2)
    dlf = (row - col).flip(1).cumsum(1).flip(1)
    return dq, dk, dv, col, dlf


def mlstm_bwd_split_ref(q, k, v, log_i, log_f, out, dout, stats):
    """The tensor-core backward's arithmetic (``csrc/mlstm_bwd_wgmma.cuh``)
    in plain PyTorch, on the forward's row stats ``stats = (L, sg)``:

    - ``c_t = (F_t - L_t) log2(e) + log2(D^-1/2)``, ``g_s = (i_s - F_s)
      log2(e)`` and ``W = 2^(c_t + g_s)`` where ``s <= t``, else 0 (W is E
      with the scale folded in);
    - S = q.k and dP = dO.v in f32 chains of 128 head dims, added as ((c0
      + c1) + (c2 + c3)) at D 512 (chains in pairs, then the pairs' sums,
      in general);
    - ``P = W S``, ``dS = W (dP - delta)``, ``delta_t = sg_t (dO_t.o_t)``;
    - dV and dK from P and dS rounded to bf16 (one term each), summed over
      stages of 16 query rows in order; dQ from dS over stages of 16 keys
      in order.  A key block or output half of the kernel
      sums the same stages in the same order (the stages before its
      diagonal add exact zeros), so neither appears here;
    - d log_i the column sums of ``dlogw = P (dP - delta)`` in f32 (P not
      rounded), stage by stage; the row sums the same over key stages;
      d log_f the reverse cumulative sum of their differences.

    q, k, v, out, dout (B,S,H,D) (the kernel's are bf16; f32 operands
    holding bf16 values give its arithmetic before the outputs'
    rounding), log_i, log_f, L, sg (B,S,H) f32 -> dq, dk, dv in q's dtype,
    d log_i, d log_f f32 (B,S,H).  Every pair of the sequence at once:
    (B, S, S, H) tensors, for small S or the card."""
    b, s, h, d = q.shape
    tile, slice_k = 16, 128                 # a stage's rows or keys; a chain
    log2e = 1.0 / math.log(2.0)
    lse, sg = stats
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, dout))
    fcum = torch.cumsum(log_f, dim=1)
    c = (fcum - lse) * log2e + math.log2(d ** -0.5)
    g = (log_i - fcum) * log2e
    pos = torch.arange(s, device=q.device)
    causal = pos[None, :] <= pos[:, None]                   # (t, s)
    w = torch.where(causal[None, :, :, None],
                    torch.exp2(c[:, :, None, :] + g[:, None, :, :]), 0.0)

    def chains(x, y):
        parts = [torch.einsum("bthd,bshd->btsh", x[..., c0:c0 + slice_k],
                              y[..., c0:c0 + slice_k])
                 for c0 in range(0, d, slice_k)]
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] if i + 1 < len(parts)
                     else parts[i] for i in range(0, len(parts), 2)]
        return parts[0]

    delta = sg * (gf * of).sum(dim=-1)
    p = w * chains(qf, kf)                                   # (B,t,s,H)
    dpd = chains(gf, vf) - delta[:, :, None, :]
    dlogw = p * dpd
    pb = p.to(torch.bfloat16).float()
    db = (w * dpd).to(torch.bfloat16).float()
    dq = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    col = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    row = torch.zeros_like(col)
    for t0 in range(0, s, tile):
        st = slice(t0, t0 + tile)
        dv += torch.einsum("btsh,bthd->bshd", pb[:, st], gf[:, st])
        dk += torch.einsum("btsh,bthd->bshd", db[:, st], qf[:, st])
        col += dlogw[:, st].sum(dim=1)
        dq += torch.einsum("btsh,bshd->bthd", db[:, :, st], kf[:, st])
        row += dlogw[:, :, st].sum(dim=2)
    dlf = (row - col).flip(1).cumsum(1).flip(1)
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), col, dlf)


def mlstm_split_ref(q, k, v, log_i, log_f, *, chunk: int,
                    rows: int = 64, slice_k: int = 128):
    """The tensor-core kernel's arithmetic (``csrc/mlstm_wgmma.cuh``) in
    plain PyTorch, for query tiles of ``rows`` rows whose keys ``[0,
    min(rows * (i + 1), S))`` are cut into splits of ``chunk`` keys:

    - the row max from prefix scans of the gates alone: ``m_t = max(F_t +
      M_t, 0.1 * NEG)``, ``M_t = max_{s<=t} (i_s - F_s)``;
    - the weight with the scale folded in, ``2^(c_t + g_s)``, ``c_t =
      log2(D^-1/2) - M_t log2(e)``, ``g_s = (i_s - F_s) log2(e)``, 0 above
      the diagonal;
    - S in f32 chains of ``slice_k`` head dims, each half of the head dim
      summing its chains in order, then the halves added;
    - ``a = 2^(c_t + g_s) S``; a.v with a as two bf16 terms (its rounding
      and the rounding of the rest), as the kernel feeds the tensor cores;
      den the f32 sum of a;
    - each split's (num, den) over its keys, added in split order;
    - ``num / max(|den|, exp(-m))`` in q's dtype.

    q, k, v (B,S,H,D) (the kernel's are bf16; f32 operands holding bf16
    values give its arithmetic before the output's rounding); log_i/log_f
    (B,S,H) f32 -> (B,S,H,D) in q's dtype."""
    b, s, h, d = q.shape
    log2e = 1.0 / math.log(2.0)
    fcum = torch.cumsum(log_f, dim=1)                       # (B,S,H)
    dif = log_i - fcum
    big_m = torch.cummax(dif, dim=1).values
    m = torch.clamp(fcum + big_m, min=0.1 * NEG)
    g = dif * log2e
    c = math.log2(d ** -0.5) - big_m * log2e
    pos = torch.arange(s, device=q.device)
    causal = pos[None, :] <= pos[:, None]                   # (t, s)
    w = torch.where(causal[None, :, :, None],
                    torch.exp2(c[:, :, None, :] + g[:, None, :, :]), 0.0)
    half = d // 2
    step = min(slice_k, half)
    qf, kf = q.float(), k.float()
    halves = []
    for h0 in (0, half):
        part = None
        for c0 in range(h0, h0 + half, step):
            chain = torch.einsum("bthd,bshd->btsh", qf[..., c0:c0 + step],
                                 kf[..., c0:c0 + step])
            part = chain if part is None else part + chain
        halves.append(part)
    a = w * (halves[0] + halves[1])                          # (B,t,s,H)
    big = a.to(torch.bfloat16).float()
    small = (a - big).to(torch.bfloat16).float()
    vf = v.float()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s)
        num = den = None
        for lo in range(0, r1, chunk):
            hi = min(lo + chunk, r1)
            sl = (slice(None), slice(r0, r1), slice(lo, hi))
            n = torch.einsum("btsh,bshd->bthd", big[sl], vf[:, lo:hi]) + \
                torch.einsum("btsh,bshd->bthd", small[sl], vf[:, lo:hi])
            dn = a[sl].sum(dim=2)
            num = n if num is None else num + n
            den = dn if den is None else den + dn
        norm = torch.maximum(den.abs(), torch.exp(-m[:, r0:r1]))
        out[:, r0:r1] = (num / norm[..., None]).to(q.dtype)
    return out
