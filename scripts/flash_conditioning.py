"""How far each evaluation of flash attention is from the exact value on
recurrentgemma-9b's 4096-token forward, whose scores spread over ~1e3.

    python3 scripts/flash_conditioning.py [--calls 12] [--rows 256]

Needs one CUDA card.  Builds recurrentgemma-9b at full width from the same
seed as ``chip_smoke.py``, runs its 1 x 4096 forward through the kernels
and keeps the inputs of every flash_attention call.  For each call it
prints one JSON line holding, for each evaluation X,

- ``max_err`` / ``mean_err``: max and mean |X - exact| (exact: the
  function in float64, ``chip_smoke.flash_exact``);
- ``outside_exact``: elements outside FA_TOL of the exact value;
- ``outside_plain_f32``: elements outside FA_TOL of the plain version in
  f32 (the per-call check of ``chip_smoke.shadow_kernels``);

for X in: the tensor-core kernel (bf16 out, what the model uses), the plain
version in f32 and that rounded to bf16 (what the model's f32 comparison
run uses), the CUDA-core kernel in f32 on the upcast inputs and rounded to
bf16, and the exact value rounded to bf16 (a kernel that makes no error
but its output's rounding).

Then, for the last ``--rows`` query rows of the first call, the scores
S = q.k^T of every head: exact (float64), f32 (cuBLAS, TF32 off) and on
the tensor cores from the same bf16 operands (a Triton dot, which Triton
lowers to wgmma on this card): chained over the head dim as the kernel
does, and as one fresh accumulator for each 16-wide slice summed in f32.
Each is reported as the max, mean and mean signed (towards |S|) error in
units of the scaled score, over all keys of the window and over the keys
within 10 of their row's max (those whose weight exceeds e^-10)."""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def capture_forward(n_calls):
    """recurrentgemma-9b's forward through the kernels, with the inputs
    and outputs of its first ``n_calls`` flash calls."""
    from repro_torch.models import transformer
    cfg, model, params = cs.build_lm(cs.RG_ARCH)
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(3)                 # chip_smoke's phase_prefill tokens
    toks = torch.randint(0, cfg.vocab_size, (1, cs.FORWARD_LEN[cfg.name]),
                         generator=gen, device=cs.DEVICE)
    kern_fa, calls = transformer.flash_attention, []

    def keep(q, k, v, **kw):
        out = kern_fa(q, k, v, **kw)
        if len(calls) < n_calls:
            calls.append((q.clone(), k.clone(), v.clone(), kw, out.clone()))
        return out

    transformer.flash_attention = keep
    try:
        with torch.inference_mode():
            model.forward(params, {"tokens": toks})
    finally:
        transformer.flash_attention = kern_fa
    del model, params
    cs.release()
    return calls


KAPPAS = (0, 8, 16, 32, 64)


def stats(x, exact, plain, sens, tol):
    x = x.double()
    err = (x - exact).abs()
    room = tol[1] + tol[0] * exact.abs()
    row = {"max_err": float(err.max()), "mean_err": float(err.mean()),
           "outside_plain_f32": int(((x - plain.double()).abs() >
                                     tol[1] + tol[0] * plain.double().abs())
                                    .sum())}
    for kappa in KAPPAS:
        row[f"outside_exact_k{kappa}"] = int((err > room + kappa * sens)
                                             .sum())
    return row


def compare_call(i, q, k, v, kw, kern):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    tol = cs.FA_TOL[q.dtype]
    exact, sens = cs.flash_exact(q, k, v, sensitivity=True, **kw)
    plain = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    # the same function with the head dim summed in the other order
    plain_rev = flash_attention_ref(q.float().flip(-1), k.float().flip(-1),
                                    v.float(), **kw)
    simt = flash_attention_cuda(q.float(), k.float(), v.float(), **kw)
    evals = {"kernel_bf16": kern, "plain_f32": plain,
             "plain_f32_to_bf16": plain.to(torch.bfloat16),
             "plain_f32_reversed": plain_rev,
             "cuda_core_f32": simt,
             "exact_to_bf16": exact.to(torch.bfloat16)}
    # faults the check must see: the kernel with its scale off by eps
    scale = kw.get("scale") or q.shape[-1] ** -0.5
    for eps in (1e-4, 1e-5, 1e-6):
        evals[f"kernel_scale_x(1+{eps:g})"] = flash_attention_cuda(
            q, k, v, **{**kw, "scale": scale * (1 + eps)})
    row = {"call": i, "shape": list(q.shape), "kv": list(k.shape),
           "window": kw.get("window"), "max_abs_out": float(
               exact.abs().max()), "max_sens": float(sens.max()),
           "elements_sens_over_1e-3": int((sens > 1e-3).sum())}
    for name, x in evals.items():
        row[name] = stats(x, exact, plain, sens, tol)
    # elements where X misses the exact value and the plain version in
    # f32 does not
    room = tol[1] + tol[0] * exact.abs()
    p_off = (plain.double() - exact).abs() > room
    for name in ("kernel_bf16", "plain_f32_reversed"):
        off = (evals[name].double() - exact).abs() > room
        row[f"{name}.off_where_plain_on"] = int((off & ~p_off).sum())
    return row


def triton_qk():
    """S = q.k^T of one head from bf16 operands on the tensor cores, f32
    accumulators: chained over the head dim (CHAIN), or one product of
    each BK-wide slice into its own plane of the output."""
    import triton
    globals()["tl"] = importlib.import_module("triton.language")

    @triton.jit
    def qk(q_ptr, k_ptr, out_ptr, M, N, D: tl.constexpr, BK: tl.constexpr,
           CHAIN: tl.constexpr, BM: tl.constexpr, BN: tl.constexpr):
        rm = tl.program_id(0) * BM + tl.arange(0, BM)
        rn = tl.program_id(1) * BN + tl.arange(0, BN)
        acc = tl.zeros((BM, BN), tl.float32)
        for c in tl.static_range(D // BK):
            rk = c * BK + tl.arange(0, BK)
            a = tl.load(q_ptr + rm[:, None] * D + rk[None, :])
            b = tl.load(k_ptr + rn[None, :] * D + rk[:, None])
            if CHAIN:
                acc = tl.dot(a, b, acc)
            else:
                part = tl.dot(a, b)
                tl.store(out_ptr + c * M * N + rm[:, None] * N + rn[None, :],
                         part)
        if CHAIN:
            tl.store(out_ptr + rm[:, None] * N + rn[None, :], acc)

    return qk


def score_probe(q, k, kw, rows):
    """Errors of S from f32 and tensor-core evaluations, in scaled units,
    relative to u |s| (u = 2^-24), and of s_j - s_max (the row's largest
    exact score) on keys within 10 of it: the differences the softmax
    sees."""
    qk = triton_qk()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = kw.get("scale") or d ** -0.5
    window = kw.get("window")
    r0 = sq - rows
    k_lo = max(0, r0 + (sk - sq) - window + 1) if window else 0
    n = sk - k_lo
    n_pad = -(-n // 64) * 64                 # Triton's tiles: zero keys
    keys = torch.zeros((n_pad, d), dtype=k.dtype, device=k.device)
    keys[:n] = k[0, k_lo:, 0]
    q_pos = torch.arange(r0, sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(k_lo, sk, device=q.device)[None, :]
    valid = k_pos <= q_pos
    if window:
        valid &= k_pos > q_pos - window
    names = ["f32", "f32_reversed", "tc_chained"] + \
        [f"tc_k{c}_f32_sum" for c in (16, 32, 64, 128)]
    acc = {name: [] for name in names}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rows": rows, "keys": n, "heads": h}
    near_all, s_abs = [], []
    for hh in range(h):
        qs = q[0, r0:, hh].contiguous()                    # (M, D) bf16
        s64 = (qs.double() @ keys[:n].double().T) * scale
        evals = {"f32": (qs.float() @ keys[:n].float().T).double() * scale,
                 "f32_reversed": (qs.float().flip(-1) @
                                  keys[:n].float().flip(-1).T).double() *
                 scale}
        grid = (rows // 64, n_pad // 64)
        chained = torch.empty((rows, n_pad), dtype=torch.float32,
                              device=q.device)
        qk[grid](qs, keys, chained, rows, n_pad, D=d, BK=64, CHAIN=True,
                 BM=64, BN=64)
        evals["tc_chained"] = chained[:, :n].double() * scale
        for c in (16, 32, 64, 128):
            parts = torch.empty((d // c, rows, n_pad), dtype=torch.float32,
                                device=q.device)
            qk[grid](qs, keys, parts, rows, n_pad, D=d, BK=c, CHAIN=False,
                     BM=64, BN=64)
            tot = parts[0, :, :n].clone()
            for j in range(1, d // c):
                tot += parts[j, :, :n]
            evals[f"tc_k{c}_f32_sum"] = tot.double() * scale
        masked = s64.masked_fill(~valid, float("-inf"))
        top = masked.argmax(dim=1, keepdim=True)
        near = valid & (s64 >= masked.gather(1, top) - 10)
        near_all.append(near)
        s_abs.append(s64.abs().masked_fill(~valid, 0).amax())
        for name, s in evals.items():
            err = s - s64
            acc[name].append((err, err - err.gather(1, top),
                              torch.sign(s64), s64.abs()))
    torch.backends.cuda.matmul.allow_tf32 = prev
    out["max_abs_scaled_score"] = float(torch.stack(s_abs).max())
    unit = 2.0 ** -24
    for name, pieces in acc.items():
        e = torch.cat([err[m] for (err, _, _, _), m in zip(pieces, near_all)])
        de = torch.cat([dif[m] for (_, dif, _, _), m in
                        zip(pieces, near_all)])
        sg = torch.cat([sgn[m] for (_, _, sgn, _), m in
                        zip(pieces, near_all)])
        mag = torch.cat([a[m] for (_, _, _, a), m in zip(pieces, near_all)])
        rel = e.abs() / (unit * mag.clamp(min=1e-300))
        out[name] = {
            "near_max_n": int(e.numel()), "max_err": float(e.abs().max()),
            "mean_err": float(e.abs().mean()),
            "mean_signed_towards_abs": float((e * sg).mean()),
            "max_err_in_u_abs_s": float(rel.max()),
            "p99_err_in_u_abs_s": float(rel.quantile(0.99)),
            "max_err_of_s_minus_smax": float(de.abs().max()),
            "mean_err_of_s_minus_smax": float(de.abs().mean())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=12)
    ap.add_argument("--rows", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    fa_kernel.build()
    print(cs.nvidia_smi_line(), flush=True)
    calls = capture_forward(args.calls)
    for i, (q, k, v, kw, out) in enumerate(calls):
        print(json.dumps(compare_call(i, q, k, v, kw, out)), flush=True)
    q, k, _, kw, _ = calls[0]
    print(json.dumps({"scores": score_probe(q, k, kw, args.rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
