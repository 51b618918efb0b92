"""A dense pre-norm decoder in plain float32 PyTorch: its forward, its
loss, its gradient by autograd and AdamW, for the benchmark's check.

It follows the published models, with the layout of the port's parameter
tree (``weights.py``) and two of the port's departures, which the
configuration files record:

- q head ``h`` attends with kv head ``h // (Hp / K)`` over the ``Hp``
  heads held (qwen3-14b: 48 for its 40, so head h reads kv head h // 6
  where the published model reads h // 5); padded heads are zero and
  left out here;
- no q/k/v bias (chatglm3-6b publishes one).

RMSNorm multiplies by ``1 + scale`` (scale 0 is the published unit
weight), q/k-norm (qwen3) comes before the rotary embedding, the rotary
embedding is GPT-NeoX's rotate-half (qwen3) or ChatGLM's interleaved
pairs over the first half of the head dim, the MLP is SwiGLU, and the
loss is next-token cross entropy over the real vocabulary.

The training path recomputes each layer in its backward (only layer
inputs are kept), and attention runs over blocks of queries, so a step
at 4,096 tokens a row fits beside the float32 state.  ``fp8=True``
computes every product from operands rounded to float8 e4m3 with a
per-tensor scale (gradients pass the rounding unchanged): the control,
one precision below the bfloat16 the configurations state.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
#: elements of one block of attention scores
SCORE_BLOCK = 1 << 28


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps
    its largest magnitude to 448; the gradient passes unchanged."""
    xd = x.detach()
    scale = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
    q = (xd * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - xd)


class Decoder:
    """The model of one configuration's numbers (``m``, the
    configuration file's ``model``)."""

    def __init__(self, m: dict, *, fp8: bool = False):
        self.m = m
        self.h, self.k, self.hd = m["num_heads"], m["num_kv_heads"], \
            m["head_dim"]
        pad = m.get("pad_heads_to", 0)
        hp = -(-self.h // pad) * pad if pad else self.h
        self.group = hp // self.k
        self.eps = m["norm_eps"]
        self.r = fp8_round if fp8 else (lambda x: x)

    def mm(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))

    def norm(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + scale)

    def rope(self, x, pos):
        """x (B, S, H, D) at positions ``pos`` (S,)."""
        d, theta = x.shape[-1], self.m["rope_theta"]
        style = self.m["rope_style"]
        rd = d if style == "neox" else d // 2
        freq = 1.0 / theta ** (torch.arange(0, rd, 2, dtype=torch.float64,
                                            device=x.device) / rd)
        ang = pos.double()[:, None] * freq                  # (S, rd / 2)
        cos = torch.cos(ang).float()[None, :, None, :]
        sin = torch.sin(ang).float()[None, :, None, :]
        if style == "neox":
            x1, x2 = x[..., :rd // 2], x[..., rd // 2:]
            return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
        if style == "half":
            xe, xo = x[..., 0:rd:2], x[..., 1:rd:2]
            rot = torch.stack([xe * cos - xo * sin, xo * cos + xe * sin],
                              dim=-1).flatten(-2)
            return torch.cat([rot, x[..., rd:]], dim=-1)
        raise ValueError(f"rope style {style!r}")

    def attention(self, q, k, v):
        """Causal attention of q (B, S, H, D) over k, v (B, S, K, D), each
        kv head's q heads together, over blocks of queries (each block
        reads the keys up to its last query)."""
        b, s = q.shape[:2]
        scale = 1.0 / math.sqrt(self.hd)
        pos = torch.arange(s, device=q.device)
        heads = []
        for j in range(self.k):
            lo, hi = j * self.group, min((j + 1) * self.group, self.h)
            if lo >= hi:
                continue
            g = hi - lo
            blk = max(128, min(s, SCORE_BLOCK // (b * g * s)))
            rows = []
            for a in range(0, s, blk):
                e = min(s, a + blk)
                sc = self.mm("bqhd,bkd->bhqk", q[:, a:e, lo:hi],
                             k[:, :e, j]) * scale
                masked = pos[None, :e] > pos[a:e, None]
                p = torch.softmax(sc.masked_fill(masked, -math.inf), dim=-1)
                rows.append(self.mm("bhqk,bkd->bqhd", p, v[:, :e, j]))
            heads.append(torch.cat(rows, dim=1))
        return torch.cat(heads, dim=2)

    def layer(self, w, x, pos):
        """One layer: w maps the paths under ``layers/`` to f32 tensors."""
        h = self.norm(x, w["ln1/scale"])
        q = self.mm("bsd,dhk->bshk", h, w["attn/wq"][:, :self.h])
        k = self.mm("bsd,dhk->bshk", h, w["attn/wk"])
        v = self.mm("bsd,dhk->bshk", h, w["attn/wv"])
        if self.m.get("qk_norm"):
            q = self.norm(q, w["attn/q_norm"])
            k = self.norm(k, w["attn/k_norm"])
        o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        x = x + self.mm("bshk,hkd->bsd", o, w["attn/wo"][:self.h])
        h = self.norm(x, w["ln2/scale"])
        gate = self.mm("bsd,df->bsf", h, w["mlp/w_gate"])
        up = self.mm("bsd,df->bsf", h, w["mlp/w_in"])
        return x + self.mm("bsf,fd->bsd", F.silu(gate) * up, w["mlp/w_out"])

    def logits(self, g, x):
        """Logits over the padded vocabulary, its padded slots at -inf."""
        out = self.mm("bsd,dv->bsv", self.norm(x, g["final_norm/scale"]),
                      g["out/head"])
        vocab = self.m["vocab_size"]
        if out.shape[-1] > vocab:
            out = torch.cat([out[..., :vocab], torch.full_like(
                out[..., vocab:], -math.inf)], dim=-1)
        return out

    def loss(self, g, x, tokens):
        """Mean next-token cross entropy: position i predicts i + 1."""
        lg = self.logits(g, x)[:, :-1]
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               tokens[:, 1:].reshape(-1))

    def hidden(self, layer_weights, g, tokens, keep=False):
        """The residual stream after the last layer, and (with ``keep``)
        each layer's input.  ``layer_weights(i)`` gives layer i's
        weights."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = g["embed/table"][tokens]
        inputs = []
        for i in range(self.m["num_layers"]):
            if keep:
                inputs.append(x)
            x = self.layer(layer_weights(i), x, pos)
        return x, inputs

    @torch.no_grad()
    def last_logits(self, layer_weights, g, tokens):
        """Logits (B, Vp) at the last position of ``tokens``."""
        x, _ = self.hidden(layer_weights, g, tokens)
        return self.logits(g, x[:, -1:])[:, 0]

    def grads(self, params, tokens, microbatches: int):
        """The mean loss over ``microbatches`` equal slices of the rows of
        ``tokens`` and its gradient (the mean of theirs), as a tree like
        ``params`` ({"global": {path: t}, "layers": [{path: t}]})."""
        rows = tokens.shape[0]
        if rows % microbatches:
            raise ValueError(f"{rows} rows in {microbatches} microbatches")
        per = rows // microbatches
        grads = tree_map(torch.zeros_like, params)
        total = 0.0
        layers = params["layers"]
        for i in range(microbatches):
            tok = tokens[i * per:(i + 1) * per]
            pos = torch.arange(tok.shape[1], device=tok.device)
            with torch.no_grad():
                x, inputs = self.hidden(lambda j: layers[j],
                                        params["global"], tok, keep=True)
            x.requires_grad_()
            g = {key: params["global"][key].detach().requires_grad_()
                 for key in ("final_norm/scale", "out/head")}
            with torch.enable_grad():
                loss = self.loss(g, x, tok) / microbatches
                dx, dn, dh = torch.autograd.grad(
                    loss, [x, g["final_norm/scale"], g["out/head"]])
            total += float(loss.detach())
            grads["global"]["final_norm/scale"] += dn
            grads["global"]["out/head"] += dh
            for j in reversed(range(len(layers))):
                xin = inputs[j].detach().requires_grad_()
                inputs[j] = None
                w = {key: t.detach().requires_grad_()
                     for key, t in layers[j].items()}
                with torch.enable_grad():
                    y = self.layer(w, xin, pos)
                    out = torch.autograd.grad(y, [xin, *w.values()],
                                              grad_outputs=dx)
                dx = out[0]
                for key, gw in zip(w, out[1:]):
                    grads["layers"][j][key] += gw
            grads["global"]["embed/table"].index_add_(
                0, tok.reshape(-1), dx.reshape(-1, dx.shape[-1]))
        return total, grads


def tree_map(fn, *trees):
    """``fn`` over the leaves of parameter trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, list):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def leaves(tree) -> dict:
    """Leaf name -> tensor: ``path`` outside the layers, ``layers/path[i]``
    for layer i."""
    out = dict(tree["global"])
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers/{key}[{i}]": t for key, t in layer.items()})
    return out


def global_norm(tree) -> float:
    return math.sqrt(sum(float(torch.sum(t.double() ** 2))
                         for t in leaves(tree).values()))


def adamw_step(params, grads, m1, t: int, *, lr, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1, grad_clip=1.0):
    """AdamW step ``t`` (1 or 2) in place, the gradient clipped to a global
    norm of ``grad_clip`` first.  Step 1 leaves its first moment in
    ``grads`` and returns it; step 2 reads it as ``m1`` (its second
    moment is (1 - b2) (m1 / (1 - b1))^2, so only m1 is kept)."""
    clip = min(1.0, grad_clip / max(global_norm(grads), 1e-9))
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    flat_m1 = leaves(m1) if m1 is not None else None
    flat_g = leaves(grads)
    for name, p in leaves(params).items():
        g = flat_g[name].mul_(clip)
        if t == 1:
            m, v = (1 - b1) * g, (1 - b2) * g * g
        else:
            prev = flat_m1[name]
            m = b1 * prev + (1 - b1) * g
            v = b2 * (1 - b2) * (prev / (1 - b1)) ** 2 + (1 - b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p
        p.sub_(lr * step)
        if t == 1:
            g.copy_(m)
    return grads if t == 1 else None


def _f32(tree: dict) -> dict:
    return {key: t.float() for key, t in tree.items()}


def follow_training(m: dict, seed: int, batches: list, *, microbatches: int,
                    optimizer: dict, steps: int, device,
                    fp8: bool = False) -> dict:
    """The first ``steps`` (1 or 2) AdamW updates from the seed's weights
    on ``batches`` (``steps + 1`` token tensors of (rows, S)): the loss of
    each of the ``steps + 1`` batches (the last one's at the weights the
    updates left), each leaf's norm of the first gradient before its
    clip, and each leaf's norm of the change the updates made."""
    from portbench import weights
    dec = Decoder(m, fp8=fp8)
    hp = {key: optimizer[key] for key in ("lr", "b1", "b2", "eps",
                                          "weight_decay", "grad_clip")}
    dt = weights.served_dtype(m)
    with exact_float32():
        params = {"global": _f32(weights.draw_global(m, seed, device, dt)),
                  "layers": [_f32(weights.draw_layer(m, seed, i, device, dt))
                             for i in range(m["num_layers"])]}
        losses, first, m1 = [], None, None
        for t in range(1, steps + 1):
            loss, grads = dec.grads(params, batches[t - 1], microbatches)
            losses.append(loss)
            if t == 1:
                first = {name: float(torch.linalg.vector_norm(g))
                         for name, g in leaves(grads).items()}
            m1 = adamw_step(params, grads, m1, t, **hp)
            del grads
        del m1
        tokens = batches[steps]
        per = tokens.shape[0] // microbatches
        last = 0.0
        with torch.no_grad():
            for i in range(microbatches):
                tok = tokens[i * per:(i + 1) * per]
                x, _ = dec.hidden(lambda j: params["layers"][j],
                                  params["global"], tok)
                last += float(dec.loss(params["global"], x, tok))
        losses.append(last / microbatches)
        change = {}
        w0 = _f32(weights.draw_global(m, seed, device, dt))
        change.update({key: float(torch.linalg.vector_norm(
            params["global"][key] - w0[key])) for key in w0})
        for i in range(m["num_layers"]):
            w0 = _f32(weights.draw_layer(m, seed, i, device, dt))
            change.update({f"layers/{key}[{i}]": float(
                torch.linalg.vector_norm(params["layers"][i][key] - w0[key]))
                for key in w0})
    return {"loss": losses, "grad": first, "change": change}


def prefill_logits(m: dict, seed: int, tokens, device,
                   fp8: bool = False) -> torch.Tensor:
    """Logits (Vp,) at the last position of ``tokens`` (1, S), the
    weights drawn again from the seed a layer at a time."""
    from portbench import weights
    dec = Decoder(m, fp8=fp8)
    dt = weights.served_dtype(m)
    with exact_float32():
        g = _f32(weights.draw_global(m, seed, device, dt))
        return dec.last_logits(
            lambda i: _f32(weights.draw_layer(m, seed, i, device, dt)), g,
            tokens)[0]
