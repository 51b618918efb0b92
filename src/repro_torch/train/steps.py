"""train_step / serve_step factories (port of ``train/steps.py``).

The reference's SPMD jobs on one card: a train step takes the global
batch, runs it as ``cfg.microbatches`` microbatches, sums their gradients
in ``cfg.grad_accum_dtype`` (f32, grok-1's bf16) in microbatch order,
a gradient wider than that dtype rounded to it before it is added,
divides by M and applies AdamW in place.
Each microbatch's gradients are taken with ``torch.autograd.grad`` and
added into the f32 sum, never accumulated by ``.backward()`` into bf16
``.grad`` (which would round every partial sum).  The stacked layer
parameters enter autograd as per-layer leaves (views of the stacked
tensors), so each layer's gradient is its own tensor, added into its
slice of the sum, and no full-size zero-filled gradient is made per
layer.

``make_decode_step`` takes the reference's ``mesh`` (``launch/mesh.py``)
as an optional keyword and hands each decode step its ``Sharder``: on a
mesh for which ``brick_active`` holds, the step attends through the
grid-brick cache.  Without a mesh the step gets no Sharder: the one-card
path.  The train and prefill factories take no mesh: a Sharder changes
no computation of the forward on the port's meshes.

While ``torch.profiler`` records, a train step is a ``train.step`` span
of the step tracer (``obs/trace.py``) whose children are each
microbatch's forward and backward (``train.microbatch``), the f32 sum's
fill, adds and divide (``train.grad_sum``) and AdamW
(``train.optimizer``); a prefill is a ``prefill.step`` span.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.params import _flatten, torch_dtype
from repro_torch.obs import trace
from repro_torch.optim.adamw import AdamW, adamw_update
from repro_torch.parallel.sharding import Sharder

#: model families whose parameters under a path prefix are stacked on a
#: leading layer axis (super-block axis for hybrid and ssm) and read per
#: layer through ``transformer.layer_params``, and that prefix
STACKED_PREFIX = {"dense": "layers/", "moe": "layers/", "vlm": "layers/",
                  "hybrid": "blocks/", "ssm": "blocks/"}


def cross_entropy(logits, labels, vocab_size: int):
    """logits (B,S,Vp) any dtype, labels (B,S) integer; mean CE over the
    real vocab (the padded slots are masked out of the partition
    function)."""
    lf = logits.float()
    vp = lf.shape[-1]
    if vp != vocab_size:
        iota = torch.arange(vp, device=lf.device)
        lf = torch.where(iota >= vocab_size, -1e30, lf)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def _served(positions: int):
    """Mark the traced step's latest unembedding with the positions whose
    logits the step uses."""
    tracer = trace.step_tracer()
    span = None if tracer is None else tracer.last("model.unembed")
    if span is not None:
        span.attrs["served"] = positions


def make_loss_fn(cfg, model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        _served(logits.shape[0] * (logits.shape[1] - 1))
        # next-token prediction: positions 0..S-2 predict labels 1..S-1
        loss = cross_entropy(logits[:, :-1, :], batch["labels"][:, 1:],
                             cfg.vocab_size)
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def _unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def _trainable(cfg, params):
    """The parameter tree as autograd leaves: (the tree the forward
    reads, [(path, layer index or None, leaf)]).  Leaves are detached
    views of the parameters, which stay untouched; a stacked layer path
    becomes a list of per-layer leaves."""
    prefix = STACKED_PREFIX.get(cfg.family)
    tree, leaves = {}, []
    for path, t in _flatten(params).items():
        if prefix is not None and path.startswith(prefix):
            views = [t[i].detach().requires_grad_() for i in
                     range(t.shape[0])]
            tree[path] = views
            leaves += [(path, i, x) for i, x in enumerate(views)]
        else:
            leaf = t.detach().requires_grad_()
            tree[path] = leaf
            leaves.append((path, None, leaf))
    return _unflatten(tree), leaves


def accum_dtype(cfg) -> torch.dtype:
    """The dtype the gradients of ``cfg``'s microbatches are summed in:
    ``cfg.grad_accum_dtype``, f32 with one microbatch (the param dtype's
    gradient upcast, which is exact)."""
    if max(1, cfg.microbatches) > 1:
        return torch_dtype(cfg.grad_accum_dtype)
    return torch.float32


def make_grads_fn(cfg, model):
    """Returns grads_fn(params, batch) -> (grads, total, metrics): the
    gradients of the loss as a tree of ``accum_dtype(cfg)`` tensors, the
    total loss and the metrics, each averaged over
    ``cfg.microbatches`` as the reference does.  Microbatch ``i`` holds
    rows ``[i B / M, (i + 1) B / M)`` of the batch."""
    loss_fn = make_loss_fn(cfg, model)
    m = max(1, cfg.microbatches)
    acc_dt = accum_dtype(cfg)

    def grads_fn(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % m:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{m} microbatches")
        with trace.step_span("train.grad_sum", phase="fill"):
            g_sum = {path: torch.zeros(t.shape, dtype=acc_dt,
                                       device=t.device)
                     for path, t in _flatten(params).items()}
        total = None
        m_sum = None
        per = rows // m
        for i in range(m):
            mb = {key: x[i * per:(i + 1) * per] for key, x in batch.items()}
            with trace.step_span("train.microbatch", i=i), \
                    torch.enable_grad():
                tree, leaves = _trainable(cfg, params)
                tot, met = loss_fn(tree, mb)
                grads = torch.autograd.grad(tot, [x for _, _, x in leaves],
                                            allow_unused=True)
            del tree
            with torch.no_grad(), trace.step_span("train.grad_sum",
                                                  phase="add", i=i):
                for (path, j, _), g in zip(leaves, grads):
                    if g is not None:   # an unused leaf adds zeros
                        acc = g_sum[path] if j is None else g_sum[path][j]
                        if torch.promote_types(g.dtype, acc.dtype) != \
                                acc.dtype:
                            # the reference's ``a + b.astype(acc_dt)``: an
                            # f32 gradient (the router's) is rounded to a
                            # bf16 sum's dtype before it is added (a bf16
                            # one into an f32 sum widens exactly in add_)
                            g = g.to(acc.dtype)
                        acc.add_(g)
            del leaves, grads
            tot = tot.detach()
            met = {key: val.detach() for key, val in met.items()}
            total = tot if total is None else total + tot
            m_sum = met if m_sum is None else \
                {key: m_sum[key] + met[key] for key in m_sum}
        if m > 1:
            with trace.step_span("train.grad_sum", phase="divide"):
                for g in g_sum.values():
                    g.div_(m)
            total = total / m
            m_sum = {key: val / m for key, val in m_sum.items()}
        return _unflatten(g_sum), total, m_sum

    return grads_fn


def make_train_step(cfg, model, opt: Optional[AdamW] = None,
                    lr: float = 3e-4):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    The gradients come from ``make_grads_fn`` (f32 accumulation over
    ``cfg.microbatches``), then AdamW updates ``params`` and ``opt_state``
    in place (the values the reference's new trees hold; one card cannot
    hold two copies at full width).  ``metrics`` holds ``loss``,
    ``aux_loss``, ``grad_norm`` and ``total_loss`` as 0-dim f32 tensors."""
    opt = opt or AdamW(moment_dtype=cfg.opt_moment_dtype)
    grads_fn = make_grads_fn(cfg, model)

    def train_step(params, opt_state, batch):
        tokens = batch["tokens"]
        with trace.step_root("train.step", tokens.device,
                             tokens=tokens.numel()):
            grads, total, metrics = grads_fn(params, batch)
            params, opt_state, opt_metrics = adamw_update(
                params, grads, opt_state, lr, opt)
            del grads
        return params, opt_state, dict(metrics, **opt_metrics,
                                       total_loss=total)

    return train_step


def make_prefill_step(cfg, model):
    """serve prefill: full-sequence forward -> last-position logits."""
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        with trace.step_root("prefill.step", tokens.device,
                             tokens=tokens.numel()):
            logits, _ = model.forward(params, batch)
            _served(logits.shape[0])
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg, model, *, mesh=None):
    """serve decode: one token in, one token's logits out, cache updated
    (through the grid-brick cache where ``brick_active`` holds for the
    mesh's Sharder)."""
    shd = None if mesh is None else Sharder(cfg, mesh)

    def decode_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, batch["tokens"],
                                          shd)
        return logits[:, -1, :], cache

    return decode_step
