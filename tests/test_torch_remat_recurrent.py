"""Remat of the hybrid and ssm families on the CPU: the super-blocks under
``cfg.remat_policy`` (``models/hybrid.py``, ``models/xlstm.py``), the
sLSTM's time loop checkpointed in chunks of 256 steps, and the plain
mLSTM's query-chunk checkpoint (``kernels/mlstm_scan/ref.py``).

- Reduced recurrentgemma-9b (one (rec, rec, attn) super-block and a
  one-unit tail) and xlstm-350m (two (mLSTM, sLSTM) super-blocks), f32,
  batch 2 x 512 tokens, so the sLSTM's 256-step chunks are taken: the
  gradients of ``make_grads_fn`` with ``remat_policy="full"`` equal those
  with ``"none"`` bit for bit, and so do loss and metrics.  Both stay
  within ``tests/test_torch_train_recurrent.py``'s tolerances of the
  reference's ``jax.value_and_grad`` on the same weights and batch (loss
  and grad norm, relative).
- Remat takes effect: the tensors autograd saves outside the checkpoints
  under ``"full"`` are a small part of those under ``"none"``; the
  chunked sLSTM saves less than the unchunked loop, with the same
  gradients bit for bit; the plain mLSTM under autograd saves nothing the
  size of a query chunk's (B, c, H, c) weights, with the gradients of the
  loop without the checkpoint bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks

from repro.configs.registry import reduced_config as jax_reduced
from repro.launch.mesh import make_mesh_of
from repro.models import model_zoo as jax_zoo
from repro.optim import adamw as jax_adamw
from repro.parallel.sharding import Sharder
from repro.train import steps as jax_steps
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels.mlstm_scan import ref as ml_ref
from repro_torch.models import model_zoo, xlstm
from repro_torch.models.params import _flatten, params_from_reference
from repro_torch.optim import adamw
from repro_torch.train import steps
from test_torch_train_recurrent import TOL

SEQ, BATCH = 512, 2


def _batch(cfg):
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _saved_bytes(forward):
    """(``forward()``, the bytes of the tensors autograd saved during it
    outside any checkpoint: a checkpoint's own hooks take the ones inside
    it).  Run the backward outside: its recompute saves tensors too."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with saved_tensors_hooks(pack, lambda t: t):
        out = forward()
    return out, total[0]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the embedding's backward (an accumulating
    ``index_put_``) adds a token's rows in a thread-dependent order on the
    CPU with more, so two runs of the same step differ there in the last
    bits, remat or not."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_full_remat_gives_the_gradients_of_none_and_of_the_reference(arch):
    jcfg = jax_reduced(arch)
    jmodel = jax_zoo.build_model(jcfg)
    jparams = jmodel.table.init(jax.random.key(0))
    batch = _batch(jcfg)
    shd = Sharder(jcfg, make_mesh_of((1, 1), ("data", "model")))
    loss_fn = jax_steps.make_loss_fn(jcfg, jmodel, shd)
    (_, jmet), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want_loss = float(jmet["loss"])
    want_norm = float(jax_adamw.global_norm(jgrads))

    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    runs = {}
    for policy in ("full", "none"):
        cfg = reduced_config(arch, remat_policy=policy)
        assert cfg.microbatches == 1
        model = model_zoo.build_model(cfg)
        params = params_from_reference(cfg, jax.tree.map(np.asarray,
                                                         jparams), "cpu")
        runs[policy] = steps.make_grads_fn(cfg, model)(params, tb)
    (g_full, tot_full, met_full), (g_none, tot_none, met_none) = \
        runs["full"], runs["none"]
    flat_full, flat_none = _flatten(g_full), _flatten(g_none)
    assert set(flat_full) == set(flat_none)
    for path in flat_full:
        assert torch.equal(flat_full[path], flat_none[path]), path
    assert torch.equal(tot_full, tot_none)
    assert {k: float(v) for k, v in met_full.items()} == \
        {k: float(v) for k, v in met_none.items()}
    loss = float(met_full["loss"])
    norm = float(adamw.global_norm(g_full))
    assert abs(loss - want_loss) / abs(want_loss) <= TOL[arch][0]
    assert abs(norm - want_norm) / abs(want_norm) <= TOL[arch][1]


@pytest.mark.parametrize("arch,share", [("recurrentgemma-9b", 0.5),
                                        ("xlstm-350m", 0.25)])
def test_full_remat_saves_a_small_part_of_the_activations(arch, share):
    """Outside the checkpointed super-blocks, ``"full"`` saves what the
    embedding, the final norm, the unembedding, the loss and (the hybrid
    family's) unchecked tail need; ``"none"`` saves every layer's
    activations as well."""
    tb = {k: torch.from_numpy(v).long()
          for k, v in _batch(reduced_config(arch)).items()}
    saved = {}
    for policy in ("full", "none"):
        cfg = reduced_config(arch, remat_policy=policy)
        model = model_zoo.build_model(cfg)
        params = model.table.init(torch.Generator().manual_seed(0), "cpu")
        loss_fn = steps.make_loss_fn(cfg, model)
        tree, _ = steps._trainable(cfg, params)
        _, saved[policy] = _saved_bytes(lambda: loss_fn(tree, tb))
    assert saved["full"] < share * saved["none"], saved


def test_slstm_chunked_remat_saves_less_with_the_same_gradients(monkeypatch):
    cfg = reduced_config("xlstm-350m")
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    p = _layer(params["blocks"]["u1"], 0)     # the first sLSTM layer
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(BATCH, SEQ, cfg.d_model)).astype(np.float32))
    out = {}
    chunked = xlstm.SLSTM_REMAT_CHUNK
    for chunk in (chunked, SEQ):   # SEQ: no chunk taken
        monkeypatch.setattr(xlstm, "SLSTM_REMAT_CHUNK", chunk)
        leaves = {k: v.detach().requires_grad_() for k, v in
                  _flatten(p).items()}
        xin = x.clone().requires_grad_()

        (y, _), saved = _saved_bytes(
            lambda: xlstm.slstm_block(cfg, _unflat(leaves), xin))
        out[chunk] = saved, torch.autograd.grad(y.square().sum(),
                                                [xin, *leaves.values()])
    (part, g1), (whole, g2) = out[chunked], out[SEQ]
    assert part < 0.5 * whole, (part, whole)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_plain_mlstm_checkpoints_each_query_chunk(monkeypatch):
    rng = np.random.default_rng(6)
    b, s, h, d, c = 2, 512, 2, 16, 128
    ops = [rng.normal(size=(b, s, h, d)) for _ in range(3)] + \
        [rng.normal(size=(b, s, h)), -np.abs(rng.normal(size=(b, s, h)))]
    out = {}
    for ck in (True, False):
        if not ck:   # the loop as it was, without the checkpoint
            monkeypatch.setattr(ml_ref, "checkpoint",
                                lambda fn, *a, use_reentrant: fn(*a))
        leaves = [torch.from_numpy(x.astype(np.float32)).requires_grad_()
                  for x in ops]
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        with saved_tensors_hooks(pack, lambda t: t):
            y = ml_ref.mlstm_ref(*leaves, chunk_size=c)
        grads = torch.autograd.grad(y.square().sum(), leaves)
        out[ck] = (max(sizes), grads)
    (big_ck, g_ck), (big_plain, g_plain) = out[True], out[False]
    assert big_ck <= b * s * h * d < b * c * h * c <= big_plain
    for x, y in zip(g_ck, g_plain):
        assert torch.equal(x, y)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unflat(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree
