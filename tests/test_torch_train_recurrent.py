"""The port's train step against the JAX package's for the hybrid and ssm
architectures, recurrentgemma-9b and xlstm-350m, on the CPU: the set-up,
the readings and the rules of ``tests/test_torch_train_archs.py``, with
one and two microbatches (the families whose train step runs the B4 and
B5 kernels on the card).  Readings, the largest over m = 1 and 2 (loss
over the three steps, step 1's grad norm, steps 2-3's, params after step
3): recurrentgemma-9b 2.3e-7, 1.6e-6, 9.2e-5, 3.2e-4; xlstm-350m 2.1e-7,
1.9e-7, 3.1e-6, 2.5e-5.

The stacked ``blocks/`` parameters of these families enter autograd as
per-layer leaves, as the dense families' ``layers/`` do; their gradients
equal those of the stacked leaf (the parent's way) bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.models import model_zoo
from repro_torch.optim import adamw
from repro_torch.train import steps
from test_torch_train_archs import check, readings


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ops here are small: one intra-op thread, so that the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (loss, step 1's grad norm, steps 2-3's, params): about three times the
# readings above
TOL = {"recurrentgemma-9b": (1e-6, 5e-6, 3e-4, 1e-3),
       "xlstm-350m": (1e-6, 1e-6, 1e-5, 1e-4)}


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("arch", sorted(TOL))
def test_train_step_matches_the_reference(arch, m):
    check(readings(arch, m), TOL[arch])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_per_layer_block_leaves_give_the_stacked_gradients(arch,
                                                           monkeypatch):
    """The hybrid and ssm families' stacked ``blocks/`` parameters as
    per-layer autograd leaves (views of each super-block) give the
    gradients of the whole stacked leaf, which the parent fed to autograd,
    bit for bit: each layer's gradient is added into its slice of a
    zero-filled sum either way.  Two microbatches."""
    cfg = reduced_config(arch, microbatches=2)
    model = model_zoo.build_model(cfg)
    params = model.table.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 24)))
    batch = {"tokens": toks, "labels": toks}
    assert steps.STACKED_PREFIX[cfg.family] == "blocks/"
    per_layer = steps._trainable(cfg, params)[1]
    assert {j for path, j, _ in per_layer if path.startswith("blocks/")} \
        == set(range(params["blocks"]["u0"]["ln"]["scale"].shape[0]
                     if arch == "xlstm-350m" else
                     params["blocks"]["u0"]["ln1"]["scale"].shape[0]))
    got, total, _ = steps.make_grads_fn(cfg, model)(params, batch)
    monkeypatch.delitem(steps.STACKED_PREFIX, cfg.family)
    assert all(j is None for _, j, _ in steps._trainable(cfg, params)[1])
    want, want_total, _ = steps.make_grads_fn(cfg, model)(params, batch)
    assert torch.equal(total, want_total)
    for g, w in zip(adamw._leaves(got), adamw._leaves(want)):
        assert torch.equal(g, w)
