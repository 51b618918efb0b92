"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write ``step_<n>/{manifest.json, arrays.npz}`` with leaves
under their logical paths.  A checkpoint written by either restores in
the other with the same bits, bfloat16 leaves included: the port writes
a bf16 leaf as the reference does (2-byte records under numpy's
``'<V2'``, the manifest dtype ``"bfloat16"``, the same .npy header bytes)
and reads any 2-byte record back by the manifest's dtype.  The reference
hands such a leaf back as numpy's ``|V2``, which its trainer cannot put
on a device (C-ref9); its own bits are compared here through
``ml_dtypes``.  Retention keeps the newest N steps; an async save
snapshots the tensors before it returns."""
import json
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro_torch.checkpoint import ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ops here are small: one intra-op thread, so that the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    """numpy leaves: f32, bf16 (as its f32 values) and an int32 count."""
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(3, 4, 5)).astype(ml_dtypes.bfloat16)
    return {"params": {"w": rng.normal(size=(4, 6)).astype(np.float32),
                       "layers": {"e": bf}},
            "opt_state": {"count": np.int32(3)}}


def _as_torch(tree):
    def leaf(x):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(x))
    return jax.tree.map(leaf, tree)


def _bits(x):
    """A leaf's bytes whatever its type (tensor, ml_dtypes or |V2)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return np.asarray(x.numpy()).tobytes()
    return np.asarray(x).tobytes()


def _header(path, key):
    with zipfile.ZipFile(path) as zf, zf.open(key + ".npy") as f:
        return f.read(128)


def test_port_restores_the_reference_checkpoint(tmp_path):
    tree = _tree()
    jax_ckpt.save_checkpoint(tmp_path, 5, jax.tree.map(jnp.asarray, tree),
                             extra={"name": "x"})
    got, manifest = ckpt.restore_checkpoint(tmp_path, device="cpu")
    assert manifest["step"] == 5 and manifest["extra"] == {"name": "x"}
    e = got["params"]["layers"]["e"]
    assert e.dtype == torch.bfloat16 and tuple(e.shape) == (3, 4, 5)
    assert got["params"]["w"].dtype == torch.float32
    assert got["opt_state"]["count"].dtype == torch.int32
    for path, leaf in ckpt._flatten(tree).items():
        assert _bits(ckpt._flatten(got)[path]) == _bits(leaf), path


def test_reference_restores_the_port_checkpoint(tmp_path):
    tree = _tree(1)
    ckpt.save_checkpoint(tmp_path / "port", 7, _as_torch(tree))
    jax_ckpt.save_checkpoint(tmp_path / "ref", 7,
                             jax.tree.map(jnp.asarray, tree))
    got, manifest = jax_ckpt.restore_checkpoint(tmp_path / "port")
    want, want_manifest = jax_ckpt.restore_checkpoint(tmp_path / "ref")
    assert manifest == want_manifest       # dtypes, shapes, step
    assert manifest["leaves"]["params/layers/e"]["dtype"] == "bfloat16"
    for path, leaf in ckpt._flatten(tree).items():
        g = ckpt._flatten(got)[path]
        assert g.dtype == ckpt._flatten(want)[path].dtype, path
        assert _bits(g) == _bits(leaf), path
    # the same .npy header for the bf16 leaf: 2-byte records, '<V2'
    key = "params__layers__e"
    assert _header(tmp_path / "port" / "step_00000007" / "arrays.npz", key) \
        == _header(tmp_path / "ref" / "step_00000007" / "arrays.npz", key)


def test_port_round_trip_keeps_every_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((5, 3), generator=gen).bfloat16(),
            "b": {"c": torch.randn((2, 2), generator=gen)},
            "count": torch.tensor(9, dtype=torch.int32)}
    ckpt.save_checkpoint(tmp_path, 1, tree)
    got, manifest = ckpt.restore_checkpoint(tmp_path, 1, device="cpu")
    assert json.loads((tmp_path / "step_00000001" / "manifest.json")
                      .read_text()) == manifest
    for path, leaf in ckpt._flatten(tree).items():
        g = ckpt._flatten(got)[path]
        assert g.dtype == leaf.dtype and torch.equal(g, leaf), path


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_retention_and_snapshot(tmp_path, async_save):
    mgr = ckpt.CheckpointManager(tmp_path, keep=2, async_save=async_save)
    x = torch.zeros(4)
    for step in range(1, 5):
        x.fill_(step)
        mgr.save(step, {"x": x})
        x.fill_(-1)                 # after save returns: not in the snapshot
    mgr.wait()
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000003", "step_00000004"]
    assert mgr.saved_steps == [1, 2, 3, 4]
    got, _ = mgr.restore_latest(device="cpu")
    assert torch.equal(got["x"], torch.full((4,), 4.0))
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_restore_raises_without_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path, device="cpu")
    assert ckpt.latest_step(tmp_path / "none") is None


def test_c_ref9_the_reference_trainer_cannot_resume_bf16(tmp_path):
    """The reference's trainer saves a bf16 model, then cannot resume it:
    ``restore_latest(abstract=None)`` hands the bf16 leaves back as
    numpy's ``|V2`` and ``jax.device_put`` raises a TypeError.  The port's
    trainer resumes the same scenario and runs the remaining steps."""
    from repro.configs.registry import reduced_config as jax_reduced
    from repro.launch.mesh import make_mesh_of
    from repro.train.trainer import Trainer as JaxTrainer
    from repro.train.trainer import TrainerConfig as JaxTrainerConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    over = dict(num_layers=1, param_dtype="bfloat16", dtype="bfloat16")
    mesh = make_mesh_of((1, 1), ("data", "model"))

    def jax_trainer(steps):
        return JaxTrainer(jax_reduced("qwen3-14b", **over), JaxTrainerConfig(
            total_steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / "ref"),
            global_batch=2, seq_len=8, async_ckpt=False), mesh)

    assert jax_trainer(2).train()["steps"] == 2
    with pytest.raises(TypeError, match="V2"):
        jax_trainer(3).train()

    def port_trainer(steps):
        return Trainer(reduced_config("qwen3-14b", **over), TrainerConfig(
            total_steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / "port"),
            global_batch=2, seq_len=8, async_ckpt=False), device="cpu")

    assert port_trainer(2).train()["steps"] == 2
    resumed = port_trainer(3)
    assert resumed.train()["steps"] == 1
    params, _ = resumed.state
    assert params["embed"]["table"].dtype == torch.bfloat16
