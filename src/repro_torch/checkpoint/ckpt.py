"""Checkpointing with restore by logical path (port of
``checkpoint/ckpt.py``).

The reference's format and behaviour:
- leaves are saved by LOGICAL PATH (the ParamTable path), so a checkpoint
  restores onto any other layout;
- ``<dir>/step_<n>/{manifest.json, arrays.npz}``, each array under its
  path with ``/`` written as ``__``, the manifest holding the step, the
  caller's ``extra`` and each leaf's dtype and shape;
- writes are atomic (a tmp dir, then a rename), saves can run on a
  background thread (the train loop blocks only on the device-to-host
  copy), and a retention policy keeps the last N steps.

A bfloat16 leaf is written as the reference writes it: 2-byte records
(numpy's ``'<V2'``, the descr numpy gives the reference's ``ml_dtypes``
bfloat16) under the manifest dtype ``"bfloat16"``.  On reading, a leaf's
bits are reinterpreted by the manifest's dtype whatever numpy's descr
says, through ``uint16`` for bfloat16 (so neither JAX nor ``ml_dtypes`` is
needed).  The reference hands such a leaf back as numpy's ``|V2``, which
its trainer cannot place on a device (C-ref9); the port restores it as a
bfloat16 tensor, which is what lets its trainer resume a bf16 model.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.models.params import torch_dtype

#: numpy's descr of the reference's bfloat16 arrays (``ml_dtypes``)
BF16_DESCR = "<V2"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def to_host(leaf):
    """A leaf as a host array and its manifest dtype: a tensor copied to
    the host (bfloat16 as its bits, ``uint16``), a numpy array or scalar
    as it is."""
    if isinstance(leaf, torch.Tensor):
        # a copy on every device: a CPU tensor's .cpu() is the tensor itself
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npz(path: Path, arrays: dict) -> None:
    """``np.savez``'s archive (stored, zip64), with bfloat16 leaves as
    2-byte records under the reference's descr."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype == "bfloat16":
                    arr = np.asarray(arr, order="C")   # keeps 0-d arrays
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": BF16_DESCR, "fortran_order": False,
                              "shape": tuple(arr.shape)})
                    fid.write(arr.tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(arr),
                                              allow_pickle=False)


def save_checkpoint(directory, step: int, tree, *,
                    extra: Optional[dict] = None):
    """Atomic full-tree save: <dir>/step_<n>/{manifest.json, arrays.npz}.
    Leaves may be tensors on any device, numpy arrays, or host arrays
    already taken by ``to_host`` (``(array, dtype)`` pairs)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = _flatten(tree)
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for path, leaf in flat.items():
        arr, dtype = leaf if isinstance(leaf, tuple) else to_host(leaf)
        arrays[path.replace("/", "__")] = (arr, dtype)
        manifest["leaves"][path] = {"dtype": dtype,
                                    "shape": list(arr.shape)}
    _write_npz(tmp / "arrays.npz", arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name[5:]) for p in directory.glob("step_*")]
    return max(steps) if steps else None


def _as_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The stored bits as a tensor of the manifest's dtype."""
    arr = np.asarray(arr, order="C")        # keeps 0-d arrays
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.view(np.dtype(dtype))).to(device)


def restore_checkpoint(directory, step: Optional[int] = None, *,
                       device: Union[str, torch.device] = "cuda"):
    """Restore a tree of tensors on ``device`` (each leaf in its manifest
    dtype) and the manifest; the latest step when ``step`` is None."""
    from repro_torch.kernels import resolve_device
    device = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {}
    with np.load(d / "arrays.npz") as data:
        for path, meta in manifest["leaves"].items():
            arr = data[path.replace("/", "__")]
            torch_dtype(meta["dtype"])        # a dtype the port knows
            flat[path] = _as_tensor(arr, meta["dtype"], device)
    return _unflatten(flat), manifest


class CheckpointManager:
    """Async saves + retention, restart discovery."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps = []

    def save(self, step: int, tree, extra=None):
        # snapshot to host BEFORE handing to the writer thread: the train
        # loop updates the device tensors in place on the next step
        host_tree = _unflatten({path: to_host(leaf)
                                for path, leaf in _flatten(tree).items()})
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host_tree, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree, extra)

    def _write(self, step, host_tree, extra):
        save_checkpoint(self.directory, step, host_tree, extra=extra)
        self.saved_steps.append(step)
        self._enforce_retention()

    def _write_async(self, step, host_tree, extra):
        try:
            self._write(step, host_tree, extra)
        except BaseException as e:  # re-raised by wait() on the caller
            self._error = e

    def _enforce_retention(self):
        steps = sorted(int(p.name[5:]) for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def wait(self):
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, device: Union[str, torch.device] = "cuda"):
        self.wait()
        return restore_checkpoint(self.directory, device=device)
