"""Mesh construction (port of ``launch/mesh.py``).

A :class:`Mesh` names its axes and holds an object array of
``torch.device`` in the mesh's shape, so ``mesh.devices.shape`` gives the
axis sizes as it does for the reference's ``jax.sharding.Mesh``.  The port
drives one card: a mesh of more than one real device is out of its
scope and raises.  A larger mesh is *emulated* when the caller asks for
it by name (``emulate=True``): every shard sits on the one device, the
way ``SpmdBackend(mesh_devices=D)`` runs its D shards in lockstep, and
``Sharder`` and ``core/brick_attention.py`` read the axis sizes from it.
Nothing falls back to emulation on its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    devices: np.ndarray          # object array of torch.device, mesh-shaped
    emulated: bool = False


def _device_count(device_type: str) -> int:
    if device_type in ("cpu", "meta"):     # meta: the dry run's device
        return 1
    if device_type == "cuda":
        return torch.cuda.device_count()
    raise ValueError(f"no mesh of {device_type!r} devices")


def make_mesh_of(shape: Sequence[int], axes: Sequence[str], *,
                 device: Union[str, torch.device] = "cuda",
                 emulate: bool = False) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  One device (``device``,
    ``cuda:0`` where it names no index) makes a mesh of one; a mesh of more devices is emulated on that
    one device when ``emulate`` is set, and raises otherwise: with fewer
    devices than the mesh needs, as the reference does, and with as
    many, because a real mesh of several devices is outside the one-card
    port."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    n = math.prod(shape)
    dev_type = torch.device(device).type
    have = _device_count(dev_type)
    kind = "CUDA" if dev_type == "cuda" else dev_type
    if n < 1:
        raise ValueError(f"mesh shape {shape} holds no device")
    if n > 1 and not emulate:
        if have < n:
            raise RuntimeError(
                f"need {n} devices for mesh {shape}, have {have} "
                f"{kind} device(s) in this process (emulate=True puts "
                "every shard on one device)")
        raise RuntimeError(
            f"a mesh of {n} real devices {shape} is outside the one-card "
            "port (emulate=True puts every shard on one device)")
    if have < 1:
        raise RuntimeError(f"no {kind} device in this process")
    one = torch.device(device)
    if dev_type == "cuda" and one.index is None:
        one = torch.device("cuda", 0)
    devs = np.empty(shape, dtype=object)
    devs.fill(one)
    return Mesh(axes, devs, emulated=n > 1)


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device: Union[str, torch.device] = "cuda") -> Mesh:
    """A small mesh over the devices this process sees: ``(n, 1)`` by
    default, n the device count of ``device``'s type.  On a host of
    several cards that is a real mesh, which ``make_mesh_of`` refuses:
    ``serve --mode lm`` decodes on a (1, 1) mesh of its device instead."""
    if shape is None:
        shape = (_device_count(torch.device(device).type), 1)
    return make_mesh_of(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: single pod (16, 16) over
    ``("data", "model")``, multi-pod (2, 16, 16) over ``("pod", "data",
    "model")``.  It raises with the CUDA device count this process sees:
    fewer than the mesh needs, or a real mesh outside the one-card
    port."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_of(shape, axes, device="cuda")
