"""Event records: the columnar stand-in for the paper's ROOT trees.

An *event* (paper section 1.1: one LHC collision, ~1 MB) is stored columnar:
per-event scalar variables plus a variable-length tracks matrix (padded to
``max_tracks`` with a validity count).  A batch of events is an
``EventBatch`` dict of tensors whose leading dim is the event index — this
is the unit the grid bricks hold.

``host_events`` draws with numpy, so the same seed gives the same bytes
as the JAX package's ``host_events``; ``synthetic_events`` draws with a
``torch.Generator`` on the target device and is never used for parity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.kernels import resolve_device

# canonical scalar variable names (index into the scalars column)
SCALAR_VARS = (
    "e_total", "e_t_miss", "pt_lead", "eta_lead", "phi_lead", "m_inv",
    "n_jets", "n_leptons",
)
TRACK_VARS = ("pt", "eta", "phi", "d0", "z0", "charge", "chi2")


@dataclasses.dataclass
class EventSchema:
    """Shape contract of an EventBatch: scalar-column count, track
    padding width, and per-track variable count (the query compiler
    resolves variable names against this)."""
    n_scalars: int
    max_tracks: int
    track_vars: int

    @classmethod
    def from_config(cls, cfg) -> "EventSchema":
        """Build from a geps_events config object."""
        return cls(cfg.n_scalars, cfg.max_tracks, cfg.track_vars)

    def scalar_index(self, name: str) -> int:
        """Column of scalar variable ``name`` (ValueError on unknown)."""
        return SCALAR_VARS.index(name)  # raises ValueError on unknown

    def track_index(self, name: str) -> int:
        """Column of track variable ``name`` (ValueError on unknown)."""
        return TRACK_VARS.index(name)

    def event_bytes(self) -> int:
        """Approximate serialized bytes per event (f32 columns + ids)."""
        return 4 * (self.n_scalars + self.max_tracks * self.track_vars + 2)


def make_batch(scalars, tracks, n_tracks, event_id) -> Dict[str, object]:
    """Assemble the canonical EventBatch dict from its four columns."""
    return {
        "scalars": scalars,      # (N, n_scalars) f32
        "tracks": tracks,        # (N, max_tracks, track_vars) f32
        "n_tracks": n_tracks,    # (N,) i32 valid track count
        "event_id": event_id,    # (N,) i32 global id
    }


def synthetic_events(generator: torch.Generator, schema: EventSchema, n: int,
                     id_offset: int = 0,
                     device: Union[str, torch.device] = "cuda"
                     ) -> Dict[str, torch.Tensor]:
    """Generate physically-flavoured synthetic events (heavy-tailed pt
    etc.) on ``device``; ``generator`` must live on that device."""
    dev = resolve_device(device)
    kw = dict(generator=generator, device=dev)
    scalars = torch.abs(torch.randn((n, schema.n_scalars), **kw) * 50.0)
    tracks = torch.randn((n, schema.max_tracks, schema.track_vars), **kw)
    # pt column: exponential tail, always positive
    if schema.track_vars > 0:
        pt = torch.empty((n, schema.max_tracks), device=dev)
        tracks[:, :, 0] = pt.exponential_(generator=generator) * 10.0
    n_tracks = torch.randint(1, schema.max_tracks + 1, (n,), **kw,
                             dtype=torch.int32)
    event_id = torch.arange(id_offset, id_offset + n, dtype=torch.int32,
                            device=dev)
    return make_batch(scalars, tracks, n_tracks, event_id)


def abstract_events(schema: EventSchema, n: int):
    """Meta-device tensors with an EventBatch's shapes and dtypes (no
    storage) — the shape contract for planning without data."""
    meta = torch.device("meta")
    return make_batch(
        torch.empty((n, schema.n_scalars), dtype=torch.float32, device=meta),
        torch.empty((n, schema.max_tracks, schema.track_vars),
                    dtype=torch.float32, device=meta),
        torch.empty((n,), dtype=torch.int32, device=meta),
        torch.empty((n,), dtype=torch.int32, device=meta),
    )


def concat_batches(batches):
    """Concatenate EventBatches along the event axis."""
    return {k: torch.cat([b[k] for b in batches], dim=0) for k in batches[0]}


def host_events(rng: np.random.Generator, schema: EventSchema, n: int,
                id_offset: int = 0):
    """NumPy event generator for brick stores (byte-equal to the JAX
    package's ``host_events`` for the same generator state)."""
    scalars = np.abs(rng.normal(size=(n, schema.n_scalars)) * 50.0)
    tracks = rng.normal(size=(n, schema.max_tracks, schema.track_vars))
    if schema.track_vars > 0:
        tracks[:, :, 0] = rng.exponential(size=(n, schema.max_tracks)) * 10.0
    n_tracks = rng.integers(1, schema.max_tracks + 1, size=(n,))
    return make_batch(
        scalars.astype(np.float32), tracks.astype(np.float32),
        n_tracks.astype(np.int32),
        np.arange(id_offset, id_offset + n, dtype=np.int32))
