"""The paper's own workload: LHC-style event processing.

Each *event* is ~1 MB of raw detector data (paper section 1.1).  We model it
columnar (the ROOT-tree role): per-event scalars plus a tracks matrix.
``EventWorkloadConfig`` sizes one event at ~1 MB to match the paper, and the
Fig-7 crossover benchmark sweeps ``events_per_file`` exactly as the paper
swept raw-event-file size (watershed observed at ~2000 events).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EventWorkloadConfig:
    name: str = "geps-events"
    # one event: scalars + (max_tracks x track_vars) f32 ~ 1 MB (paper 1.1)
    n_scalars: int = 64
    max_tracks: int = 4096
    track_vars: int = 63
    # brick layout
    events_per_brick: int = 256
    replication_factor: int = 2  # paper section 7: redundancy future work
    # calibration passes per event (paper 4.1 "calibration procedure")
    calib_iters: int = 4

    @property
    def event_bytes(self) -> int:
        return 4 * (self.n_scalars + self.max_tracks * self.track_vars)


CONFIG = EventWorkloadConfig()


def reduced() -> EventWorkloadConfig:
    return EventWorkloadConfig(
        n_scalars=8, max_tracks=32, track_vars=7, events_per_brick=16)
