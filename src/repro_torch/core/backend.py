"""Execution backends: ONE contract for "execute a dispatch window".

The paper's JSE is a single contract — distribute a query over
brick-resident data, merge partials at the submit server — but the repo
grew two divergent realizations of it: the virtual-time simulation
(fragment plans, streaming ``on_partial``, failure scripts, per-packet
telemetry) and the SPMD lockstep step (none of these, merge only at step
end).  This module collapses the divergence behind one interface so every
service/fabric feature (streaming, cache write-through, cost-model
calibration, window planning) works identically on both paths:

- :class:`ExecutionBackend` — the protocol:
  ``run_batch(job_ids, *, plan, on_partial, failure_script, packet_ramp)
  -> (results, JobStats)``.  Exactly the surface
  ``JobSubmissionEngine.run_job_batch_simulated`` already exposes, now
  named and substitutable.
- :class:`SimulatedBackend` — thin wrapper over the event-driven
  virtual-time grid simulation (``core/jse.py``).  Time is virtual, the
  per-packet compute is real.
- :class:`SpmdBackend` — the shard realization as a **chunked
  streaming scan**: each device-resident brick (= shard that never
  moves) is swept in chunks, every chunk evaluated through the same
  :func:`~repro_torch.core.jse.eval_plan_slice` primitive as the simulation,
  and a :class:`~repro_torch.core.jse.PacketPartial` emitted per chunk in
  deterministic merge order (brick id ascending, offset ascending) — so
  prefix snapshots fed to a :class:`~repro_torch.core.merge.MergeAccumulator`
  are bit-identical to ``tree_merge`` of the same prefix, and a window
  executed with the same chunk boundaries on either backend produces
  bit-identical partial streams and final results.
- :class:`ChunkController` — EWMA sizing for ``chunk_events`` from
  measured per-chunk wall times (the PROOF-rule shape
  ``WindowController`` uses for window widths, applied to chunks).
- :class:`PlanSplit` — the mixed-window kernel/plain split: plan
  targets inside the fused ``event_filter`` kernel's conjunctive family
  run as one kernel sub-batch per chunk, the rest through the plain
  fragment walk, reassembled in slot order so prefixes stay
  bit-identical.
- :func:`make_backend` — string-keyed factory (``"sim"`` / ``"spmd"``)
  the service layer and ``launch/serve.py --backend`` use.

The JAX package's ``docs/backends.md`` states the full contract
(merge-order determinism, clock semantics, failure semantics, kernel
fragment fusion).  On one card the port keeps adaptive chunk sizing,
double buffering, the lockstep mesh emulation and the autotune, which
sweeps the CUDA kernel's launch shape (``kernels/event_filter/tune.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Protocol, Tuple, \
    Union, runtime_checkable

import numpy as np
import torch

from repro_torch.core import merge as merge_lib
from repro_torch.core import query as query_lib
from repro_torch.core.brick import BrickStore
from repro_torch.core.catalog import DONE, MetadataCatalog
from repro_torch.core.jse import (JobStats, JobSubmissionEngine,
                                  PacketPartial, PacketTelemetry, TimeModel,
                                  eval_plan_slice, prepare_window)
from repro_torch.core.packets import ramp_cap


@runtime_checkable
class ExecutionBackend(Protocol):
    """The one contract the service layer executes dispatch windows
    against.  Implementations own a catalogue + brick store pair and
    TWO mutable attributes the service relies on: ``cost_weights`` (the
    service installs fitted :class:`~repro_torch.service.planner.CostWeights`
    there so the scheduler can bound windows by calibrated cost) and
    ``supports_failure_injection`` (checked BEFORE a window is dequeued;
    a backend that omits it is treated as not supporting failure
    scripts — the safe direction, since an error raised mid-dispatch
    would strand the window's tickets and streams)."""

    catalog: MetadataCatalog
    store: BrickStore
    cost_weights: Optional[object]
    supports_failure_injection: bool

    def run_batch(self, job_ids: List[int], *,
                  plan: Optional[query_lib.FragmentPlan] = None,
                  on_partial: Optional[
                      Callable[[PacketPartial], None]] = None,
                  failure_script: Optional[Dict[float, int]] = None,
                  packet_ramp: Optional[int] = None
                  ) -> Tuple[List[merge_lib.QueryResult], JobStats]:
        """Execute one shared-scan window of catalogued jobs.

        Contract (both backends): jobs must share bricks/calib_iters;
        ``plan`` (a fragment plan whose roots align with ``job_ids``) is
        built when absent; ``on_partial`` is invoked once per evaluated
        packet/chunk, in the exact merge order, with partials whose
        prefix merges are bit-identical to ``tree_merge`` of that
        prefix; ``packet_ramp`` caps early packet sizes for streaming;
        job statuses move RUNNING -> DONE (or FAILED) in the catalogue;
        returns ``(merged, stats)`` with materialized-fragment results
        in ``stats.fragment_results`` and per-packet compute telemetry
        in ``stats.packet_telemetry``."""
        ...


class SimulatedBackend:
    """The event-driven virtual-time grid simulation behind the
    :class:`ExecutionBackend` contract.

    A thin wrapper over :class:`~repro_torch.core.jse.JobSubmissionEngine`
    (exposed as :attr:`engine` for callers tuning simulation knobs such
    as ``adaptive_packets`` or node speeds): scheduling, straggler
    mitigation, failure injection and virtual makespans are all the
    engine's — this class only pins the contract surface.  The per-packet
    compute runs on the store's device, which must be ``device``."""

    def __init__(self, catalog: MetadataCatalog, store: BrickStore, *,
                 time_model: Optional[TimeModel] = None,
                 node_speed: Optional[Dict[int, float]] = None,
                 adaptive_packets: bool = True,
                 packet_ramp: Optional[int] = None,
                 ramp_factor: float = 2.0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = store.check_device(device)
        self.engine = JobSubmissionEngine(
            catalog, store, time_model=time_model, node_speed=node_speed,
            adaptive_packets=adaptive_packets, packet_ramp=packet_ramp,
            ramp_factor=ramp_factor)
        self.catalog = catalog
        self.store = store
        # fitted cost weights the service installs after telemetry refits
        # (consumed by QueryScheduler window-cost bounding)
        self.cost_weights = None
        #: the virtual grid can kill nodes mid-scan; the service checks
        #: this BEFORE dequeuing a window so an unsupported failure
        #: script fails fast with no state mutated
        self.supports_failure_injection = True
        #: the virtual grid routes packets per node, so the failure
        #: policy's avoid/probe/speculate decision applies here; the
        #: service checks this before passing routing kwargs
        self.supports_routing_policy = True

    @property
    def obs(self):
        """Observability plane handle — stored on the wrapped engine (the
        simulation loop is where packets are scanned), surfaced here so
        the service can install/inspect it backend-agnostically."""
        return self.engine.obs

    @obs.setter
    def obs(self, value):
        """Install the plane on the wrapped engine."""
        self.engine.obs = value

    def submit(self, expr: str, calib_iters: int = 0) -> int:
        """Register a job over every brick in the store (engine passthrough)."""
        return self.engine.submit(expr, calib_iters)

    def run_batch(self, job_ids: List[int], *,
                  plan: Optional[query_lib.FragmentPlan] = None,
                  on_partial: Optional[
                      Callable[[PacketPartial], None]] = None,
                  failure_script: Optional[Dict[float, int]] = None,
                  packet_ramp: Optional[int] = None,
                  route_avoid: Optional[set] = None,
                  probe_quota: Optional[Dict[int, int]] = None,
                  speculate: bool = False,
                  spec_lead_factor: float = 1.5,
                  rereplicated: Optional[List[Tuple[int, int, int]]] = None
                  ) -> Tuple[List[merge_lib.QueryResult], JobStats]:
        """Execute the window on the simulated grid (see
        :meth:`ExecutionBackend.run_batch` for the contract; the routing
        kwargs carry a :class:`~repro_torch.service.policy.PolicyDecision` —
        see ``run_job_batch_simulated`` for their semantics, including
        the ``rereplicated`` brick-copy transfer charge)."""
        return self.engine.run_job_batch_simulated(
            job_ids, plan=plan, on_partial=on_partial,
            failure_script=failure_script, packet_ramp=packet_ramp,
            route_avoid=route_avoid, probe_quota=probe_quota,
            speculate=speculate, spec_lead_factor=spec_lead_factor,
            rereplicated=rereplicated)


class ChunkController:
    """EWMA controller for the SPMD scan's ``chunk_events``.

    The streaming sweet spot for chunk sizing mirrors the PROOF packet
    rule the :class:`~repro_torch.service.frontend.WindowController` applies to
    window widths: a chunk should take about ``target_s`` seconds of
    scan, so the proposal is ``clamp(round(rate * target_s), min_chunk,
    max_chunk)`` where ``rate`` is an EWMA of measured events/second
    over completed chunks.  Chunks too small drown the scan in per-chunk
    dispatch/merge overhead; chunks too large starve the partial stream
    (time-to-first-partial grows linearly in chunk size).

    ``hysteresis`` is the same relative dead-band as the window
    controller's: the held size only moves when the proposal differs
    from it by more than ``hysteresis x current``, so a noisy rate
    estimate doesn't re-chunk every packet (chunk-size churn also churns
    kernel compilation caches, which are keyed on chunk shape).

    Determinism: the controller is a pure function of the observation
    sequence — drive it from an injectable clock
    (``SpmdBackend(clock=...)``) and a fixed seed reproduces the exact
    chunk boundaries, which is what keeps flight logs byte-identical
    under adaptive sizing (see ``tests/test_backend.py``)."""

    def __init__(self, *, initial: int = 64, min_chunk: int = 8,
                 max_chunk: int = 4096, target_s: float = 0.02,
                 alpha: float = 0.3, hysteresis: float = 0.25):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if not (1 <= min_chunk <= max_chunk):
            raise ValueError("need 1 <= min_chunk <= max_chunk")
        if target_s <= 0:
            raise ValueError("target_s must be positive")
        if hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        self.initial = initial
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk
        self.target_s = target_s
        self.alpha = alpha
        self.hysteresis = hysteresis
        self._rate: Optional[float] = None
        self._held: Optional[int] = None

    def observe(self, events: int, wall_s: float) -> None:
        """Record one completed chunk: ``events`` swept in ``wall_s``
        seconds (host-observed, same clock as the backend's)."""
        if events <= 0 or wall_s <= 0:
            return
        rate = events / wall_s
        self._rate = rate if self._rate is None else (
            self.alpha * rate + (1 - self.alpha) * self._rate)

    @property
    def scan_rate(self) -> Optional[float]:
        """Smoothed events/second, or None before the first chunk."""
        return self._rate

    def chunk(self) -> int:
        """Chunk size for the next dispatch: the clamped ``rate *
        target_s`` proposal, filtered through the hysteresis dead-band."""
        if self._rate is None:
            target = max(self.min_chunk,
                         min(self.max_chunk, self.initial))
        else:
            target = max(self.min_chunk,
                         min(self.max_chunk,
                             int(round(self._rate * self.target_s))))
        if self._held is None or \
                abs(target - self._held) > self.hysteresis * self._held:
            self._held = target
        return self._held




@dataclasses.dataclass(frozen=True)
class PlanSplit:
    """The mixed-window kernel/plain split of one fragment plan's targets.

    ``kernel_cols`` are the target slots (roots-then-materialized order,
    exactly :meth:`~repro_torch.core.query.FragmentPlan.targets` order)
    whose expressions matched the fused ``event_filter`` kernel's
    conjunctive family (``match_epilogue``); they run as ONE kernel
    sub-batch per chunk with ``thresholds`` (the ``(4, K_kernel)`` layout
    of ``batch_kernel_params``) and ``var_idx`` (a ``(K_kernel,)`` int32
    tensor), both on the store's device.  ``plain_cols`` hold the
    out-of-family targets (``plain_targets`` the matching AST nodes),
    evaluated through the same shared-memo fragment walk the plan itself
    uses.  Per chunk the two sub-batches are reassembled in the original
    slot order, so partial streams and prefixes stay bit-identical to
    the plain path regardless of how the split falls."""

    kernel_cols: Tuple[int, ...]
    plain_cols: Tuple[int, ...]
    thresholds: Optional[torch.Tensor]  # (4, len(kernel_cols)) or None
    var_idx: Optional[torch.Tensor]     # (len(kernel_cols),) int32 or None
    plain_targets: Tuple[object, ...]   # AST nodes, aligned with plain_cols

    @property
    def any_kernel(self) -> bool:
        """True when at least one target runs through the kernel."""
        return bool(self.kernel_cols)


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-unfinalized chunk: device values still being
    computed on the stream, plus the slot bookkeeping needed to emit its
    partial in order."""
    seq: int
    brick_id: int
    start: int
    size: int
    owner: int
    span: object = None
    # "plan" chunks are fully evaluated at dispatch (the eval_plan_slice
    # primitive copies to the host internally); "split" chunks hold
    # kernel/plain device tensors finalized later.
    res: Optional[List[merge_lib.QueryResult]] = None
    mask_dev: object = None             # (size, K_kernel) device tensor
    var_dev: object = None              # (size,) device tensor
    plain_masks: Optional[list] = None  # (size,) tensors, plain_cols order
    ids: object = None                  # (size,) device tensor of event ids


class SpmdBackend:
    """The SPMD realization of the contract: a chunked streaming scan
    over the device-resident brick shards.

    Bricks play the role of shards (data that never moves: they live on
    the store's ``device`` and every chunk is a view of one, with no
    copy); the scan visits them in brick-id order and sweeps each in
    chunks of ``chunk_events``.  Every chunk runs the SAME
    fragment-factored evaluation primitive as the simulation
    (:func:`~repro_torch.core.jse.eval_plan_slice`), so unique fragments
    are evaluated once per chunk and a chunk's partials are bit-identical
    to the simulated backend's partials for the same slice.  Per-chunk
    :class:`~repro_torch.core.jse.PacketPartial`\\ s stream out through
    ``on_partial`` in deterministic merge order, which is what makes
    prefix snapshots (via :class:`~repro_torch.core.merge.MergeAccumulator`)
    bit-identical to ``tree_merge`` of the same prefix.

    Differences from the simulation, by design:

    - **Clock**: ``t_virtual`` on emitted partials and
      ``JobStats.makespan_s`` are seconds on the backend's injectable
      ``clock`` (wall by default) since the window started.  With
      ``mesh_devices > 1`` the stamps switch to the **lockstep mesh
      clock**: chunks are grouped ``mesh_devices`` at a time, each
      group's cost is the *maximum* of its measured sub-chunk walls (all
      shards execute a group simultaneously on a real mesh), and
      stamps/makespan accumulate those group maxima — the critical-path
      time a D-device lockstep mesh would take for the measured
      per-shard compute.  On one card the mesh is always emulated.
    - **Failures**: shards are resident compute state, not remote disks;
      ``failure_script`` is a simulated-grid concept and a non-empty one
      raises ``ValueError`` rather than being silently ignored.
    - **Kernel fusion** (``use_pallas=True``, the reference's name for
      it): every plan target — per-query roots AND materialized boolean
      fragments — that matches the fused ``event_filter`` kernel's
      conjunctive family runs in the kernel epilogue in one
      track-streaming pass per chunk (the CUDA kernel on a CUDA store,
      its plain version on a CPU store); the rest run through the plain
      fragment walk on the same resident slice and the two sub-batches
      are reassembled in slot order (:class:`PlanSplit`).
      ``autotune=True`` sweeps the kernel's launch shape (threads a
      block) once per (chunk shape x K x calib) class on a sample chunk
      of the window's first brick, caches the winner in-process
      (``repro_torch.kernels.event_filter.tune``) and launches every
      kernel chunk of the window with it; it tunes the CUDA kernel, so on
      a CPU store it raises ``ValueError`` at construction.  Per-chunk
      telemetry (``PacketTelemetry``) is
      recorded either way, so ``planner.fit_cost_weights`` calibrates
      from SPMD runs too.
    - **Double buffering** (``double_buffer=True``, the default): chunk
      ``i+1`` is launched before chunk ``i`` is finalized, so host-side
      ``MergeAccumulator`` prefix merging and partial emission overlap
      the device compute of the next chunk.  Kernel launches are
      asynchronous on the CUDA stream; the copy to the host in
      :meth:`_finalize_chunk` is the one point where the host waits.
      Merge order is unchanged (finalize strictly follows dispatch
      order).  Disabled in emulated-mesh mode, where per-sub-chunk walls
      must be measured in isolation for the lockstep clock to be honest.
    - **Adaptive chunks** (``adaptive_chunks=True``): ``chunk_events``
      becomes the :class:`ChunkController`'s initial value and
      subsequent chunks are sized from measured per-chunk walls toward
      ``chunk_target_s`` seconds each.  Off by default — fixed chunks
      are what make matched-packetization bit-identity tests possible.
    """

    def __init__(self, catalog: MetadataCatalog, store: BrickStore, *,
                 chunk_events: int = 64, packet_ramp: Optional[int] = None,
                 ramp_factor: float = 2.0, use_pallas: bool = False,
                 autotune: bool = False,
                 mesh_devices: int = 1,
                 adaptive_chunks: bool = False,
                 chunk_target_s: float = 0.02,
                 double_buffer: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 device: Union[str, torch.device] = "cuda"):
        if chunk_events <= 0:
            raise ValueError("chunk_events must be positive")
        if packet_ramp is not None and packet_ramp <= 0:
            raise ValueError("packet_ramp must be positive")
        if ramp_factor <= 1.0:
            raise ValueError("ramp_factor must be > 1")
        if mesh_devices < 1:
            raise ValueError("mesh_devices must be >= 1")
        self.device = store.check_device(device)
        if autotune and self.device.type != "cuda":
            raise ValueError(
                f"autotune=True sweeps the event_filter CUDA kernel's launch "
                f"shape; a store on {self.device} runs the kernel's plain "
                f"version, which has no launch to tune")
        self.catalog = catalog
        self.store = store
        self.chunk_events = chunk_events
        self.packet_ramp = packet_ramp
        self.ramp_factor = ramp_factor
        self.use_pallas = use_pallas
        self.autotune = autotune
        self.mesh_devices = mesh_devices
        self.adaptive_chunks = adaptive_chunks
        self.chunk_target_s = chunk_target_s
        self.double_buffer = double_buffer
        self.clock = clock
        self.cost_weights = None  # installed by the service after refits
        #: shards are resident compute state, not killable virtual nodes
        self.supports_failure_injection = False
        #: no per-node routing either — chunks visit shards in place, so
        #: policy decisions (avoid/probe/speculate) don't apply here
        self.supports_routing_policy = False
        # observability plane; None = disabled
        self.obs = None
        #: most recent autotune verdict (TunedShape) — reporting
        self.last_autotune = None

    # ------------------------------------------------------------------ #
    def _chunk_size(self, seq: int, remaining: int, ramp: Optional[int],
                    controller: Optional[ChunkController]) -> int:
        """Size of chunk ``seq``: the configured chunk (or the adaptive
        controller's proposal), capped early by the shared geometric
        stream ramp (``core/packets.py``), clipped to the shard
        remainder."""
        size = controller.chunk() if controller is not None \
            else self.chunk_events
        if ramp is not None:
            cap = ramp_cap(seq, ramp, self.ramp_factor)
            if cap < size:
                size = max(1, int(cap))
        return min(size, remaining)

    def _split_plan(self, plan: query_lib.FragmentPlan) -> PlanSplit:
        """Partition the plan's targets into the kernel sub-batch
        (targets inside the fused kernel's conjunctive family) and the
        plain sub-batch (everything else) — see :class:`PlanSplit`.  With
        ``use_pallas=False`` every target lands in the plain sub-batch."""
        targets = plan.targets()
        if not self.use_pallas:
            return PlanSplit(kernel_cols=(), plain_cols=tuple(
                range(len(targets))), thresholds=None, var_idx=None,
                plain_targets=tuple(targets))
        from repro_torch.kernels.event_filter import ops as ef_ops
        params = [ef_ops.match_epilogue(t, self.store.schema)
                  for t in targets]
        kcols = tuple(i for i, p in enumerate(params) if p is not None)
        pcols = tuple(i for i, p in enumerate(params) if p is None)
        thresholds, var_idx = (None, None)
        if kcols:
            thresholds, var_idx = ef_ops.batch_kernel_params(
                [params[i] for i in kcols], device=self.device)
        return PlanSplit(kernel_cols=kcols, plain_cols=pcols,
                         thresholds=thresholds, var_idx=var_idx,
                         plain_targets=tuple(targets[i] for i in pcols))

    def _maybe_autotune(self, split: PlanSplit, brick_id: int,
                        calib_iters: int) -> Optional[int]:
        """Resolve the kernel's block size for this window: the in-process
        autotune winner for the (chunk shape x K x calib) class when
        ``autotune=True``, the kernel's fixed default (None) otherwise."""
        if not (self.autotune and split.any_kernel):
            return None
        from repro_torch.kernels.event_filter import tune as ef_tune
        batch = self.store.bricks[brick_id]
        n = min(self.chunk_events, batch["scalars"].shape[0])
        tuned = ef_tune.autotune_block_shapes(
            batch["scalars"][:n], batch["tracks"][:n],
            batch["n_tracks"][:n], split.thresholds, split.var_idx,
            calib_iters=calib_iters)
        self.last_autotune = tuned
        if self.obs is not None:
            self.obs.metrics.gauge("spmd.autotune.threads").set(
                tuned.threads)
        return tuned.threads

    # ------------------------------------------------------------------ #
    def _dispatch_chunk(self, plan: query_lib.FragmentPlan,
                        split: PlanSplit, seq: int, brick_id: int,
                        start: int, size: int, owner: int,
                        calib_iters: int,
                        threads: Optional[int] = None) -> _Inflight:
        """Dispatch one chunk: kernel sub-batch + plain sub-batch launched
        on the device stream (nothing waits here), or — for windows with
        no kernel targets — the shared ``eval_plan_slice`` primitive
        evaluated in place.  The chunk's tensors are views of the
        device-resident brick; nothing is copied to the device.  The
        kernel launches with ``threads`` a block (None: its default)."""
        infl = _Inflight(seq=seq, brick_id=brick_id, start=start,
                         size=size, owner=owner)
        if not split.any_kernel:
            infl.res = eval_plan_slice(self.store, plan, brick_id, start,
                                       size, calib_iters)
            return infl
        from repro_torch.kernels.event_filter import ops as ef_ops
        batch = self.store.bricks[brick_id]
        sl = {k: v[start:start + size] for k, v in batch.items()}
        infl.ids = sl["event_id"]
        infl.mask_dev, infl.var_dev = ef_ops.event_filter_batch(
            sl["scalars"], sl["tracks"], sl["n_tracks"], split.thresholds,
            split.var_idx, calib_iters=calib_iters, threads=threads)
        if split.plain_cols:
            # out-of-family targets: the same shared-memo fragment walk
            # the plan runs, restricted to the plain sub-batch (values
            # are memo-independent, so restricting the memo cannot change
            # bits — only sharing)
            if calib_iters:
                sl = dict(sl, tracks=query_lib.calibrate(sl, calib_iters))
            memo: Optional[dict] = {} if plan.shared else None
            infl.plain_masks = [
                query_lib.eval_node(t, sl, self.store.schema, False, memo)
                for t in split.plain_targets]
        return infl

    def _finalize_chunk(self, infl: _Inflight,
                        split: PlanSplit) -> List[merge_lib.QueryResult]:
        """Bring one dispatched chunk to the host (the scan's sync point)
        and reassemble its partials in the plan's slot order (kernel and
        plain sub-batches interleaved back to their original slots)."""
        if infl.res is not None:
            return infl.res
        mask = infl.mask_dev.cpu().numpy()   # (size, K_kernel)
        var = infl.var_dev.cpu().numpy()
        ids = infl.ids.cpu().numpy()
        n_targets = len(split.kernel_cols) + len(split.plain_cols)
        out: List[Optional[merge_lib.QueryResult]] = [None] * n_targets
        for j, col in enumerate(split.kernel_cols):
            out[col] = merge_lib.from_mask(mask[:, j], var, ids)
        if infl.plain_masks is not None:
            for j, col in enumerate(split.plain_cols):
                out[col] = merge_lib.from_mask(
                    infl.plain_masks[j].cpu().numpy(), var, ids)
        infl.res = out
        return out

    # ------------------------------------------------------------------ #
    def run_batch(self, job_ids: List[int], *,
                  plan: Optional[query_lib.FragmentPlan] = None,
                  on_partial: Optional[
                      Callable[[PacketPartial], None]] = None,
                  failure_script: Optional[Dict[float, int]] = None,
                  packet_ramp: Optional[int] = None
                  ) -> Tuple[List[merge_lib.QueryResult], JobStats]:
        """Execute the window as a chunked streaming scan over the brick
        shards (see the class docstring and
        :meth:`ExecutionBackend.run_batch` for the contract)."""
        if failure_script:
            raise ValueError(
                "failure_script is a simulated-grid concept; the SPMD "
                "backend has no virtual nodes to kill (use "
                "SimulatedBackend for failure experiments)")
        rec, plan = prepare_window(self.catalog, job_ids, plan)

        obs = self.obs
        clock = self.clock
        stats = JobStats(n_queries=len(job_ids))
        plan_aggs = query_lib.unique_aggregates(plan.targets())
        split = self._split_plan(plan)
        ramp = packet_ramp if packet_ramp is not None else self.packet_ramp
        controller = (ChunkController(initial=self.chunk_events,
                                      target_s=self.chunk_target_s)
                      if self.adaptive_chunks else None)
        bricks = sorted(rec.bricks)
        threads = (self._maybe_autotune(split, bricks[0], rec.calib_iters)
                   if bricks else None)
        mesh = max(1, self.mesh_devices)
        # one card: a mesh of more than one device is always emulated
        lockstep = mesh > 1
        # double buffering applies only where dispatch is actually lazy
        # (kernel sub-batches): a plain-path chunk evaluates eagerly at
        # dispatch, so holding it back would just delay its partial by a
        # whole chunk; and lockstep emulation needs isolated walls
        buffered = self.double_buffer and split.any_kernel and not lockstep

        if obs is not None:
            obs.metrics.gauge("spmd.mesh_devices").set(mesh)

        results: List[List[merge_lib.QueryResult]] = []
        t_start = clock()
        t_lockstep = 0.0    # critical-path seconds (emulated mesh clock)
        t_prev = t_start    # previous finalize completion (chunk walls)
        group_walls: List[float] = []

        def stamp() -> float:
            return t_lockstep if lockstep else clock() - t_start

        def emit(infl: _Inflight, wall: float) -> None:
            """Record one finalized chunk: telemetry, obs, stats, and the
            in-order partial emission."""
            res = infl.res
            stats.packet_telemetry.append(PacketTelemetry(
                size=infl.size, calib_iters=rec.calib_iters,
                n_aggregates=plan_aggs, wall_s=wall,
                n_targets=len(plan.targets()), node=infl.owner))
            if obs is not None:
                if infl.span is not None:
                    obs.tracer.end(
                        infl.span,
                        t_virtual=obs.tracer.virtual_base + stamp())
                obs.metrics.counter("packet.count").inc()
                obs.metrics.histogram("packet.latency_s").observe(wall)
                obs.metrics.histogram("packet.events").observe(infl.size)
                obs.metrics.gauge("spmd.chunk_events").set(infl.size)
                if split.any_kernel:
                    obs.metrics.counter("spmd.kernel_events").inc(
                        infl.size)
                obs.health.observe_packet(infl.owner, infl.size, wall)
            results.append(res)
            stats.events_scanned += infl.size
            if split.any_kernel:
                stats.kernel_events += infl.size
            stats.fragment_evals += plan.evals_per_batch
            stats.fragment_evals_unshared += plan.unshared_evals
            stats.packets += 1
            stats.per_node_busy[infl.owner] = \
                stats.per_node_busy.get(infl.owner, 0.0) + wall
            if controller is not None:
                controller.observe(infl.size, wall)
            if on_partial is not None:
                on_partial(PacketPartial(
                    seq=infl.seq, brick_id=infl.brick_id, start=infl.start,
                    size=infl.size, node=infl.owner, t_virtual=stamp(),
                    failures=0, partials=res))

        pending: Optional[_Inflight] = None

        def finalize(infl: _Inflight) -> None:
            nonlocal t_prev
            self._finalize_chunk(infl, split)
            now = clock()
            emit(infl, max(now - t_prev, 1e-9))
            t_prev = now

        seq = 0
        for bid in bricks:
            n = self.store.specs[bid].n_events
            owner = self.store.specs[bid].node
            start = 0
            while start < n:
                if lockstep:
                    # one lockstep group: up to `mesh` sub-chunks of this
                    # brick, each measured in isolation; the group costs
                    # the MAX of its walls on the mesh clock
                    group: List[_Inflight] = []
                    group_walls.clear()
                    while len(group) < mesh and start < n:
                        size = self._chunk_size(seq, n - start, ramp,
                                                controller)
                        t0 = clock()
                        infl = self._dispatch_chunk(
                            plan, split, seq, bid, start, size, owner,
                            rec.calib_iters, threads)
                        self._finalize_chunk(infl, split)
                        group_walls.append(max(clock() - t0, 1e-9))
                        group.append(infl)
                        seq += 1
                        start += size
                    t_lockstep += max(group_walls)
                    for infl, wall in zip(group, group_walls):
                        emit(infl, wall)
                    continue
                size = self._chunk_size(seq, n - start, ramp, controller)
                span = None
                if obs is not None:
                    span = obs.tracer.begin(
                        "packet",
                        t_virtual=obs.tracer.virtual_base + stamp(),
                        seq=seq, brick=bid, start=start, size=size,
                        node=owner)
                infl = self._dispatch_chunk(plan, split, seq, bid, start,
                                            size, owner, rec.calib_iters,
                                            threads)
                infl.span = span
                if not buffered:
                    finalize(infl)
                else:
                    if pending is not None:
                        # chunk i finalizes (host merge + stream emit)
                        # while chunk i+1's device compute is in flight
                        finalize(pending)
                    pending = infl
                seq += 1
                start += size
        if pending is not None:
            finalize(pending)

        k = len(job_ids)
        merged = (merge_lib.merge_batch(results) if results
                  else [merge_lib.QueryResult()
                        for _ in range(len(plan.targets()))])
        stats.fragment_results = dict(
            zip(plan.materialize_keys(), merged[k:]))
        merged = merged[:k]
        stats.makespan_s = t_lockstep if lockstep \
            else clock() - t_start

        end = time.time()
        for jid, m in zip(job_ids, merged):
            self.catalog.update(
                jid, status=DONE, end_time=end,
                events_processed=m.n_processed, failures=0,
                result={
                    "n_selected": m.n_selected,
                    "n_processed": m.n_processed,
                    "sum_var": m.sum_var,
                    "makespan_s": stats.makespan_s,
                })
        return merged, stats


BACKENDS = ("sim", "spmd")


def make_backend(kind: str, catalog: MetadataCatalog, store: BrickStore,
                 **kwargs) -> ExecutionBackend:
    """Build an execution backend by name over a catalogue/store pair.

    ``kind`` is ``"sim"`` (:class:`SimulatedBackend`) or ``"spmd"``
    (:class:`SpmdBackend`); ``kwargs`` pass through to the chosen
    backend's constructor — unknown names raise ``ValueError`` so a
    mistyped ``--backend`` fails at construction, not mid-window."""
    if kind == "sim":
        return SimulatedBackend(catalog, store, **kwargs)
    if kind == "spmd":
        return SpmdBackend(catalog, store, **kwargs)
    raise ValueError(f"unknown backend {kind!r} (choose from {BACKENDS})")
