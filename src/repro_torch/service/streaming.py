"""Streaming partial-merge result delivery: progressive histograms while
the grid job runs.

The batch service resolves a ticket only when its dispatch window
finishes.  DIAL-style interactive analysis wants the opposite UX: a
histogram that fills in as bricks report, with the *guarantee* that the
final picture is exactly the batch answer.  This module is that delivery
layer:

- :class:`StreamSnapshot` — one progressive result: an **exact**
  :class:`~repro_torch.core.merge.QueryResult` over the prefix of packets merged
  so far, plus :class:`~repro_torch.core.merge.Coverage` confidence metadata and
  the virtual grid time it became available.
- :class:`ResultStream` — the per-ticket subscription a tenant reads:
  bounded buffer, conflating backpressure (a slow reader loses
  intermediate granularity, never the final), ``latest()``
  snapshot-at-any-time, and a push ``subscribe`` hook.
- :class:`WindowStreamPublisher` — the producer side the front-end plugs
  into the JSE's ``on_partial`` hook: one
  :class:`~repro_torch.core.merge.MergeAccumulator` per streamed query column of
  the shared scan, fanning each packet's prefix snapshot out to every
  subscribed ticket.

Consistency model (``docs/streaming.md`` has the full argument): partials
are published in merge order, the accumulator's prefix snapshots are
bit-identical to ``tree_merge`` of the same prefix, and therefore the
final snapshot of a DONE job is bit-identical to the batch path's result —
including under node-failure scripts and fragment-factored plans.  A
truncated (FAILED) scan aborts the stream without ever publishing a final
snapshot, mirroring the batch rule that a truncated partial is never
surfaced or cached.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

from repro_torch.core import merge as merge_lib
from repro_torch.core.jse import PacketPartial

OPEN, DONE, ABORTED = "OPEN", "DONE", "ABORTED"


@dataclasses.dataclass(frozen=True)
class StreamSnapshot:
    """One progressive result published on a :class:`ResultStream`.

    ``result`` is the exact merged answer over the first ``seq + 1``
    packets of the scan (not an estimate — see
    :class:`~repro_torch.core.merge.MergeAccumulator`), ``coverage`` says how
    much of the job that prefix represents, and ``t_virtual`` is when the
    snapshot became available on the simulated grid clock (``final``
    snapshots carry the job makespan).  ``final`` marks the last snapshot
    of a DONE job: bit-identical to the batch ``tree_merge`` result."""
    seq: int
    result: merge_lib.QueryResult
    coverage: merge_lib.Coverage
    t_virtual: float
    final: bool = False


class ResultStream:
    """Per-ticket stream of progressive snapshots (the tenant-facing end).

    Producer side (the service): :meth:`publish` intermediate snapshots,
    then exactly one of :meth:`finish` (job DONE, final snapshot) or
    :meth:`abort` (rejected / cache-miss failure / truncated scan).

    Consumer side (the tenant): :meth:`poll` drains buffered snapshots in
    order, :meth:`latest` peeks at the newest one without consuming
    (snapshot-at-any-time), iteration drains the currently buffered
    snapshots (use :meth:`subscribe` — a push callback invoked on every
    publish — for live consumption while the scan loop is still
    running).

    Backpressure is *conflating*: the buffer holds at most ``capacity``
    snapshots and a publish into a full buffer drops the **oldest**
    buffered one (count in :attr:`dropped`).  Progressive results are
    cumulative states, not deltas, so a lagging reader skips intermediate
    granularity but never loses information — and the final snapshot is
    never dropped.  The producer never blocks the scan."""

    def __init__(self, ticket_id: int, *, capacity: int = 32):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.ticket_id = ticket_id
        self.capacity = capacity
        self.state = OPEN
        self.note = ""
        self.published = 0   # snapshots ever published
        self.dropped = 0     # snapshots conflated away by backpressure
        self._buf: Deque[StreamSnapshot] = deque()
        self._latest: Optional[StreamSnapshot] = None
        self._listeners: List[Callable[[StreamSnapshot], None]] = []
        self._close_listeners: List[Callable[["ResultStream"], None]] = []

    # ---------------------------- producer ---------------------------- #
    def publish(self, snap: StreamSnapshot) -> None:
        """Deliver one snapshot (service-internal; no-op after close)."""
        if self.state != OPEN:
            return
        if len(self._buf) >= self.capacity:
            self._buf.popleft()
            self.dropped += 1
        self._buf.append(snap)
        self._latest = snap
        self.published += 1
        for fn in self._listeners:
            fn(snap)

    def finish(self, snap: StreamSnapshot) -> None:
        """Publish the final snapshot and close the stream as DONE
        (no-op on an already-closed stream: an ABORTED stream must never
        resurrect as done without a final snapshot)."""
        if self.state != OPEN:
            return
        self.publish(snap)
        self.state = DONE
        for fn in self._close_listeners:
            fn(self)

    def abort(self, note: str) -> None:
        """Close the stream without a final snapshot (the reason lands in
        :attr:`note`); already-published prefixes stay readable."""
        if self.state == OPEN:
            self.state = ABORTED
            self.note = note
            for fn in self._close_listeners:
                fn(self)

    # ---------------------------- consumer ---------------------------- #
    @property
    def closed(self) -> bool:
        """True once the stream is DONE or ABORTED (no more publishes)."""
        return self.state != OPEN

    @property
    def done(self) -> bool:
        """True when the job finished and the final snapshot was published."""
        return self.state == DONE

    def latest(self) -> Optional[StreamSnapshot]:
        """Newest snapshot ever published, without consuming the buffer —
        the snapshot-at-any-time read (None before the first partial)."""
        return self._latest

    def poll(self) -> Optional[StreamSnapshot]:
        """Consume and return the oldest buffered snapshot (None if the
        buffer is currently empty)."""
        return self._buf.popleft() if self._buf else None

    def subscribe(self, fn: Callable[[StreamSnapshot], None]) -> None:
        """Register a push callback invoked on every future publish (runs
        synchronously inside the scan loop — keep it cheap)."""
        self._listeners.append(fn)

    def on_close(self, fn: Callable[["ResultStream"], None]) -> None:
        """Register a callback invoked once when the stream closes (both
        DONE and ABORTED) — the fabric's fan-out layer forwards closure
        to remote readers through this hook.  If the stream is already
        closed the callback fires immediately."""
        if self.closed:
            fn(self)
            return
        self._close_listeners.append(fn)

    def buffered(self) -> List[StreamSnapshot]:
        """The currently buffered snapshots, oldest first, WITHOUT
        consuming them — what a late reader attaching now would drain
        (the fan-out layer replays this prefix to remote subscribers)."""
        return list(self._buf)

    def __len__(self) -> int:
        """Snapshots currently buffered (≤ ``capacity``)."""
        return len(self._buf)

    def __iter__(self):
        """Drain buffered snapshots in order; stops when the buffer is
        empty (on a closed stream that means the stream is exhausted)."""
        while self._buf:
            yield self._buf.popleft()


class WindowStreamPublisher:
    """Fans one shared-scan window's per-packet partials out to per-ticket
    streams, maintaining one prefix-merge accumulator per streamed column.

    ``column_streams[k]`` holds the :class:`ResultStream` subscribers of
    the window's *k*-th query column (deduplicated canonical query);
    columns nobody subscribed to cost nothing.  Plug :meth:`on_partial`
    into ``run_job_batch_simulated(on_partial=...)``, then call
    :meth:`finish` with the batch-merged results (DONE) or :meth:`abort`
    (FAILED) — the final snapshot reuses the batch result object itself,
    which the accumulator's prefix property guarantees is the value every
    intermediate prefix was converging to."""

    def __init__(self, column_streams: Sequence[Sequence[ResultStream]], *,
                 events_total: Optional[int] = None,
                 bricks_total: Optional[int] = None, obs=None):
        self.column_streams = [list(streams) for streams in column_streams]
        self._accs: List[Optional[merge_lib.MergeAccumulator]] = [
            merge_lib.MergeAccumulator(events_total=events_total,
                                       bricks_total=bricks_total)
            if streams else None
            for streams in self.column_streams]
        self._failures = 0
        self._t = 0.0  # prefix availability clock (see on_partial)
        # observability plane (repro_torch.obs.Observability); None = disabled
        self.obs = obs

    @property
    def active(self) -> bool:
        """True when at least one column has a subscriber."""
        return any(acc is not None for acc in self._accs)

    def on_partial(self, pp: PacketPartial) -> None:
        """JSE hook: fold packet ``pp`` into every subscribed column's
        accumulator and publish the new prefix snapshots.

        Snapshots are stamped with the *prefix availability time* — the
        running max of packet completion times — because a prefix merge
        exists only once every packet in it has finished; raw completion
        times interleave non-monotonically across nodes."""
        new_failures = pp.failures - self._failures
        self._failures = pp.failures
        self._t = max(self._t, pp.t_virtual)
        obs = self.obs
        if obs is not None:
            obs.tracer.event(
                "merge_prefix",
                t_virtual=obs.tracer.virtual_base + self._t,
                seq=pp.seq, brick=pp.brick_id)
        for col, acc in enumerate(self._accs):
            if acc is None:
                continue
            if new_failures:
                acc.note_failure(new_failures)
            acc.add(pp.partials[col], brick_id=pp.brick_id)
            snap = StreamSnapshot(seq=pp.seq, result=acc.snapshot(),
                                  coverage=acc.coverage(),
                                  t_virtual=self._t)
            if obs is None:
                for stream in self.column_streams[col]:
                    stream.publish(snap)
            else:
                for stream in self.column_streams[col]:
                    d0 = stream.dropped
                    stream.publish(snap)
                    obs.metrics.counter("stream.published").inc()
                    if stream.dropped > d0:
                        # backpressure conflated an older snapshot away
                        obs.metrics.counter("stream.conflated").inc(
                            stream.dropped - d0)
                    # lease-export streams carry their string lease key
                    # as ticket_id; the span schema types ticket as
                    # int|str|None, so the key is stamped directly
                    obs.tracer.event(
                        "stream_partial",
                        t_virtual=obs.tracer.virtual_base + self._t,
                        ticket=stream.ticket_id,
                        seq=pp.seq, col=col)

    def finish(self, merged: Sequence[merge_lib.QueryResult],
               makespan_s: float) -> None:
        """Publish each column's final snapshot (the batch-merged result)
        and close its streams as DONE."""
        obs = self.obs
        for col, acc in enumerate(self._accs):
            if acc is None:
                continue
            snap = StreamSnapshot(
                seq=acc.n_partials - 1, result=merged[col],
                coverage=acc.coverage(), t_virtual=makespan_s, final=True)
            for stream in self.column_streams[col]:
                stream.finish(snap)
                if obs is not None:
                    obs.metrics.counter("stream.finished").inc()

    def abort(self, note: str) -> None:
        """Close every subscribed stream without a final snapshot (the
        truncated-scan rule: a partial is never surfaced as an answer)."""
        obs = self.obs
        for streams in self.column_streams:
            for stream in streams:
                was_open = stream.state == OPEN
                stream.abort(note)
                if obs is not None and was_open:
                    obs.metrics.counter("stream.aborted").inc()
