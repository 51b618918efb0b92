"""Result merging — "the final result is merged from the various results
coming from the different Grid nodes" (paper section 4.2).

A query result is a small, associative-mergeable summary: selected-event
count, sum/histogram of a physics variable, and a bounded set of selected
event ids.  Associativity is what lets the merge run as a tree: per-brick
-> per-node -> per-pod -> JSE, and as plain psums in the SPMD realization.

Two merge schedules share the same ``merge2`` kernel:

- :func:`tree_merge` — the batch JSE schedule: all partials collected,
  pairwise reduction at job end (what the paper's "retrieves the results,
  merging them together" does).
- :class:`MergeAccumulator` — the *streaming* schedule: partials are folded
  in as they arrive, and :meth:`~MergeAccumulator.snapshot` at any moment
  is **bit-identical** to ``tree_merge`` of the partials seen so far.  The
  accumulator is what lets the service ship progressive histograms while
  the grid job is still running without giving up the batch path's exact
  result (see ``docs/streaming.md`` for the equivalence argument).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

HIST_BINS = 64
HIST_RANGE = (0.0, 512.0)
MAX_IDS = 128


@dataclasses.dataclass
class QueryResult:
    """One (partial or merged) query summary.

    The paper's per-node "result file": selected/processed event counts, the
    sum and a fixed-range histogram of the summary variable (``e_total``),
    and a bounded sample of selected event ids.  Every field merges
    associatively (``merge2``), which is what makes the JSE merge schedule
    — tree, streaming prefix, or SPMD psum — a free choice."""
    n_selected: int = 0
    n_processed: int = 0
    sum_var: float = 0.0
    hist: Optional[np.ndarray] = None          # (HIST_BINS,) counts
    selected_ids: Optional[np.ndarray] = None  # bounded id sample

    def __post_init__(self):
        if self.hist is None:
            self.hist = np.zeros(HIST_BINS, np.int64)
        if self.selected_ids is None:
            self.selected_ids = np.zeros(0, np.int64)

    def to_dict(self) -> dict:
        """JSON-serializable form of the result (``hist`` and
        ``selected_ids`` as plain int lists) — what the fleet's L2 cache
        tier persists across restarts.  Round-trips exactly through
        :meth:`from_dict` (``results_identical`` holds): counts and
        histogram bins are integers, ids are integers, and the float
        ``sum_var`` survives JSON bit-for-bit (repr round-trip)."""
        return {
            "n_selected": int(self.n_selected),
            "n_processed": int(self.n_processed),
            "sum_var": float(self.sum_var),
            "hist": [int(x) for x in self.hist],
            "selected_ids": [int(x) for x in self.selected_ids],
        }

    @classmethod
    def from_dict(cls, data: dict) -> "QueryResult":
        """Rebuild a result from :meth:`to_dict` output."""
        return cls(
            n_selected=int(data["n_selected"]),
            n_processed=int(data["n_processed"]),
            sum_var=float(data["sum_var"]),
            hist=np.asarray(data["hist"], np.int64),
            selected_ids=np.asarray(data["selected_ids"], np.int64),
        )


def from_mask(mask: np.ndarray, var: np.ndarray,
              event_id: np.ndarray) -> QueryResult:
    """Summarize one evaluated packet: selection mask -> QueryResult.

    This is the leaf of every merge tree — a grid node calls it on each
    packet's predicate output before shipping the partial to the JSE."""
    sel = mask != 0
    vals = var[sel]
    hist, _ = np.histogram(vals, bins=HIST_BINS, range=HIST_RANGE)
    ids = event_id[sel][:MAX_IDS]
    return QueryResult(
        n_selected=int(sel.sum()), n_processed=int(mask.shape[0]),
        sum_var=float(vals.sum()), hist=hist.astype(np.int64),
        selected_ids=ids.astype(np.int64))


def merge2(a: QueryResult, b: QueryResult) -> QueryResult:
    """Merge two partials (``a`` earlier than ``b`` in packet order).

    Counts and histograms add exactly; ``selected_ids`` concatenates in
    order and keeps the first ``MAX_IDS`` — a prefix-stable truncation, so
    any merge schedule that preserves packet order keeps the same sample."""
    return QueryResult(
        n_selected=a.n_selected + b.n_selected,
        n_processed=a.n_processed + b.n_processed,
        sum_var=a.sum_var + b.sum_var,
        hist=a.hist + b.hist,
        selected_ids=np.concatenate([a.selected_ids, b.selected_ids])[:MAX_IDS],
    )


def results_identical(a: QueryResult, b: QueryResult) -> bool:
    """Field-by-field *bit* equality of two results — the predicate behind
    every merge-schedule-equivalence guarantee (shared scans, fragment
    plans, streamed prefixes).  Float ``sum_var`` is compared exactly, not
    approximately: equivalent schedules reproduce the same merge DAG, so
    they must agree to the last bit."""
    return (a.n_selected == b.n_selected
            and a.n_processed == b.n_processed
            and a.sum_var == b.sum_var
            and np.array_equal(a.hist, b.hist)
            and np.array_equal(a.selected_ids, b.selected_ids))


def merge_batch(parts: Sequence[Sequence[QueryResult]]) -> List[QueryResult]:
    """Batched JSE merge for a shared scan: ``parts[i][k]`` is packet *i*'s
    partial for query *k*.  Each query's partials arrive in the same packet
    order, so merging column *k* with ``tree_merge`` is bit-identical to
    the merge an independent single-query job would have produced."""
    if not parts:
        return []
    k = len(parts[0])
    if any(len(p) != k for p in parts):
        raise ValueError("ragged batch partials")
    return [tree_merge([p[q] for p in parts]) for q in range(k)]


def tree_merge(results: Sequence[QueryResult],
               merge_fn: Callable = merge2) -> QueryResult:
    """Pairwise tree reduction (the JSE merge schedule).

    Level-by-level: adjacent pairs merge, an odd leftover is carried to the
    next level at the end.  The resulting reduction tree groups the leaves
    by the greedy binary decomposition of ``len(results)`` — the same tree
    :class:`MergeAccumulator` maintains incrementally, which is why a
    streamed prefix snapshot finalizes to this function's output bit for
    bit (``tests/test_streaming.py`` pins the property).

    ``merge_fn`` generalizes the reduction to any associative pairwise
    combiner over any element type (the observability plane reduces
    fleet metrics snapshots through this exact schedule); it defaults to
    :func:`merge2` over :class:`QueryResult`.  An empty input returns an
    empty ``QueryResult`` — only meaningful under the default combiner,
    so callers with a custom ``merge_fn`` must pass a non-empty
    sequence."""
    if not results:
        return QueryResult()
    level: List[QueryResult] = list(results)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(merge_fn(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


# --------------------------------------------------------------------------- #
# Streaming prefix merge
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Coverage:
    """How much of the job a streamed snapshot has seen — the confidence
    metadata shipped next to every progressive result.

    A streamed snapshot is not an *estimate* of the final answer: it is the
    **exact** answer over the ``events_scanned`` events merged so far.
    Coverage tells the tenant how far along the scan is and whether the
    prefix is currently running behind due to failures:

    - ``events_scanned`` / ``events_total``: events merged so far vs. the
      job's full store (``events_total`` is ``None`` when unknown).
    - ``bricks_seen`` / ``bricks_total``: bricks that have contributed at
      least one packet.  A brick in ``bricks_seen`` is not necessarily
      finished — packets from one brick interleave across nodes.
    - ``packets``: partials merged (the prefix length).
    - ``failures``: node deaths observed so far.  A death re-queues the
      dead node's outstanding packets on surviving replicas, so a non-zero
      count means parts of the store are *holes* in the current prefix
      that a later snapshot will back-fill; the holes close by job end
      unless the whole scan aborts (in which case no final snapshot is
      ever published — see ``service/streaming.py``)."""
    events_scanned: int = 0
    events_total: Optional[int] = None
    bricks_seen: Tuple[int, ...] = ()
    bricks_total: Optional[int] = None
    packets: int = 0
    failures: int = 0

    @property
    def fraction(self) -> Optional[float]:
        """Scanned fraction in [0, 1], or None when the total is unknown."""
        if not self.events_total:
            return None
        return min(1.0, self.events_scanned / self.events_total)

    @property
    def complete(self) -> bool:
        """True when every event of a known-size store has been merged."""
        return (self.events_total is not None
                and self.events_scanned >= self.events_total)


class MergeAccumulator:
    """Incremental prefix merge with ``tree_merge``-exact snapshots.

    The streaming counterpart of :func:`tree_merge`: feed partials with
    :meth:`add` in packet-completion order and read :meth:`snapshot` at any
    time.  After ``k`` partials the snapshot is **bit-identical** to
    ``tree_merge(partials[:k])`` — including the float ``sum_var`` and the
    truncated id sample — so the service can publish progressive results
    mid-job and still guarantee the final one matches the batch JSE merge.

    How: a binary-counter forest (one pending subtree per set bit of the
    prefix length, like the classic streaming merge).  Adding partial
    ``k`` performs exactly the carry merges ``tree_merge`` would, and the
    forest's subtrees are the greedy binary decomposition of ``k`` — the
    same grouping ``tree_merge`` produces level by level.  A snapshot folds
    the forest right-associatively (smallest subtree innermost), which is
    the order the leftover-carry rule imposes, so the whole merge2 DAG
    matches and float sums see the same operand order.  Snapshots cost
    O(log k) merges and never mutate the forest.

    The accumulator also tracks :class:`Coverage`: pass the job's totals at
    construction and a ``brick_id`` per partial to get scanned-fraction /
    bricks-seen / failure-hole metadata alongside each snapshot."""

    def __init__(self, *, events_total: Optional[int] = None,
                 bricks_total: Optional[int] = None):
        # forest of (level, subtree), highest level (earliest leaves) first
        self._forest: List[Tuple[int, QueryResult]] = []
        self._n = 0
        self._events = 0
        self._bricks: set = set()
        self._failures = 0
        self.events_total = events_total
        self.bricks_total = bricks_total

    @property
    def n_partials(self) -> int:
        """Partials merged so far (the current prefix length)."""
        return self._n

    def add(self, partial: QueryResult, *,
            brick_id: Optional[int] = None) -> None:
        """Fold in the next partial (must be fed in packet-merge order).

        Performs the binary-counter carries: while the two newest subtrees
        cover equally many partials they merge (earlier operand on the
        left), exactly the pairings ``tree_merge`` makes."""
        self._n += 1
        self._events += partial.n_processed
        if brick_id is not None:
            self._bricks.add(int(brick_id))
        lvl, node = 0, partial
        while self._forest and self._forest[-1][0] == lvl:
            _, left = self._forest.pop()
            node = merge2(left, node)
            lvl += 1
        self._forest.append((lvl, node))

    def note_failure(self, n: int = 1) -> None:
        """Record ``n`` node deaths so coverage can flag re-queue holes."""
        self._failures += n

    def snapshot(self) -> QueryResult:
        """Exact merged result of the prefix seen so far.

        Bit-identical to ``tree_merge`` of the partials added so far; an
        empty accumulator snapshots to the empty :class:`QueryResult`."""
        if not self._forest:
            return QueryResult()
        acc = self._forest[-1][1]
        for _, tree in reversed(self._forest[:-1]):
            acc = merge2(tree, acc)
        return acc

    def coverage(self) -> Coverage:
        """Current :class:`Coverage` metadata (see its docstring)."""
        return Coverage(
            events_scanned=self._events,
            events_total=self.events_total,
            bricks_seen=tuple(sorted(self._bricks)),
            bricks_total=self.bricks_total,
            packets=self._n,
            failures=self._failures,
        )
