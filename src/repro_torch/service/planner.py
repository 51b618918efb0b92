"""Shared-aggregate query planner: the layer between the scheduler's
dispatch window and shared-scan execution.

Window coalescing dedups *identical* canonical queries; interactive HEP
analysis traffic (the DIAL regime) is dominated by *near*-duplicates —
the same expensive track aggregates under different outer scalar filters.
The planner closes that gap with three mechanisms:

1. **Common-subexpression factoring** — every subexpression of every
   pending query is canonicalized and hash-consed
   (:func:`repro_torch.core.query.build_fragment_plan`); the resulting
   :class:`~repro_torch.core.query.FragmentPlan` evaluates each unique fragment
   once per resident packet and reassembles per-query predicates from
   fragment outputs.  Per-query results stay bit-identical to unshared
   execution (same ops on same inputs, just computed once).

2. **Materialization policy** — shared boolean fragments (referenced by
   two or more queries in the window, e.g. a common ``count(pt > 30) >= 2``
   conjunct) are surfaced as first-class merged results so the service can
   install them in the result cache; a later query equal to such a
   fragment is answered with zero brick I/O.

3. **Cost model** — :func:`estimate_cost` scores a query as
   ``events x calibration work x per-event expression work`` (aggregates
   weighted by the track sweep they imply).  The scheduler uses it for
   per-tenant cost budgets; :func:`window_cost` totals a window.

The adaptive dispatch-window controller lives in
:class:`repro_torch.service.frontend.WindowController` (it needs arrival/latency
telemetry only the front-end sees).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import query as query_lib

# ---------------------------- cost model --------------------------------- #
# Cost units are "per-event evaluation units": a pure scalar expression
# costs ~1 per event; every track aggregate adds a sweep over the padded
# tracks axis (AGG_WEIGHT events-equivalents); each calibration iteration
# multiplies the per-event work (the paper's compute-heavy refinement).
# These module constants are the COLD-START PRIOR: `fit_cost_weights`
# replaces them with values regressed from measured per-packet compute
# once the service has telemetry.
AGG_WEIGHT = 4.0
CALIB_WEIGHT = 1.0


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """One set of cost-model coefficients: the aggregate and calibration
    weights of :func:`estimate_cost`, plus the fitted per-event scale
    (seconds per event for a scalar, uncalibrated query — informational;
    admission budgets only need relative ranking).  ``fitted`` records
    whether the values came from telemetry or are the static prior."""
    agg_weight: float = AGG_WEIGHT
    calib_weight: float = CALIB_WEIGHT
    scale: float = 1.0
    fitted: bool = False


def fit_cost_weights(telemetry: Iterable, *,
                     prior: Optional[CostWeights] = None) -> CostWeights:
    """Least-squares fit of the cost-model weights from measured
    per-packet compute (ROADMAP: "Cost-model calibration").

    ``telemetry`` is an iterable of
    :class:`~repro_torch.core.jse.PacketTelemetry` (or of
    :class:`~repro_torch.core.jse.JobStats`, whose ``packet_telemetry`` lists
    are flattened).  A packet measurement covers the WHOLE window plan —
    ``wall_s`` evaluates every target and ``n_aggregates`` counts the
    plan's unique aggregates — so observations are first normalized per
    target (rate ``t/(size*targets)``, aggregate depth
    ``aggs/targets``); otherwise window width would be an omitted
    variable correlated with both and the fitted weights would be
    mis-scaled for single-query costing.  Fragment sharing makes the
    per-target attribution approximate, which is fine: admission only
    needs the weights to *rank* queries.  The normalized cost model is
    multiplicative::

        t / (size*targets) = k * (1 + c*calib) * (1 + a*aggs/targets)
                           = k + k*c*calib + k*a*A + k*c*a*(calib*A)

    (``A = aggs/targets``) which is LINEAR in the monomial basis
    ``[1, calib, A, calib*A]`` — so one ``lstsq`` solve recovers
    ``b0..b3`` and the weights follow as ``c = b1/b0``, ``a = b2/b0``.
    Degenerate designs fall back to the prior *per weight*: with no
    variation in observed ``calib`` there is nothing to identify ``c``
    from (ditto ``A`` and ``a``), and a non-positive base rate ``b0``
    rejects the whole fit.  The static module constants remain the
    cold-start prior."""
    prior = prior or CostWeights()
    obs = []
    for item in telemetry:
        rows = getattr(item, "packet_telemetry", None)
        obs.extend(rows if rows is not None else [item])
    obs = [o for o in obs if o.size > 0 and o.wall_s > 0]
    if len(obs) < 4:
        return prior
    targets = np.array([max(1, getattr(o, "n_targets", 1)) for o in obs],
                       np.float64)
    calib = np.array([o.calib_iters for o in obs], np.float64)
    aggs = np.array([o.n_aggregates for o in obs], np.float64) / targets
    rate = np.array([o.wall_s / o.size for o in obs], np.float64) / targets
    design = np.stack([np.ones_like(calib), calib, aggs, calib * aggs],
                      axis=1)
    coef, *_ = np.linalg.lstsq(design, rate, rcond=None)
    b0 = float(coef[0])
    if b0 <= 0:
        return prior
    calib_w = prior.calib_weight
    agg_w = prior.agg_weight
    if len(set(calib.tolist())) >= 2:
        calib_w = max(0.0, float(coef[1]) / b0)
    if len(set(aggs.tolist())) >= 2:
        agg_w = max(0.0, float(coef[2]) / b0)
    return CostWeights(agg_weight=agg_w, calib_weight=calib_w, scale=b0,
                       fitted=True)


def count_aggregates(node: query_lib.Node) -> int:
    """Number of track-aggregate occurrences in a query AST."""
    if isinstance(node, query_lib.Agg):
        return 1 + count_aggregates(node.arg)
    if isinstance(node, query_lib.Unary):
        return count_aggregates(node.arg)
    if isinstance(node, query_lib.Bin):
        return count_aggregates(node.lhs) + count_aggregates(node.rhs)
    return 0


def cost_from_features(n_events: int, calib_iters: int, n_aggregates: int,
                       *, weights: Optional[CostWeights] = None) -> float:
    """The cost model evaluated on pre-extracted features:

    ``cost = n_events * (1 + calib_weight*calib_iters)
                      * (1 + agg_weight*n_aggregates)``

    Pure arithmetic — callers that captured a query's features at
    admission (``Submission.n_events`` / ``n_aggregates``) can recost it
    under newly fitted weights without re-parsing; the scheduler's
    window-cost bounding does exactly that every dispatch."""
    w = weights or CostWeights()
    return (float(n_events) * (1.0 + w.calib_weight * calib_iters)
            * (1.0 + w.agg_weight * n_aggregates))


def estimate_cost(expr_or_ast: Union[str, query_lib.Node], *,
                  n_events: int, calib_iters: int = 0,
                  weights: Optional[CostWeights] = None) -> float:
    """Estimated cost of one query: events x calib work x aggregate depth
    (see :func:`cost_from_features` for the formula).

    ``weights`` defaults to the static module constants (the cold-start
    prior); the service passes its fitted :class:`CostWeights` once
    telemetry-based calibration has run.  Deliberately coarse — it only
    has to rank queries well enough for admission budgets (a 6-aggregate
    calibrated query over the full store must cost more than a scalar
    cut), not predict wall-clock.
    """
    ast = (query_lib.parse(expr_or_ast)
           if isinstance(expr_or_ast, str) else expr_or_ast)
    return cost_from_features(n_events, calib_iters, count_aggregates(ast),
                              weights=weights)


def window_cost(exprs: Sequence[str], *, n_events: int,
                calib_iters: int = 0) -> float:
    """Total unshared cost of a window (what admission budgeting charges)."""
    return sum(estimate_cost(e, n_events=n_events, calib_iters=calib_iters)
               for e in exprs)


# ---------------------------- window planning ---------------------------- #
def boolean_fragment_refs(plan: query_lib.FragmentPlan
                          ) -> List[Tuple[query_lib.Node, int]]:
    """Every boolean-valued scalar-context fragment of the window with the
    number of distinct query roots referencing it, whole-query roots
    excluded (those are already cached under their own canonical key),
    ordered deterministically by canonical key.  Only scalar-context
    fragments qualify — a track-context array is not a per-event mask.
    This is the shared walk behind both per-window materialization
    (:func:`shared_boolean_fragments`) and the fabric's cross-window
    fragment registry (which also heats single-reference fragments)."""
    refs: dict = {}

    def walk(node, seen):
        if id(node) in seen:
            return
        seen.add(id(node))
        refs.setdefault(id(node), [0, node])
        refs[id(node)][0] += 1
        # do not descend into aggregates: their arguments are track-context
        if isinstance(node, query_lib.Agg):
            return
        if isinstance(node, query_lib.Unary):
            walk(node.arg, seen)
        elif isinstance(node, query_lib.Bin):
            walk(node.lhs, seen)
            walk(node.rhs, seen)

    for root in plan.roots:
        walk(root, set())  # fresh `seen` per root: refs = #roots referencing
    root_ids = {id(r) for r in plan.roots}
    out = [(node, nrefs) for nrefs, node in refs.values()
           if id(node) not in root_ids and query_lib.is_boolean(node)]
    out.sort(key=lambda p: query_lib.node_key(p[0]))
    return out


def shared_boolean_fragments(plan: query_lib.FragmentPlan,
                             *, min_refs: int = 2) -> List[query_lib.Node]:
    """Boolean fragments referenced by >= ``min_refs`` distinct queries of
    the window (see :func:`boolean_fragment_refs` for what qualifies).
    Trivial fragments (bare comparisons of two leaves with no aggregate)
    are kept too: they are exactly the "shared ``count(pt > B)``
    conjunct" shape the roadmap calls out, and materializing a mask we
    already computed is nearly free."""
    return [node for node, nrefs in boolean_fragment_refs(plan)
            if nrefs >= min_refs]


def plan_window(exprs: Sequence[str], *, materialize: bool = True,
                max_materialized: int = 8, shared: bool = True,
                registry=None, metrics=None) -> query_lib.FragmentPlan:
    """Build the fragment plan for one dispatch window.

    Factors common subexpressions across ``exprs`` (one entry per unique
    canonical query) and, when ``materialize`` is set, marks up to
    ``max_materialized`` shared boolean fragments for first-class
    materialization (largest first, so compound conjuncts win the budget
    over their own sub-comparisons).  ``shared=False`` builds the unshared
    baseline plan (no cross-query factoring) for A/B measurement.

    ``registry`` (a :class:`~repro_torch.fabric.registry.FragmentRegistry`)
    enables cross-window pre-warming: the registry's hot fragments seed
    the window's interner BEFORE the queries are interned, and any hot
    fragment that actually occurs in this window is materialized even
    when only one query references it — its mask is a scan by-product,
    and caching it makes the next submission equal to it (on any fleet
    front-end) a zero-I/O hit.  Materialization never changes per-query
    results; the registry budget rides on top of ``max_materialized``.

    ``metrics`` (a :class:`repro_torch.obs.metrics.MetricsRegistry`, or None)
    records the planner's share of the observability catalog: windows
    planned, unique-fragment evaluations per packet vs. what unshared
    execution would cost, and fragments marked for materialization."""
    interner = query_lib.Interner()
    hot_nodes: Dict[str, query_lib.Node] = {}
    if registry is not None and shared:
        hot_nodes = registry.seed_interner(interner)
    plan = query_lib.build_fragment_plan(exprs, shared=shared,
                                         interner=interner)
    if materialize and shared:
        cands = shared_boolean_fragments(plan)
        cands.sort(key=query_lib.count_occurrences, reverse=True)
        plan.materialize = cands[:max_materialized]
        if hot_nodes:
            chosen = {id(m) for m in plan.materialize}
            root_ids = {id(r) for r in plan.roots}
            present: set = set()
            for r in plan.roots:
                query_lib._reachable(r, False, present)
            reachable_ids = {nid for nid, ctx in present if not ctx}
            for key in sorted(hot_nodes):
                node = hot_nodes[key]
                if (id(node) in reachable_ids and id(node) not in chosen
                        and id(node) not in root_ids
                        and query_lib.is_boolean(node)):
                    plan.materialize.append(node)
                    chosen.add(id(node))
    if metrics is not None:
        metrics.counter("plan.windows").inc()
        metrics.counter("plan.fragment_evals").inc(plan.evals_per_batch)
        metrics.counter("plan.fragment_evals_unshared").inc(
            plan.unshared_evals)
        metrics.counter("plan.materialized").inc(len(plan.materialize))
    return plan
