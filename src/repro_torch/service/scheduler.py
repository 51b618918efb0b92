"""Dispatch-window scheduler: admission control, per-tenant fairness, and
coalescing of compatible pending queries into shared-scan batches.

Every dispatch window the scheduler picks ONE shared-scan-compatible group
(same ``calib_iters`` — those jobs can ride the same calibrated sweep) and
fills it round-robin across tenants, one query per tenant per turn, so a
tenant spraying hundreds of submissions cannot starve everyone else: each
window serves the widest set of tenants first and depth second.  The
round-robin cursor persists across windows.

Admission control is two bounded queues deep — a per-tenant cap (one noisy
tenant saturates only its own allowance) and a global cap (the service
sheds load instead of accumulating unbounded backlog) — and, when
configured, *cost-budgeted*: each submission carries an estimated cost
(``planner.estimate_cost``: events x calibration x aggregate depth) and a
tenant whose queued cost would exceed ``cost_budget_per_tenant`` is
rejected even if it is under its count quota.  Count caps bound queue
*length*; cost budgets bound queued *work* — a tenant submitting three
6-aggregate calibrated full-store scans can be over budget while a tenant
submitting thirty scalar cuts is not.

Dispatch windows themselves are cost-bounded too: with
``window_cost_budget`` set, ``next_batch`` fills a window by accumulated
query cost instead of query count, recosting each queued submission with
the *fitted* :class:`~repro_torch.service.planner.CostWeights` of the execution
backend it dispatches to (``backend.cost_weights``, installed by the
service's telemetry refits — the static prior before any refit).  The
``max_batch`` count cap is retained as the fallback bound, and a window
always takes at least one submission so an over-budget query still runs
alone rather than starving.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

from repro_torch.core import query as query_lib
from repro_torch.service import planner as planner_lib


class AdmissionError(RuntimeError):
    """Submission rejected at the door (queue caps, cost budgets, or a bad
    expression)."""


@dataclasses.dataclass
class Submission:
    """One admitted query waiting for a dispatch window.

    ``canonical`` is the normalized expression (dedup/cache key) and
    ``cost`` the planner's estimate of the work this query represents if
    executed unshared (0.0 when the submitter opted out of costing).
    ``stream`` marks submissions whose tenant asked for progressive
    delivery: the front-end attaches a
    :class:`~repro_torch.service.streaming.ResultStream` and the dispatch window
    publishes per-packet prefix merges into it mid-scan.
    """
    ticket: int
    tenant: str
    expr: str
    canonical: str
    calib_iters: int
    cost: float = 0.0
    stream: bool = False
    # cost-model features captured at admission, so dispatch-time
    # recosting under refitted weights is arithmetic (no re-parse):
    # store events the query would sweep, and aggregate occurrences
    n_events: int = 0
    n_aggregates: int = 0


class QueryScheduler:
    """Bounded multi-tenant queue with fair, coalescing dispatch windows.

    Parameters
    ----------
    max_batch:
        Widest dispatch window (queries per shared scan).  The front-end's
        :class:`~repro_torch.service.frontend.WindowController` retunes this
        every window when adaptive sizing is enabled.
    max_pending_per_tenant / max_pending_total:
        Count caps: queue *length* bounds (always on).
    cost_budget_per_tenant / cost_budget_total:
        Cost budgets in planner cost units; ``None`` disables.  A
        submission is rejected when the submitting tenant's queued cost
        (or the global queued cost) would exceed the budget.
    window_cost_budget:
        Per-dispatch-window cost bound (planner cost units); ``None``
        fills windows by count only (the pre-refactor behaviour).  When
        set, ``next_batch`` stops filling once the next submission would
        push the window's total *fitted* cost over the budget — the
        ``max_batch`` count cap stays on as the fallback bound.
    backend:
        The :class:`~repro_torch.core.backend.ExecutionBackend` this scheduler
        dispatches to (the service wires it).  Its ``cost_weights``
        (telemetry-fitted for that backend) recost queued submissions at
        dispatch time; ``None`` falls back to each submission's
        admission-time cost.
    obs / health_gate:
        ``obs`` is the observability plane bundle
        (:class:`repro_torch.obs.Observability`; the service installs its own
        when None), whose health monitor supplies the fleet
        ok/degraded/suspect report.  ``health_gate`` is the ADVISORY
        flag (default off): when set and the report shows unhealthy
        nodes, :meth:`next_batch` narrows the dispatch window by the
        healthy fraction, so sick nodes see less concurrent work while
        staying in rotation.  This is deliberately a hint, not a
        routing policy — the failure policy
        (:mod:`repro_torch.service.policy`) plugs into exactly this
        consumption point.
    """

    def __init__(self, *, max_batch: int = 64,
                 max_pending_per_tenant: int = 64,
                 max_pending_total: int = 512,
                 cost_budget_per_tenant: Optional[float] = None,
                 cost_budget_total: Optional[float] = None,
                 window_cost_budget: Optional[float] = None,
                 backend=None, obs=None, health_gate: bool = False,
                 policy=None):
        self.max_batch = max_batch
        self.obs = obs
        self.health_gate = health_gate
        #: the failure policy (service/policy.py), when one is driving
        #: the service: next_batch narrows admission by its routable
        #: fraction — banned nodes shrink dispatch capacity, so windows
        #: shrink with it (the acting counterpart of health_gate's hint)
        self.policy = policy
        #: last advisory narrowing applied (None when the gate is off or
        #: the fleet is healthy) — what tests and operators inspect
        self.last_health_hint: Optional[Dict] = None
        #: single-flight lease manager (fabric/leases.py), wired by the
        #: service when the fleet runs with leases: a submission another
        #: front-end already holds a fresh lease on will be ADOPTED at
        #: dispatch (zero local I/O), so it costs ~0 against window
        #: budgets — adopted work never crowds out real scans
        self.leases = None
        #: flight-recorder scope (repro_torch.obs.flight.FlightScope); None =
        #: off.  Records each dispatch window's ticket composition.
        self.flight = None
        self.max_pending_per_tenant = max_pending_per_tenant
        self.max_pending_total = max_pending_total
        self.cost_budget_per_tenant = cost_budget_per_tenant
        self.cost_budget_total = cost_budget_total
        self.window_cost_budget = window_cost_budget
        self.backend = backend
        # OrderedDict keeps tenant rotation stable in arrival order
        self._pending: "OrderedDict[str, Deque[Submission]]" = OrderedDict()
        self._total = 0
        self._cost: Dict[str, float] = {}
        self._cost_total = 0.0
        self._rr = 0  # persistent round-robin cursor over tenants

    # ------------------------------------------------------------------ #
    @property
    def n_pending(self) -> int:
        """Queries queued across all tenants."""
        return self._total

    @property
    def pending_cost(self) -> float:
        """Total queued cost across all tenants (planner cost units)."""
        return self._cost_total

    def pending_for(self, tenant: str) -> int:
        """Queries queued for one tenant."""
        return len(self._pending.get(tenant, ()))

    def pending_cost_for(self, tenant: str) -> float:
        """Queued cost for one tenant (planner cost units)."""
        return self._cost.get(tenant, 0.0)

    def enqueue(self, sub: Submission):
        """Admit one submission or raise :class:`AdmissionError`.

        Checks, in order: global count cap, per-tenant count cap, global
        cost budget, per-tenant cost budget.  Nothing is queued on
        rejection."""
        if self._total >= self.max_pending_total:
            raise AdmissionError(
                f"service overloaded ({self._total} pending)")
        q = self._pending.get(sub.tenant)
        if q is not None and len(q) >= self.max_pending_per_tenant:
            raise AdmissionError(
                f"tenant {sub.tenant!r} over quota ({len(q)} pending)")
        if (self.cost_budget_total is not None
                and self._cost_total + sub.cost > self.cost_budget_total):
            raise AdmissionError(
                f"service over cost budget "
                f"({self._cost_total:.0f} + {sub.cost:.0f} queued "
                f"> {self.cost_budget_total:.0f})")
        tenant_cost = self._cost.get(sub.tenant, 0.0)
        if (self.cost_budget_per_tenant is not None
                and tenant_cost + sub.cost > self.cost_budget_per_tenant):
            raise AdmissionError(
                f"tenant {sub.tenant!r} over cost budget "
                f"({tenant_cost:.0f} + {sub.cost:.0f} queued "
                f"> {self.cost_budget_per_tenant:.0f})")
        self._pending.setdefault(sub.tenant, deque()).append(sub)
        self._total += 1
        self._cost[sub.tenant] = tenant_cost + sub.cost
        self._cost_total += sub.cost

    def requeue(self, sub: Submission) -> None:
        """Put a previously dequeued submission back at the FRONT of its
        tenant queue, bypassing admission caps — the single-flight
        fallback path (an adoption whose owner died/was banned must get
        its own scan, and it was already admitted once)."""
        self._pending.setdefault(sub.tenant, deque()).appendleft(sub)
        self._total += 1
        self._cost[sub.tenant] = self._cost.get(sub.tenant, 0.0) + sub.cost
        self._cost_total += sub.cost

    def _remotely_leased(self, sub: Submission) -> bool:
        # a fresh remote lease means this submission will be adopted,
        # not scanned: ~0 window cost
        return (self.leases is not None
                and self.leases.remote_holder(sub.canonical,
                                              sub.calib_iters) is not None)

    # ------------------------------------------------------------------ #
    def _oldest(self) -> Optional[Submission]:
        heads = [q[0] for q in self._pending.values() if q]
        return min(heads, key=lambda s: s.ticket) if heads else None

    def dispatch_cost(self, sub: Submission) -> float:
        """Cost of one queued submission under the CURRENT cost model.

        Recosts the submission's admission-time features with the
        execution backend's telemetry-fitted weights when the scheduler
        is wired to a backend that has them; otherwise the admission-time
        estimate stands.  This is what makes window-cost bounding track
        the *fitted* model rather than the weights in force when the
        query happened to be admitted."""
        weights = getattr(self.backend, "cost_weights", None)
        if weights is None or sub.n_events <= 0:
            return sub.cost
        return planner_lib.cost_from_features(
            sub.n_events, sub.calib_iters, sub.n_aggregates,
            weights=weights)

    def next_batch(self) -> List[Submission]:
        """One dispatch window: the shared-scan group (``calib_iters``) of
        the oldest pending query, filled round-robin across tenants up to
        ``max_batch`` wide — and, with ``window_cost_budget`` set, up to
        that much fitted cost (:meth:`dispatch_cost`): the fill stops at
        the first submission that would overflow the budget (no
        cost-based queue jumping), but always takes at least one so an
        over-budget query runs alone instead of starving.  A submission
        whose canonical form is already in the window being filled is
        FREE — the front-end dedups it onto the same execution, so
        charging it would under-fill windows on hot-query traffic.
        Dequeued submissions release their queued (admission-time)
        cost.

        With ``health_gate`` set and the observability plane's health
        report showing degraded/suspect nodes, the window is narrowed to
        ``max_batch * healthy_fraction`` (floor 1) — the advisory
        consumption of the fleet health telemetry."""
        oldest = self._oldest()
        if oldest is None:
            return []
        max_batch = self.max_batch
        self.last_health_hint = None
        if self.health_gate and self.obs is not None:
            report = self.obs.health.report()
            frac = report.healthy_fraction
            if frac < 1.0:
                max_batch = max(1, int(round(self.max_batch * frac)))
                self.last_health_hint = {
                    "max_batch": max_batch,
                    "healthy_fraction": frac,
                    "suspect": report.suspects,
                    "degraded": report.degraded,
                }
                self.obs.metrics.counter("sched.health_hints").inc()
        if self.policy is not None:
            frac = self.policy.routable_fraction()
            if frac < 1.0:
                # banned nodes shrink scan capacity: admit proportionally
                # fewer queries per window so queueing moves to admission
                # (where fairness applies) instead of the scan itself
                max_batch = max(1, min(max_batch,
                                       int(round(self.max_batch * frac))))
                self.last_health_hint = dict(
                    self.last_health_hint or {},
                    max_batch=max_batch,
                    routable_fraction=frac,
                    policy_states=self.policy.states())
        group = oldest.calib_iters
        budget = self.window_cost_budget
        window_cost = 0.0
        window_canonicals: set = set()
        out: List[Submission] = []
        tenants = list(self._pending)
        start = self._rr % max(1, len(tenants))
        progressed, capped = True, False
        while len(out) < max_batch and progressed and not capped:
            progressed = False
            for off in range(len(tenants)):
                if len(out) >= max_batch:
                    break
                tenant = tenants[(start + off) % len(tenants)]
                q = self._pending[tenant]
                i = self._peek_matching(q, group)
                if i is None:
                    continue
                sub = q[i]
                cost = (0.0 if sub.canonical in window_canonicals
                        or self._remotely_leased(sub)
                        else self.dispatch_cost(sub))
                if budget is not None and out and window_cost + cost > budget:
                    capped = True
                    break
                del q[i]
                out.append(sub)
                window_cost += cost
                window_canonicals.add(sub.canonical)
                self._total -= 1
                self._cost[tenant] = max(
                    0.0, self._cost.get(tenant, 0.0) - sub.cost)
                self._cost_total = max(0.0, self._cost_total - sub.cost)
                progressed = True
        self._rr += 1
        for tenant in [t for t, q in self._pending.items() if not q]:
            del self._pending[tenant]
            self._cost.pop(tenant, None)
        if self.flight is not None and out:
            self.flight.record("window",
                               tickets=[s.ticket for s in out],
                               tenants=sorted({s.tenant for s in out}),
                               group=group, max_batch=max_batch)
        return out

    @staticmethod
    def _peek_matching(q: Deque[Submission], group: int) -> Optional[int]:
        for i, sub in enumerate(q):
            if sub.calib_iters == group:
                return i
        return None


def make_submission(ticket: int, tenant: str, expr: str, calib_iters: int,
                    schema, *, n_events: int = 0, stream: bool = False,
                    weights=None) -> Submission:
    """Validate at the door, canonicalize for dedup/caching, and estimate
    cost for budgeted admission.

    ``n_events`` is the store size the query would sweep (0 disables
    costing — the submission carries cost 0.0 and only count caps apply);
    ``stream`` requests progressive partial-merge delivery; ``weights``
    (a :class:`~repro_torch.service.planner.CostWeights`) selects the cost
    model's coefficients — the service passes its telemetry-fitted
    weights, None means the static cold-start prior.  Raises
    :class:`AdmissionError` on an invalid expression: a bad query must be
    rejected at submit, not on a grid node."""
    try:
        ast = query_lib.validate_expr(expr, schema)
        canonical = query_lib.canonical_expr(expr)
    except query_lib.QueryError as e:
        raise AdmissionError(f"bad expression: {e}") from e
    n_aggregates = planner_lib.count_aggregates(ast)
    cost = (planner_lib.estimate_cost(ast, n_events=n_events,
                                      calib_iters=calib_iters,
                                      weights=weights)
            if n_events > 0 else 0.0)
    return Submission(ticket, tenant, expr, canonical, calib_iters, cost,
                      stream=stream, n_events=max(0, n_events),
                      n_aggregates=n_aggregates)
