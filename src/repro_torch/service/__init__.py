"""Multi-tenant query service over the GEPS grid-brick substrate:
shared-aggregate query planner (fragment factoring + cost model),
shared-scan batched execution, result cache, a concurrent job queue
with cost-budgeted admission and adaptive dispatch windows, and
streaming partial-merge result delivery (progressive histograms)."""
from repro_torch.service.cache import CacheStats, ResultCache
from repro_torch.service.frontend import (QUEUED, REJECTED, SERVED,
                                          QueryService, ServiceStats, Ticket,
                                          WindowController)
from repro_torch.service.planner import (CostWeights, boolean_fragment_refs,
                                         cost_from_features, count_aggregates,
                                         estimate_cost, fit_cost_weights,
                                         plan_window,
                                         shared_boolean_fragments,
                                         window_cost)
from repro_torch.service.scheduler import (AdmissionError, QueryScheduler,
                                           Submission, make_submission)
from repro_torch.service.streaming import (ResultStream, StreamSnapshot,
                                           WindowStreamPublisher)

__all__ = [
    "AdmissionError", "CacheStats", "CostWeights", "QueryScheduler",
    "QueryService", "QUEUED", "REJECTED", "ResultCache", "ResultStream",
    "SERVED", "ServiceStats", "StreamSnapshot", "Submission", "Ticket",
    "WindowController", "WindowStreamPublisher", "boolean_fragment_refs",
    "cost_from_features", "count_aggregates", "estimate_cost",
    "fit_cost_weights", "make_submission", "plan_window",
    "shared_boolean_fragments", "window_cost",
]
