"""GEPS Grid-Brick core on PyTorch: the paper's primary contribution.

- events / query: the event-processing workload (ROOT-tree role + the
  user-facing filter-expression language)
- brick / catalog / replication: grid-brick storage on the device,
  metadata catalogue (PgSQL role), GRIS/LDAP node info, replica placement
- jse / merge / packets: job submission engine, hierarchical result merge,
  PROOF-style adaptive packets (straggler mitigation)
- backend: the ExecutionBackend contract — SimulatedBackend (virtual-time
  grid) and SpmdBackend (chunked streaming scan over device-resident
  bricks) behind one ``run_batch`` surface
- elastic: node join/leave, re-mesh, migration plans
"""
from repro_torch.core.backend import (ExecutionBackend,  # noqa: F401
                                      SimulatedBackend, SpmdBackend,
                                      make_backend)
from repro_torch.core.brick import (BrickSpec, BrickStore,  # noqa: F401
                                    create_store, store_from_reference)
from repro_torch.core.catalog import MetadataCatalog  # noqa: F401
from repro_torch.core.jse import (JobSubmissionEngine,  # noqa: F401
                                  TimeModel, spmd_query_batch_step,
                                  spmd_query_step)
