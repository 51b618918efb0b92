"""Coherence fabric: the layer that turns N single-process query
front-ends into one coherent fleet — a deterministic inter-front-end
message bus, epoch + liveness gossip with a bounded propagation delay,
a fleet-shared L2 result/fragment cache tier under every front-end's L1,
a persistent cross-window fragment registry, and cross-front-end
progressive-stream fan-out.  ``docs/fabric.md`` documents the coherence
and staleness model."""
from repro_torch.fabric.bus import BusStats, Envelope, MessageBus
from repro_torch.fabric.fanout import FanoutStats, StreamFanout
from repro_torch.fabric.fleet import Fleet, Frontend
from repro_torch.fabric.gossip import (GossipNode, GossipStats,
                                       adaptive_fanout, effective_epoch,
                                       merge_vv, rounds_bound)
from repro_torch.fabric.leases import (LEASE_TOPIC, LeaseManager,
                                       LeaseRecord, LeaseStats, lease_key,
                                       lease_ttl)
from repro_torch.fabric.registry import FragmentRecord, FragmentRegistry
from repro_torch.fabric.shared_cache import (SharedCacheStats, SharedCacheTier,
                                             TieredResultCache)

__all__ = [
    "BusStats", "Envelope", "FanoutStats", "Fleet", "FragmentRecord",
    "FragmentRegistry", "Frontend", "GossipNode", "GossipStats",
    "LEASE_TOPIC", "LeaseManager", "LeaseRecord", "LeaseStats",
    "MessageBus", "SharedCacheStats", "SharedCacheTier", "StreamFanout",
    "TieredResultCache", "adaptive_fanout", "effective_epoch",
    "lease_key", "lease_ttl", "merge_vv", "rounds_bound",
]
