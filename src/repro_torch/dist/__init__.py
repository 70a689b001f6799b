"""The upper system's fleet side, as in the JAX package's ``dist``:
``fault`` — fleet monitoring, straggler detection and Lemma-2
rebalancing, elastic re-mesh planning after a device loss, and the
deterministic fault-injection seam.  The sharding rules and the compressed
collectives are ROADMAP Queue A item 13b's."""
from repro_torch.dist.fault import (FailureSchedule, FleetMonitor, MeshPlan,
                                    detect_stragglers, elastic_plan,
                                    reassign_shards)

__all__ = ["FailureSchedule", "FleetMonitor", "MeshPlan",
           "detect_stragglers", "elastic_plan", "fault", "reassign_shards"]
