"""The upper system's distributed side, as in the JAX package's ``dist``,
by the paper's three optimization horizons:

* ``sharding``    — intra-iteration: logical-axis partitioning rules that
                    place every tensor dimension on a mesh axis, as specs
                    and ``torch.distributed.tensor`` placements (on one
                    card every tensor lies whole on the device);
                    ``RankMesh``, the graph path's shard axis across
                    ``torch.distributed`` ranks; ``RankGrid``, the
                    model path's (data, model) grid of ranks; and
                    ``TracedGrid``, one rank of such a grid on the meta
                    device for the dry run;
* ``collectives`` — inter-iteration: compressed synchronization (int8/int4
                    quantization with error feedback) over the port's m
                    logical devices or a RankMesh, which
                    ``MeshUpperSystem(wire="compressed")`` runs;
* ``fault``       — beyond-iteration: fleet monitoring, straggler
                    detection and Lemma-2 rebalancing, elastic re-mesh
                    planning after a device loss, and the deterministic
                    fault-injection seam.

The graph merge across ranks runs over a RankMesh; the models (the dense
layers' FSDP × TP layout, the MoE's expert layout) and the train step
over a RankGrid."""
from repro_torch.dist import collectives, fault, sharding
from repro_torch.dist.fault import (FailureSchedule, FleetMonitor, MeshPlan,
                                    detect_stragglers, elastic_plan,
                                    reassign_shards)
from repro_torch.dist.sharding import RankGrid, RankMesh, TracedGrid

__all__ = ["FailureSchedule", "FleetMonitor", "MeshPlan", "RankGrid",
           "RankMesh", "TracedGrid",
           "collectives",
           "detect_stragglers", "elastic_plan", "fault", "reassign_shards",
           "sharding"]
