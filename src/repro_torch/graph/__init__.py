"""Graph substrate: structures, generators, partitioners, algorithms, and
the mutation layer of dynamic graphs (``mutation``)."""
from repro_torch.graph.mutation import (MutationBatch, MutationLog,
                                        MutationSchedule, apply_to_graph,
                                        apply_to_partitions, dirty_frontier)

__all__ = ["MutationBatch", "MutationLog", "MutationSchedule",
           "apply_to_graph", "apply_to_partitions", "dirty_frontier"]
