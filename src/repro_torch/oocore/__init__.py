"""Out-of-core execution: host-resident super-shards streamed onto the card.

Each shard's columns (padded blocks, or CSR tiles) are reordered by an
access-frequency score; a *hot set* prefix stays on the device as a cache,
and the cold remainder is cut into equal *super-shards* that live in
pinned host memory and are copied onto the card one at a time on a side
CUDA stream — double-buffered, so super-shard ``i+1`` copies while
super-shard ``i`` runs the unchanged shard body.  Partials accumulate
across super-shards with the program's monoid before the single
upper-system merge, which keeps the result bit-identical to the
all-resident path for idempotent monoids (min/max/or are selections,
order and duplication free).  The JAX package's ``repro.oocore``, on
PyTorch.
"""
from repro_torch.oocore.config import (OocoreConfig, OocorePlan,
                                       plan_super_shards)
from repro_torch.oocore.prefetch import AsyncUploader
from repro_torch.oocore.supershard import SuperShardSet, build_super_shards

__all__ = [
    "OocoreConfig",
    "OocorePlan",
    "plan_super_shards",
    "AsyncUploader",
    "SuperShardSet",
    "build_super_shards",
]
