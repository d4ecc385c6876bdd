"""Fleets and meshes (port of ``mcmh_localization_tpu/parallel``).

``parallel.batched`` holds the batched fleet on one card
(``make_batched_model``, ``make_multimap_model``, ``stack_maps``);
``parallel.sharding`` the particle-axis sharding over a ``torch.
distributed`` mesh (``make_mesh``, ``make_sharded_model``,
``shard_state``), the JAX package's exports here; ``parallel.distributed``
the multi-rank island filter (``make_dist_model``).
"""

from mcmh_localization_tpu_torch.parallel import batched  # noqa: F401
from mcmh_localization_tpu_torch.parallel.sharding import (
    make_mesh,
    make_sharded_model,
    shard_state,
)

# the JAX package's parallel exports
__all__ = ["make_mesh", "make_sharded_model", "shard_state"]
