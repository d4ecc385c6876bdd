"""Fleets of robots on one card (port of ``mcmh_localization_tpu/parallel``).

``parallel.batched`` holds the batched fleet (``make_batched_model``,
``make_multimap_model``, ``stack_maps``).  The JAX package's exports here
are its particle-axis sharding (``make_mesh``, ``make_sharded_model``,
``shard_state``), which the port has not yet ported, so it exports none of
them.
"""

from mcmh_localization_tpu_torch.parallel import batched  # noqa: F401

# the JAX package's parallel exports, less the sharding names not yet ported
__all__: list[str] = []
