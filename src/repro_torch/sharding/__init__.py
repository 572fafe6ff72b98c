"""repro_torch.sharding — the sharded LM path's layout rules (``specs``,
the JAX package's ``repro.sharding.specs``) and the collectives that
carry them out over ``torch.distributed`` (``collectives``: ``shard`` /
``unshard``, gather at use, Megatron's operators, the all-to-all)."""
from repro_torch.sharding.collectives import (ShardCtx, shard, shard_tree,
                                              unshard, unshard_tree)
from repro_torch.sharding.specs import (AbstractMesh, NamedSharding,
                                        PartitionSpec, batch_axes,
                                        cache_spec_for_leaf, make_cache_shardings,
                                        make_constrain, make_param_specs,
                                        spec_for_param)

__all__ = ["AbstractMesh", "NamedSharding", "PartitionSpec", "ShardCtx",
           "batch_axes", "cache_spec_for_leaf", "make_cache_shardings",
           "make_constrain", "make_param_specs", "shard", "shard_tree",
           "spec_for_param", "unshard", "unshard_tree"]
