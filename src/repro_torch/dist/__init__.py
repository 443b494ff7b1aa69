"""The port's ``dist``: ``collectives`` (the worker-group collectives:
the MAC as the group's all-reduce, gathers, the PS's broadcast), and the
layout index math of the zoo on a logical mesh: ``sharding`` (which dim
of each parameter leaf the model axis splits, and which arms of a sweep
a rank holds) and ``flat_layout`` (the model-major flat order of the
zoo-train master), and ``shares`` (one rank's share of a parameter
tree over the model group, and the forward and backward on it, for
the zoo-train round and the split train step). Over processes the
zoo's cells are ranks, and these collectives run over a mesh's worker
and model groups (``launch.mesh.world_mesh``)."""
from repro_torch.dist import collectives, shares
from repro_torch.dist.flat_layout import FlatShardLayout
from repro_torch.dist.sharding import (STACKED_KEYS, batch_indices,
                                       best_spec, constrain,
                                       infer_batch_sharding,
                                       infer_param_sharding,
                                       infer_param_specs, param_shard_dims,
                                       spec_bytes)

__all__ = ["FlatShardLayout", "STACKED_KEYS", "batch_indices", "best_spec",
           "collectives", "constrain", "infer_batch_sharding",
           "infer_param_sharding", "infer_param_specs",
           "param_shard_dims", "shares", "spec_bytes"]
