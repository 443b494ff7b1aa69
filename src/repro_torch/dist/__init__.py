"""Layout index math of the zoo on a logical mesh: ``sharding`` (which
dim of each parameter leaf the model axis splits) and ``flat_layout``
(the model-major flat order of the zoo-train master). Collectives over
more than one process are ROADMAP.md Queue 1, item 5."""
from repro_torch.dist.flat_layout import FlatShardLayout
from repro_torch.dist.sharding import (STACKED_KEYS, best_spec, constrain,
                                       infer_param_sharding,
                                       infer_param_specs, param_shard_dims)

__all__ = ["FlatShardLayout", "STACKED_KEYS", "best_spec", "constrain",
           "infer_param_sharding", "infer_param_specs", "param_shard_dims"]
