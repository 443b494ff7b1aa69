from repro_torch.data.mnist import load_mnist, partition_workers
from repro_torch.data.synthetic import synthetic_mnist, token_stream
from repro_torch.data.tokens import TokenShards, write_token_shards

__all__ = ["TokenShards", "load_mnist", "partition_workers",
           "synthetic_mnist", "token_stream", "write_token_shards"]
