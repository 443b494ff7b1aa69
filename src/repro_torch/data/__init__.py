from repro_torch.data.mnist import load_mnist, partition_workers
from repro_torch.data.synthetic import synthetic_mnist, token_stream

__all__ = ["load_mnist", "partition_workers", "synthetic_mnist",
           "token_stream"]
