"""Hand-written CUDA kernels for the OBCSAA pipeline (``csrc/*.cu``), each
with a plain PyTorch version beside it.

``ops`` holds the public wrappers and the decode loops composed from them;
``ref`` re-exports the plain versions; ``build`` compiles and loads the
kernels at first use and counts their launches. Importing this package
compiles nothing."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
