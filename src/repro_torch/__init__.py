"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Module names mirror ``repro`` so each module's counterpart is easy to find.
The package imports ``torch`` and never JAX or ``repro``: the JAX
package is the reference it is held against (tests/test_torch_*.py), not a
dependency. Entry points take ``device=None``, which means CUDA, and raise
when no card is present unless the caller asks for ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
