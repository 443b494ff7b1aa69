"""Deprecated shim: ``repro_torch.launch.serve`` is now
``repro_torch.launch.decode_demo`` (it demos model prefill/decode, not a
serving system); port of ``repro/launch/serve.py``. The scheduling
service this name suggests is ``repro_torch.serve``:

  python -m repro_torch.serve --cells 10000 --ticks 20
"""
from __future__ import annotations

import warnings

from repro_torch.launch.decode_demo import main  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve is deprecated: the prefill/decode demo is "
    "repro_torch.launch.decode_demo, and the scheduling service is "
    "repro_torch.serve (python -m repro_torch.serve)", DeprecationWarning,
    stacklevel=2)

if __name__ == "__main__":
    main()
