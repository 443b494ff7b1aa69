"""Pluggable 1-bit CS decoder registry — one entry point for eq. 43.

Port of ``repro/decode/registry.py``. Registered here: ``biht`` (the paper's
§V choice), ``iht`` and its warm-capable alias ``iht_warm``. With
``use_kernels`` the ``biht`` and ``iht`` loops run through the CUDA kernels
(``repro_torch.kernels.ops``). With ``packed``, ``biht`` takes ``y`` as
int32 words of 32 signs each: through the packed loop
(``decode/fused.py``) with kernels, else unpacked and through
``biht_sign``. Not ported yet: ``niht``, ``iht_fused`` and ``validate``
modes other than ``"off"``.

``decode`` forwards ``x0`` only to decoders registered with ``warm=True``,
so cold decoders ignore whatever state the caller carries.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict

from repro_torch.decode.fused import fused_biht_packed
from repro_torch.decode.iht import (biht_sign, hard_threshold,
                                    hard_threshold_bisect, iht)
from repro_torch.kernels.sign import unpack_signs


@dataclass(frozen=True)
class DecodeConfig:
    """Decoder selection + knobs, consumed by ``decode``. ``ht`` picks the
    hard threshold of the plain decoders: "sort" (exact, lowest-index
    ties) or "bisect"; the kernel paths always use the bisection kernel."""
    algorithm: str = "biht"
    iters: int = 30
    tau: float = 1.0
    use_kernels: bool = False
    ht: str = "sort"
    ht_iters: int = 40
    # y arrives as int32 words of 32 signs (kernels/sign.py codec); only
    # the sign-consistency ``biht`` decodes packed symbols
    packed: bool = False
    validate: str = "off"


@dataclass(frozen=True)
class Decoder:
    """Registry entry: the decode fn + whether it consumes warm state."""
    fn: Callable
    warm: bool = False


_REGISTRY: Dict[str, Decoder] = {}


def register_decoder(name: str, *, warm: bool = False):
    """Register ``fn(y, phi, k, cfg, x0) -> xhat`` under ``name``."""
    def deco(fn):
        _REGISTRY[name] = Decoder(fn=fn, warm=warm)
        return fn
    return deco


def get_decoder(name: str) -> Decoder:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown decoder {name!r}; registered: "
                         f"{', '.join(list_decoders())}") from None


def list_decoders():
    return sorted(_REGISTRY)


def _ht_fn(cfg: DecodeConfig):
    if cfg.ht == "bisect":
        return functools.partial(hard_threshold_bisect, iters=cfg.ht_iters)
    if cfg.ht == "sort":
        return hard_threshold
    raise ValueError(f"unknown hard-threshold {cfg.ht!r} (sort|bisect)")


def decode(y, phi, k: int, cfg: DecodeConfig, x0=None):
    """Decode the post-processed aggregate ŷ (eq. 13) back to the sparse
    gradient estimate (eq. 43). y: (n, S); phi: (S, D) -> (n, D). With
    ``cfg.packed``, y is instead the int32 sign words (n, S//32)."""
    if cfg.validate != "off":
        raise NotImplementedError(
            f"decode: validate={cfg.validate!r} is not ported yet (only "
            "'off')")
    dec = get_decoder(cfg.algorithm)
    return dec.fn(y, phi, k, cfg, x0 if dec.warm else None)


# --- built-ins -------------------------------------------------------------------

@register_decoder("iht")
def _iht(y, phi, k, cfg, x0):
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.iht(y, phi, k, cfg.iters, cfg.tau, x0=x0)
    return iht(y, phi, k, cfg.iters, cfg.tau, ht_fn=_ht_fn(cfg), x0=x0)


@register_decoder("iht_warm", warm=True)
def _iht_warm(y, phi, k, cfg, x0):
    return _iht(y, phi, k, cfg, x0)


@register_decoder("biht")
def _biht(y, phi, k, cfg, x0):
    if cfg.packed:
        if cfg.use_kernels:
            return fused_biht_packed(y, phi, k, cfg.iters, cfg.tau)
        y = unpack_signs(y, phi.dtype)
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.biht(y, phi, k, cfg.iters, cfg.tau)
    return biht_sign(y, phi, k, cfg.iters, cfg.tau, ht_fn=_ht_fn(cfg),
                     x0=x0)
