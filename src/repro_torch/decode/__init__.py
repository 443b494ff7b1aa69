"""Pluggable 1-bit CS decoders (eq. 43) behind one entry point, ``decode``."""
from repro_torch.decode.fused import fused_biht_packed, fused_iht
from repro_torch.decode.iht import (IHT_STABILITY_BOUND, biht_sign,
                                    hard_threshold, hard_threshold_bisect,
                                    iht, iht_step_stable, niht,
                                    restricted_spectral_estimate)
from repro_torch.decode.registry import (DecodeConfig, Decoder, decode,
                                         get_decoder, list_decoders,
                                         register_decoder, resolve_validate)

__all__ = [
    "DecodeConfig", "Decoder", "IHT_STABILITY_BOUND", "biht_sign", "decode",
    "fused_biht_packed", "fused_iht", "get_decoder", "hard_threshold",
    "hard_threshold_bisect", "iht", "iht_step_stable", "list_decoders",
    "niht", "register_decoder", "resolve_validate",
    "restricted_spectral_estimate",
]
