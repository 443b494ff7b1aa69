"""Pluggable 1-bit CS decoders (eq. 43) behind one entry point, ``decode``."""
from repro_torch.decode.fused import fused_biht_packed
from repro_torch.decode.iht import (biht_sign, hard_threshold,
                                    hard_threshold_bisect, iht)
from repro_torch.decode.registry import (DecodeConfig, Decoder, decode,
                                         get_decoder, list_decoders,
                                         register_decoder)

__all__ = [
    "DecodeConfig", "Decoder", "biht_sign", "decode", "fused_biht_packed",
    "get_decoder", "hard_threshold", "hard_threshold_bisect", "iht",
    "list_decoders", "register_decoder",
]
