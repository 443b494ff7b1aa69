"""whisper-base [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub: ``input_specs()``
provides (batch, 1500, d_model) precomputed frame embeddings. We implement
the encoder transformer + decoder transformer with cross-attention.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                   # decoder layers
    num_encoder_layers=6,
    encoder_seq_len=1500,
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attention=AttentionConfig(num_heads=8, num_kv_heads=8, head_dim=64,
                              rope_theta=10_000.0),
    gated_mlp=False,
    tie_embeddings=True,
    source="[arXiv:2212.04356] Whisper",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, num_encoder_layers=2,
        encoder_seq_len=64, d_model=256, d_ff=512, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=64,
                                  rope_theta=10_000.0))
