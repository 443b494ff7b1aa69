"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 mamba2 layers; a single weight-tied (shared) attention+MLP block is applied
every 6 mamba layers (13 applications).
"""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      SSMConfig)

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,                     # shared block MLP
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=2,
                  chunk_size=256, conv_width=4),
    attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=112,
                              rope_theta=10_000.0),
    hybrid_attn_every=6,
    tie_embeddings=True,
    source="[arXiv:2411.15242] Zamba2",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, hybrid_attn_every=2,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, n_groups=2,
                      chunk_size=32, conv_width=4),
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=64,
                                  rope_theta=10_000.0))
