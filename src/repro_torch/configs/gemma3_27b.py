"""gemma3-27b [dense] — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt]."""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab_size=262144,
    attention=AttentionConfig(num_heads=32, num_kv_heads=16, head_dim=128,
                              rope_theta=1_000_000.0, window=1024),
    local_global_period=6,          # 5 local : 1 global
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt] Gemma 3 family",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, local_global_period=2,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=64,
                                  rope_theta=1_000_000.0, window=64))
