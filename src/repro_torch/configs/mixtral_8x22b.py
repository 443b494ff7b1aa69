"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, MoEConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    attention=AttentionConfig(num_heads=48, num_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0, window=4096),
    moe=MoEConfig(num_experts=8, num_shared_experts=0, top_k=2,
                  capacity_factor=1.25),
    tie_embeddings=False,
    source="[arXiv:2401.04088] Mixtral of Experts",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=64,
                                  rope_theta=1_000_000.0, window=64),
        moe=MoEConfig(num_experts=4, num_shared_experts=0, top_k=2,
                      capacity_factor=1.25))
