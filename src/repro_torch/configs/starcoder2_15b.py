"""starcoder2-15b [dense] — GQA, RoPE [arXiv:2402.19173]."""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    attention=AttentionConfig(num_heads=48, num_kv_heads=4, head_dim=128,
                              rope_theta=100_000.0),
    gated_mlp=False,
    tie_embeddings=False,
    source="[arXiv:2402.19173] StarCoder2",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=64,
                                  rope_theta=100_000.0))
