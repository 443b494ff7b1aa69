"""internvl2-1b [vlm] — InternViT + InternLM2/Qwen2 backbone [arXiv:2404.16821].

The vision frontend (InternViT + MLP projector) is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings of shape
(batch, num_image_tokens, d_model); we implement the language decoder that
consumes them interleaved with text tokens.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151655,
    attention=AttentionConfig(num_heads=14, num_kv_heads=2, head_dim=64,
                              rope_theta=1_000_000.0),
    num_image_tokens=256,
    tie_embeddings=True,
    source="[arXiv:2404.16821] InternVL2 (Qwen2-0.5B LM backbone)",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512, num_image_tokens=16,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=64,
                                  rope_theta=1_000_000.0))
