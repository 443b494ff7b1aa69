"""minicpm3-4b [dense] — MLA [hf:openbmb/MiniCPM3-4B]."""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    attention=AttentionConfig(num_heads=40, num_kv_heads=40,
                              rope_theta=10_000.0,
                              use_mla=True, kv_lora_rank=256, q_lora_rank=768,
                              qk_nope_dim=64, qk_rope_dim=32,
                              v_head_dim=64, head_dim=96),
    tie_embeddings=True,
    source="[hf:openbmb/MiniCPM3-4B]",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4,
                                  rope_theta=10_000.0,
                                  use_mla=True, kv_lora_rank=64, q_lora_rank=128,
                                  qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32, head_dim=48))
