"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434].

Deviation (DESIGN.md §8): all 27 layers are MoE (real model's layer 0 is
dense); assignment specifies the uniform "MoE 64e top-6" stack.
"""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, MoEConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    d_ff=1408,                      # per-expert intermediate
    vocab_size=102400,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16,
                              rope_theta=10_000.0,
                              use_mla=True, kv_lora_rank=512, q_lora_rank=0,
                              qk_nope_dim=128, qk_rope_dim=64,
                              v_head_dim=128, head_dim=192),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  capacity_factor=1.25),
    tie_embeddings=False,
    source="[arXiv:2405.04434] DeepSeek-V2 (Lite)",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-lite-smoke", num_layers=2, d_model=256,
        d_ff=128, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4,
                                  rope_theta=10_000.0,
                                  use_mla=True, kv_lora_rank=64, q_lora_rank=0,
                                  qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32, head_dim=48),
        moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2,
                      capacity_factor=1.25))
