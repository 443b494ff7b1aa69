"""gemma2-2b [dense] — local+global alternating, logit softcap [arXiv:2408.00118]."""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256000,
    attention=AttentionConfig(num_heads=8, num_kv_heads=4, head_dim=256,
                              rope_theta=10_000.0, window=4096,
                              logit_softcap=50.0),
    local_global_period=2,          # alternate local, global (period 2)
    final_logit_softcap=30.0,
    tie_embeddings=True,
    source="[arXiv:2408.00118] Gemma 2",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma2-smoke", num_layers=2, d_model=256, d_ff=512,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=64,
                                  rope_theta=10_000.0, window=64,
                                  logit_softcap=50.0))
