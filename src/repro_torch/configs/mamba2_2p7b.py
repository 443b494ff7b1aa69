"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    d_ff=0,                         # attention-free, no separate MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=8,
                  chunk_size=256, conv_width=4),
    attention=None,
    tie_embeddings=True,
    source="[arXiv:2405.21060] Mamba-2 / SSD",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", num_layers=2, d_model=256, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, n_groups=2,
                      chunk_size=32, conv_width=4))
