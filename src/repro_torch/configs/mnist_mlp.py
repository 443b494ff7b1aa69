"""The paper's own model: MLP 784-64-10, D = 50,890 parameters (Section V)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mnist-mlp",
    family="mlp",
    num_layers=1,                   # one hidden layer
    d_model=64,                     # hidden width
    d_ff=784,                       # input dim (re-used field)
    vocab_size=10,                  # classes
    tie_embeddings=False,
    source="paper §V: MLP 784-64-10, D=50890",
)


def smoke_config() -> ModelConfig:
    return CONFIG  # already tiny
