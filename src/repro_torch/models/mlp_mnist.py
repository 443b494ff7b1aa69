"""The paper's own learning model (§V): MLP 784-64-10, ReLU, cross-entropy.

Port of ``repro/models/mlp_mnist.py``. Parameters are a dict of tensors in
JAX's layout — ``w1`` is (784, 64) and the forward pass is ``x @ w1`` — so
weights carry across unchanged (``repro_torch.convert``). The loss also
takes a leading worker axis on the parameters and the data, which is how
``engine.core.stacked_grads`` gets every worker's gradient in one pass.
D = 784*64 + 64 + 64*10 + 10 = 50,890.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import he_init

Params = Dict[str, torch.Tensor]


def init_mlp_mnist(seed: int = 0, d_in: int = 784, d_hidden: int = 64,
                   n_classes: int = 10, device=None) -> Params:
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"          # shapes only
           else torch.Generator(device=dev).manual_seed(seed))
    return {
        "w1": he_init(gen, (d_in, d_hidden), device=dev),
        "b1": torch.zeros((d_hidden,), device=dev),
        "w2": he_init(gen, (d_hidden, n_classes), device=dev),
        "b2": torch.zeros((n_classes,), device=dev),
    }


def mlp_mnist_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., K, 784) -> logits (..., K, 10). Leading axes of x and the
    parameters broadcast: a stack of U workers' weights (U, 784, 64) with
    x (U, K, 784) is one batched product."""
    h = torch.relu(x @ params["w1"] + params["b1"][..., None, :])
    return h @ params["w2"] + params["b2"][..., None, :]


def mlp_mnist_loss(params: Params, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the K samples: a scalar, or one loss per
    worker (U,) when the parameters and data carry a worker axis."""
    logp = torch.log_softmax(mlp_mnist_logits(params, x), dim=-1)
    nll = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
    return nll.mean(dim=-1)


def mlp_mnist_accuracy(params: Params, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    pred = mlp_mnist_logits(params, x).argmax(dim=-1)
    return (pred == y.long()).to(torch.float32).mean()


def param_dim(params: Params) -> int:
    return sum(p.numel() for p in params.values())
