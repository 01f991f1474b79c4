"""MNIST-scale MLP — the smallest end-to-end model (counterpart of
``byteps_tpu/models/mlp.py``).  Params are a list of {"w", "b"} dicts."""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch

from ..common.device import DeviceLike, resolve_device

Tree = Any


def init_params(generator: torch.Generator,
                sizes: Sequence[int] = (784, 256, 128, 10),
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Tree:
    dev = resolve_device(device)
    params = []
    for fin, fout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fin, fout), generator=generator, dtype=dtype,
                        device=generator.device) / math.sqrt(fin)
        params.append({"w": w.to(dev).requires_grad_(),
                       "b": torch.zeros(fout, dtype=dtype,
                                        device=dev).requires_grad_()})
    return params


def forward(params: Tree, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def loss_fn(params: Tree, batch: Tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    x, y = batch
    logp = torch.log_softmax(forward(params, x), dim=-1)
    return -logp.gather(-1, y[:, None])[:, 0].mean()


def accuracy(params: Tree, batch: Tuple[torch.Tensor, torch.Tensor]
             ) -> torch.Tensor:
    x, y = batch
    return (forward(params, x).argmax(-1) == y).float().mean()
