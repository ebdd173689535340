"""Weight initializers that draw from an explicit `torch.Generator`.

Counterpart of `passl_tpu/nn/init.py:66-144` plus flax's default Dense
kernel init (`lecun_normal`). Each fills a tensor in place under
`torch.no_grad()` and returns it. Fans follow the torch layout (Linear
`[out, in]`, Conv `[out, in, *kernel]`), which gives the same numbers as the
JAX package's fans on flax layouts. The same seed draws other numbers than
`jax.random`: tests compare statistics, or carry weights across with
`utils.convert`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# std of a standard normal truncated to [-2, 2]; flax's truncated_normal
# variance scaling divides by it so the truncated draw keeps the asked std
_TRUNC_STD_2 = 0.87962566103423978


def zeros_(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.nn.init.zeros_(t)


def ones_(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.nn.init.ones_(t)


def constant_(t: torch.Tensor, value: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.nn.init.constant_(t, value)


def trunc_normal_(t: torch.Tensor, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                  b: float = 2.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(mean, std) truncated to the absolute bounds [a, b] (torch's semantics)."""
    return torch.nn.init.trunc_normal_(t, mean, std, a, b, generator=generator)


def xavier_uniform_(t: torch.Tensor, gain: float = 1.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.nn.init.xavier_uniform_(t, gain, generator=generator)


def lecun_normal_(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init: variance_scaling(1, fan_in, truncated_normal)."""
    fan_in, _ = torch.nn.init._calculate_fan_in_and_fan_out(t)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_2
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_module(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Fill every parameter of `module` from `generator`: each submodule's
    `reset_parameters(generator)` fills its own direct parameters."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator=generator)
    return module
