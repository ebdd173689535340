"""Shared NN building blocks, with flax's precision conventions.

Counterpart of `passl_tpu/nn/layers.py:22-94`. Parameters are float32; each
layer casts them, and its input, to its compute `dtype` where it uses them,
as flax's `Dense`/`Conv(dtype=...)` do. `LayerNorm` takes its statistics in
float32 and returns the compute dtype, as flax's does. Images are NHWC at
the public functions, as in the JAX package.

Every module here owns `reset_parameters(generator)`, which fills its direct
parameters with the JAX package's initializers; `nn.init.init_module` walks
a model with one generator.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import init as tinit

Identity = nn.Identity  # ignores extra arguments, like the flax module


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.gelu`: the tanh approximation (torch's default is exact)."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Linear):
    """flax `Dense(dtype=..., use_bias=...)`: f32 weight `[out, in]`, computed at `dtype`."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 kernel_init: Callable = tinit.lecun_normal_, use_bias: bool = True):
        self.compute_dtype = dtype
        self.kernel_init = kernel_init
        super().__init__(in_features, out_features, bias=use_bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.kernel_init(self.weight, generator=generator)
        if self.bias is not None:
            tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """flax `Conv(padding="VALID", dtype=...)` over NCHW: weight OIHW, f32;
    xavier-uniform kernels unless `kernel_init` says otherwise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.float32, kernel_init: Callable = tinit.xavier_uniform_):
        self.compute_dtype = dtype
        self.kernel_init = kernel_init
        super().__init__(in_channels, out_channels, kernel_size, stride, padding=0)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.kernel_init(self.weight, generator=generator)
        tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class LayerNorm(nn.LayerNorm):
    """flax `LayerNorm(dtype=...)`: statistics and affine in f32, output at `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        self.compute_dtype = dtype
        super().__init__(dim, eps=eps)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.ones_(self.weight)
        tinit.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample; the identity in eval mode.

    As the JAX `DropPath` draws from the step's `dropout` stream, this one
    draws from an explicit `torch.Generator` on the tensor's device, handed
    down by the caller (the train state owns and checkpoints it), and never
    from the global RNG: in training with `rate > 0` a generator is required.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath: training with rate > 0 needs an explicit torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """fc1 -> tanh GELU -> fc2, xavier-uniform kernels (no dropout: serving only)."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype, kernel_init=tinit.xavier_uniform_)
        self.fc2 = Dense(hidden_features, in_features, dtype, kernel_init=tinit.xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class PatchEmbed(nn.Module):
    """Image NHWC -> patch tokens [n, h*w, c] via a strided conv (NCHW inside)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        return x.flatten(2).transpose(1, 2)  # [n, c, h, w] -> [n, h*w, c]
