"""Projection necks of the SSL methods (counterpart of `passl_tpu/models/necks.py:23-112`).

`LinearNeck` (fc), `NonLinearNeckV1` (fc-relu-fc, MoCo v2), `NonLinearNeckV2`
(fc-bn-relu-fc, BYOL's projector and predictor), `NonLinearNeckV3`
(fc-bn-relu-fc-bn, the last BN without scale or bias) and `NonLinearNeckfc3`
(fc-bn-relu twice, then fc-bn, no Dense biases: SimCLR's projector). Each takes a 4-D NHWC
feature map, which it averages over H and W when `with_avg_pool` says so,
or [N, C] features. Flax infers the input width; a torch module needs it at
construction, so each neck takes `in_channels` (the method passes the
backbone's `out_channels`, and a neck's own `out_channels` to the next).
Dense layers are lecun-normal with zero bias, at `dtype`; the BatchNorms are
`nn.norm.BatchNorm` (flax's semantics, momentum 0.9, epsilon 1e-5).

`SwAVNeck`, `MLP2d` and `DenseCLNeck` wait for their methods.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import resolve_dtype
from ..nn.layers import Dense
from ..nn.norm import BatchNorm
from .base import register_model

DtypeLike = Union[str, torch.dtype]


def _pool(x: torch.Tensor, with_avg_pool: bool) -> torch.Tensor:
    return x.mean(dim=(1, 2)) if with_avg_pool and x.dim() == 4 else x


@register_model
class LinearNeck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, with_avg_pool: bool = True,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        self.with_avg_pool = with_avg_pool
        self.out_channels = out_channels
        self.fc = Dense(in_channels, out_channels, resolve_dtype(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(_pool(x, self.with_avg_pool))


@register_model
class NonLinearNeckV1(nn.Module):
    """fc-relu-fc (MoCo v2)."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 with_avg_pool: bool = True, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.with_avg_pool = with_avg_pool
        self.out_channels = out_channels
        self.fc1 = Dense(in_channels, hid_channels, dtype)
        self.fc2 = Dense(hid_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(_pool(x, self.with_avg_pool))))


@register_model
class NonLinearNeckV2(nn.Module):
    """fc-bn-relu-fc (BYOL's projector and predictor)."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 with_avg_pool: bool = True, with_bias: bool = True,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.with_avg_pool = with_avg_pool
        self.out_channels = out_channels
        self.fc1 = Dense(in_channels, hid_channels, dtype, use_bias=with_bias)
        self.bn1 = BatchNorm(hid_channels, dtype=dtype)
        self.fc2 = Dense(hid_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(_pool(x, self.with_avg_pool))
        return self.fc2(F.relu(self.bn1(x)))


@register_model
class NonLinearNeckV3(nn.Module):
    """fc-bn-relu-fc-bn, the last BN without scale or bias (SimSiam's predictor style)."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 with_avg_pool: bool = True, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.with_avg_pool = with_avg_pool
        self.out_channels = out_channels
        self.fc1 = Dense(in_channels, hid_channels, dtype)
        self.bn1 = BatchNorm(hid_channels, dtype=dtype)
        self.fc2 = Dense(hid_channels, out_channels, dtype)
        self.bn2 = BatchNorm(out_channels, use_bias=False, use_scale=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(_pool(x, self.with_avg_pool))
        return self.bn2(self.fc2(F.relu(self.bn1(x))))


@register_model
class NonLinearNeckfc3(nn.Module):
    """fc-bn-relu, fc-bn-relu, fc-bn; the Dense layers without bias, the
    BatchNorms with scale and bias (SimCLR's projector)."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 with_avg_pool: bool = True, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.with_avg_pool = with_avg_pool
        self.out_channels = out_channels
        self.fc1 = Dense(in_channels, hid_channels, dtype, use_bias=False)
        self.bn1 = BatchNorm(hid_channels, dtype=dtype)
        self.fc2 = Dense(hid_channels, hid_channels, dtype, use_bias=False)
        self.bn2 = BatchNorm(hid_channels, dtype=dtype)
        self.fc3 = Dense(hid_channels, out_channels, dtype, use_bias=False)
        self.bn3 = BatchNorm(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(x, self.with_avg_pool)
        x = F.relu(self.bn1(self.fc1(x)))
        x = F.relu(self.bn2(self.fc2(x)))
        return self.bn3(self.fc3(x))
