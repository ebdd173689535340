"""Projection necks of the SSL methods (counterpart of `passl_tpu/models/necks.py:23-193`).

`LinearNeck` (fc), `NonLinearNeckV1` (fc-relu-fc, MoCo v2), `NonLinearNeckV2`
(fc-bn-relu-fc, BYOL's projector and predictor), `NonLinearNeckV3`
(fc-bn-relu-fc-bn, the last BN without scale or bias) and `NonLinearNeckfc3`
(fc-bn-relu twice, then fc-bn, no Dense biases: SimCLR's projector) and
`SwAVNeck` (fc-bn-relu, fc, l2-normalize). Each takes a 4-D NHWC
feature map, which it averages over H and W when `with_avg_pool` says so,
or [N, C] features. Flax infers the input width; a torch module needs it at
construction, so each neck takes `in_channels` (the method passes the
backbone's `out_channels`, and a neck's own `out_channels` to the next).
Dense layers are lecun-normal with zero bias, at `dtype`; the BatchNorms are
`nn.norm.BatchNorm` (flax's semantics, momentum 0.9, epsilon 1e-5).

`MLP2d` (PixPro's projector: 1x1 conv, BatchNorm, relu, 1x1 conv) and
`DenseCLNeck` (a global fc-relu-fc branch beside a dense 1x1 conv-relu-conv
branch) keep the NHWC map: their 1x1 convs are `nn.layers.Conv1x1`, a
product over the channel axis with flax's conv names and layout (`conv1`,
`conv2`: OIHW weight, bias), and MLP2d's BatchNorm takes every position of
every image as a sample, as flax's BatchNorm over NHWC does.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import resolve_dtype
from ..nn.layers import Conv1x1, Dense
from ..nn.norm import BatchNorm, l2_normalize
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


@register_model
class SwAVNeck(nn.Module):
    """fc-bn-relu, then fc, then l2-normalize (SwAV's projector); the Dense
    layers with bias. `hid_channels` 0 skips the hidden layer, and
    `with_l2norm` False the normalization."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 with_avg_pool: bool = True, with_l2norm: bool = True,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.with_avg_pool = with_avg_pool
        self.with_l2norm = with_l2norm
        self.out_channels = out_channels
        if hid_channels > 0:
            self.fc1 = Dense(in_channels, hid_channels, dtype)
            self.bn1 = BatchNorm(hid_channels, dtype=dtype)
        self.fc2 = Dense(hid_channels if hid_channels > 0 else in_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(x, self.with_avg_pool)
        if hasattr(self, "fc1"):
            x = F.relu(self.bn1(self.fc1(x)))
        x = self.fc2(x)
        return l2_normalize(x, dim=-1) if self.with_l2norm else x


@register_model
class MLP2d(nn.Module):
    """1x1 conv, BatchNorm, relu, 1x1 conv on the NHWC map (PixPro's projector,
    `passl_tpu/models/necks.py:137-149`): [N, H, W, in] -> [N, H, W, out]."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.out_channels = out_channels
        self.conv1 = Conv1x1(in_channels, hid_channels, dtype)
        self.bn1 = BatchNorm(hid_channels, dtype=dtype)
        self.conv2 = Conv1x1(hid_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        shape = y.shape
        # every position of every image one sample of the channel statistics
        y = F.relu(self.bn1(y.reshape(-1, shape[-1]))).reshape(shape)
        return self.conv2(y)


@register_model
class DenseCLNeck(nn.Module):
    """DenseCL's two projections of the NHWC map (`passl_tpu/models/necks.py:152-178`):
    global, the mean over H and W, then fc1 (with bias), relu, fc2, no
    BatchNorm; dense, an optional `num_grid` average pool (window and stride
    H // num_grid, flax's VALID `avg_pool`), then 1x1 conv1, relu, 1x1 conv2.
    Returns (g [N, out], d [N, S, out] in row-major HW order, d's mean over S)."""

    def __init__(self, in_channels: int, hid_channels: int, out_channels: int,
                 num_grid: Optional[int] = None, dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.num_grid = num_grid
        self.out_channels = out_channels
        self.fc1 = Dense(in_channels, hid_channels, dtype)
        self.fc2 = Dense(hid_channels, out_channels, dtype)
        self.conv1 = Conv1x1(in_channels, hid_channels, dtype)
        self.conv2 = Conv1x1(hid_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> tuple:
        g = self.fc2(F.relu(self.fc1(x.mean(dim=(1, 2)))))
        d = x
        if self.num_grid is not None:
            s = x.shape[1] // self.num_grid
            d = F.avg_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)
        d = self.conv2(F.relu(self.conv1(d)))
        n, h, w, c = d.shape
        d = d.reshape(n, h * w, c)
        return g, d, d.mean(dim=1)
