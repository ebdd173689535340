"""ResNet family (counterpart of `passl_tpu/models/resnet.py:128-309`).

`BasicBlock`, `BottleneckBlock` and `ResNet` with the named factories
`resnet18/34/50/101/152`, `wide_resnet50_2/101_2` and `resnext50_32x4d`,
registered under the JAX names. Images are NHWC at the input, as in the JAX
package; inside, the convolutions and BatchNorms run on NCHW tensors in
channels-last memory (`x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor
is one; any other input is copied into it), which is the layout cuDNN
takes fastest on the card. Convolutions compute
at `dtype` with f32 kernels (kaiming-normal, fan-out, relu gain); the
BatchNorms are `nn.norm.BatchNorm` (flax's semantics), or with
`bn_splits > 1` `nn.norm.SplitBatchNorm` at every norm position (MoCo's
shuffle-BN, as JAX's `_make_norm` builds it). With `num_classes=0`
there is no `fc`; with `with_pool=False` the output is the NHWC feature map
(`[N, 7, 7, 2048]` for ResNet-50 at 224), as the SSL necks take it.

Module names follow the flax model's (`layer{i}_{j}` is item j of the
ModuleList `layer{i}`), so `utils.convert.flax_to_torch` maps one onto the
other.

Not ported, and refused: `stem_impl: s2d` (the TPU's space-to-depth stem),
`bn_impl` other than `flax` (`fused_grad`, `ghost_grad`) and
`bn_stats_stride` / `bn_stats_slice > 1`. `bn_splits` together with
`bn_stats_*` raises ValueError, as in JAX.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import resolve_dtype
from ..nn import init as tinit
from ..nn.layers import Dense
from ..nn.norm import BatchNorm, SplitBatchNorm
from .base import MODELS, register_model

DtypeLike = Union[str, torch.dtype]


def _kaiming_fan_out(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return nn.init.kaiming_normal_(t, mode="fan_out", nonlinearity="relu", generator=generator)


class Conv(nn.Conv2d):
    """flax `Conv(use_bias=False, dtype=...)` on NCHW: f32 OIHW kernel, computed at `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, dtype: torch.dtype = torch.float32):
        self.compute_dtype = dtype
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, groups=groups,
                         bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _kaiming_fan_out(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding, 1,
                        self.groups)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32, norm: Callable[..., nn.Module] = BatchNorm):
        super().__init__()
        self.conv1 = Conv(in_channels, filters, 3, stride, 1, dtype=dtype)
        self.bn1 = norm(filters, dtype=dtype)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = norm(filters, dtype=dtype)
        if downsample:
            self.downsample_conv = Conv(in_channels, filters, 1, stride, dtype=dtype)
            self.downsample_bn = norm(filters, dtype=dtype)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(y + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64, dtype: torch.dtype = torch.float32,
                 norm: Callable[..., nn.Module] = BatchNorm):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out = filters * self.expansion
        self.conv1 = Conv(in_channels, width, 1, dtype=dtype)
        self.bn1 = norm(width, dtype=dtype)
        self.conv2 = Conv(width, width, 3, stride, 1, groups=groups, dtype=dtype)
        self.bn2 = norm(width, dtype=dtype)
        self.conv3 = Conv(width, out, 1, dtype=dtype)
        self.bn3 = norm(out, dtype=dtype)
        if downsample:
            self.downsample_conv = Conv(in_channels, out, 1, stride, dtype=dtype)
            self.downsample_bn = norm(out, dtype=dtype)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(y + identity)


def _refuse_unported(stem_impl: str, bn_impl: str, bn_splits: int, bn_stats_stride: int,
                     bn_stats_slice: int) -> None:
    if bn_splits > 1 and (bn_stats_stride > 1 or bn_stats_slice > 1):
        raise ValueError("bn_splits and bn_stats_stride/slice are mutually exclusive "
                         "(SplitBatchNorm already computes per-split stats)")
    if stem_impl != "conv7":
        raise NotImplementedError(f"ResNet stem_impl={stem_impl!r}: the port has the conv7 stem "
                                  "only (s2d is the TPU's space-to-depth formulation)")
    if bn_impl != "flax":
        raise NotImplementedError(f"ResNet bn_impl={bn_impl!r}: the port has the flax BatchNorm "
                                  "only")
    if bn_stats_stride > 1 or bn_stats_slice > 1:
        raise NotImplementedError("ResNet bn_stats_stride / bn_stats_slice > 1 (subsampled BN "
                                  "statistics) are not ported")


@register_model
class ResNet(nn.Module):
    """images [N, H, W, C] (NHWC) -> logits [N, num_classes] at `dtype`; with
    `num_classes=0` the pooled features [N, out_channels], or with
    `with_pool=False` as well the NHWC feature map [N, h, w, out_channels]."""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, groups: int = 1, width_per_group: int = 64,
                 bn_splits: int = 0, bn_stats_stride: int = 1, bn_stats_slice: int = 1,
                 bn_impl: str = "flax", with_pool: bool = True, cifar_stem: bool = False,
                 stem_impl: str = "conv7", dtype: DtypeLike = torch.float32,
                 head_init_std: Optional[float] = None, in_chans: int = 3):
        super().__init__()
        _refuse_unported(stem_impl, bn_impl, bn_splits, bn_stats_stride, bn_stats_slice)
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"ResNet block {block!r}: expected 'basic' or 'bottleneck'")
        dtype = resolve_dtype(dtype)
        block_cls = BasicBlock if block == "basic" else BottleneckBlock
        norm = (functools.partial(SplitBatchNorm, num_splits=bn_splits) if bn_splits > 1
                else BatchNorm)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.cifar_stem = cifar_stem
        self.head_init_std = head_init_std
        self.in_chans = in_chans
        if cifar_stem:
            self.conv1 = Conv(in_chans, 64, 3, 1, 1, dtype=dtype)
        else:
            self.conv1 = Conv(in_chans, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = norm(64, dtype=dtype)
        in_ch, filters = 64, 64
        for i, n_blocks in enumerate(layers):
            stage = nn.ModuleList()
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                out_ch = filters * block_cls.expansion
                kw = dict(downsample=stride != 1 or in_ch != out_ch, dtype=dtype, norm=norm)
                if block_cls is BottleneckBlock:
                    kw.update(groups=groups, base_width=width_per_group)
                stage.append(block_cls(in_ch, filters, stride, **kw))
                in_ch = out_ch
            setattr(self, f"layer{i + 1}", stage)
            filters *= 2
        self.num_stages = len(layers)
        self.out_channels = in_ch  # 512 x expansion for the four stages
        if num_classes > 0:
            init = (tinit.lecun_normal_ if not head_init_std else
                    lambda t, generator=None: nn.init.normal_(t, 0.0, head_init_std,
                                                              generator=generator))
            self.fc = Dense(in_ch, num_classes, dtype=dtype, kernel_init=init)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # NHWC -> NCHW in channels-last memory: a view of a contiguous input; a
        # copy of any other (the device augmentation's einsum lays its views out
        # [N, W, H, C]), else every conv and BatchNorm after it runs NCHW
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.bn1(self.conv1(x))
        x = F.relu(x)
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.num_stages):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x)
        x = x.permute(0, 2, 3, 1)  # back to NHWC
        if self.with_pool:
            x = x.mean(dim=(1, 2))
        if self.num_classes > 0:
            x = self.fc(x)
        return x


def _factory(name: str, **fixed):
    # a config that repeats a fixed field raises TypeError, as the JAX
    # factories (`ResNet(block=..., layers=..., **kw)`) do
    def factory(**kw) -> ResNet:
        return ResNet(**fixed, **kw)

    factory.__name__ = name
    return factory


_VARIANTS = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3)),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3)),
    "wide_resnet50_2": dict(block="bottleneck", layers=(3, 4, 6, 3), width_per_group=128),
    "wide_resnet101_2": dict(block="bottleneck", layers=(3, 4, 23, 3), width_per_group=128),
    "resnext50_32x4d": dict(block="bottleneck", layers=(3, 4, 6, 3), groups=32,
                            width_per_group=4),
}

for _name, _cfg in _VARIANTS.items():
    MODELS.register(_factory(_name, **_cfg), name=_name)
