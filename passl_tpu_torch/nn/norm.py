"""Normalization: `l2_normalize`, a BatchNorm with flax's semantics, and
MoCo's `SplitBatchNorm`.

Counterpart of `passl_tpu/nn/norm.py:26-86` (`l2_normalize`,
`SplitBatchNorm`) and of flax's
`nn.BatchNorm` as `passl_tpu/models/resnet.py:73-79` and
`passl_tpu/models/necks.py` build it (`momentum=0.9, epsilon=1e-5`).

`BatchNorm` normalizes over every axis but the channel axis 1 (NCHW
activations, in channels-last memory inside the ResNet, or [N, C]
features in the necks). As flax's, it takes its statistics in float32
whatever the compute dtype, normalizes in float32, and returns the compute
dtype; in training it normalizes with the batch statistics and updates
`ra = momentum * ra + (1 - momentum) * batch` with the batch's biased
variance; in eval (`model.eval()`, flax's `use_running_average`) it
normalizes with the running statistics. The arithmetic is PyTorch's
`F.batch_norm` (cuDNN on the card), which updates the running variance
with the unbiased batch variance; the update is put back on flax's biased
variance from the few per-channel numbers. Flax takes its variance as
E[x^2] - E[x]^2 and PyTorch as E[(x - E[x])^2]: the two differ by f32
rounding. On one value per channel in training (a [1, C] batch), where
`F.batch_norm` raises, it takes flax's arithmetic: the output is the bias.

There is no `num_batches_tracked`: flax keeps no such counter, and
`utils.convert` fills every buffer from the `batch_stats` tree.

`SplitBatchNorm` (MoCo's shuffle-BN, `bn_splits` on the ResNet) takes its
training statistics in f32 over `gcd(N, num_splits)` equal slices of the
batch, each slice normalized by its own mean and biased variance, as the
per-GPU BatchNorms of the reference did; its running statistics are
full-batch (the mean of the split means, and mean(var_s + mean_s^2) -
mean^2, as JAX takes them), and eval uses them. It has `BatchNorm`'s names,
so the converter needs no rule of its own.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1, epsilon: float = 1e-12) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), epsilon)) along `dim`."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=epsilon))


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum, epsilon, use_bias, use_scale, dtype)` over
    channel axis 1; parameters `weight` (flax `scale`) and `bias`, buffers
    `running_mean` and `running_var` (flax `batch_stats` `mean`, `var`), all f32."""

    def __init__(self, num_features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 use_bias: bool = True, use_scale: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(num_features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.epsilon)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._one_value_per_channel(x)
        # F.batch_norm updates (and autograd keeps) copies of the statistics
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0 - self.momentum,
                         self.epsilon)
        # it took ra + (1 - m) (n / (n - 1) var - ra) with the unbiased variance;
        # put the variance term back on the biased one
        with torch.no_grad():
            step = (var - self.momentum * self.running_var) * ((n - 1) / n)
            self.running_var.mul_(self.momentum).add_(step)
            self.running_mean.copy_(mean)
        return y

    def _one_value_per_channel(self, x: torch.Tensor) -> torch.Tensor:
        """Training on one value per channel, where `F.batch_norm` raises:
        flax's arithmetic in f32 (mean, var = max(E[x^2] - E[x]^2, 0) = 0),
        so the output is the bias (0 without one), x gets no gradient, and
        the running variance decays towards 0."""
        shape = [1, -1] + [1] * (x.dim() - 2)
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.epsilon)
        if self.weight is not None:
            y = y * self.weight.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        return y.to(self.compute_dtype)


class SplitBatchNorm(BatchNorm):
    """`passl_tpu/nn/norm.py:31 SplitBatchNorm(num_splits)` over channel axis 1.

    In training each of the `gcd(N, num_splits)` slices of the batch goes
    through PyTorch's batch norm on its own (on the card: bf16 activations in
    and out, statistics and normalization in f32, only the input kept for the
    backward), and the running update takes each slice's mean and variance
    from the statistics that call returns (variance = invstd^-2 - epsilon).
    A slice of one value per channel has variance 0 and normalizes to 0
    exactly, as in JAX: its output is the bias (the batch norm's
    x invstd - mean invstd would leave rounding of x / sqrt(epsilon))."""

    def __init__(self, num_features: int, num_splits: int = 8, momentum: float = 0.9,
                 epsilon: float = 1e-5, use_bias: bool = True, use_scale: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_features, momentum, epsilon, use_bias, use_scale, dtype)
        self.num_splits = num_splits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.to(self.compute_dtype)
        splits = math.gcd(x.shape[0], self.num_splits)  # a batch too small takes fewer
        if x.numel() == splits * x.shape[1]:
            return self._one_value_per_split(x, splits)
        outs, means, invstds = zip(*(
            torch.native_batch_norm(part, self.weight, self.bias, None, None, True, 0.0,
                                    self.epsilon) for part in x.chunk(splits)))
        with torch.no_grad():
            mean_s = torch.stack(means).float()
            var_s = torch.stack(invstds).float().pow(-2) - self.epsilon
            full_mean = mean_s.mean(0)
            full_var = (var_s + mean_s * mean_s).mean(0) - full_mean * full_mean
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * full_mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * full_var)
        return torch.cat(outs)

    def _one_value_per_split(self, x: torch.Tensor, splits: int) -> torch.Tensor:
        """Each split's mean is its value and its variance 0: the output is the
        bias (0 without one), x takes no gradient, and the running statistics
        take the batch's mean and biased variance."""
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = torch.zeros_like(x, dtype=torch.float32)
        if self.weight is not None:
            y = y * self.weight.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        with torch.no_grad():
            values = x.float().reshape(splits, -1)
            mean = values.mean(0)
            var = (values * values).mean(0) - mean * mean
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        return y.to(self.compute_dtype)
