"""Submodule builder: config dict -> module (counterpart of `passl_tpu/models/builder.py:17-38`).

An SSL method builds its backbone, neck and predictor from their config
blocks. `defaults` (e.g. `dtype`, or the input width `in_channels` that a
torch module needs at construction where flax infers it) are applied where
the target accepts them and the config does not set them.
"""
from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any

import torch
from torch import nn

from .base import MODELS


def build_submodule(cfg: Any, **defaults):
    """cfg: {'name': registered_name, **kwargs}, or an already built module
    (returned as is), or None."""
    if cfg is None:
        return None
    if not isinstance(cfg, Mapping):
        return cfg
    cfg = dict(cfg)
    target = MODELS.get(cfg.pop("name"))
    params = inspect.signature(target.__init__ if inspect.isclass(target) else target).parameters
    has_var_kw = any(p.kind == p.VAR_KEYWORD for p in params.values())
    for k, v in defaults.items():
        if has_var_kw or k in params:
            cfg.setdefault(k, v)
    if not has_var_kw and not inspect.isclass(target):
        cfg = {k: v for k, v in cfg.items() if k in params}
    return target(**cfg)


class Encoder(nn.Module):
    """A backbone and the neck over it, each from its config block (the
    towers of BYOL and the encoders of MoCo; flax names `backbone`, `neck`)."""

    def __init__(self, backbone: Any, neck: Any, dtype: torch.dtype):
        super().__init__()
        self.backbone = build_submodule(backbone, dtype=dtype)
        self.neck = build_submodule(neck, dtype=dtype, in_channels=self.backbone.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.neck(self.backbone(x))
