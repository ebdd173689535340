"""Model registry and factory (counterpart of `passl_tpu/models/base.py:28-74`).

Models are `torch.nn.Module`s. Classification models map images NHWC to
logits, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from ..utils.registry import Registry, build_from_config

MODELS = Registry("models")


def register_model(cls=None, name: Optional[str] = None):
    return MODELS.register(cls, name=name)


def two_views(batch) -> tuple:
    """An SSL method's batch, (view1, view2) or {"view1", "view2"} -> (view1, view2)."""
    return (batch["view1"], batch["view2"]) if isinstance(batch, dict) else (batch[0], batch[1])


def build_model(config: dict) -> nn.Module:
    """config: {'name': <registered name>, **kwargs}."""
    return build_from_config(dict(config), MODELS)
