"""LR schedulers as pure functions of the global step.

Counterpart of `passl_tpu/scheduler/__init__.py`: every scheduler there, each
a `step -> float` function built from the config's `LRScheduler` block by
`build_lr_scheduler`. The JAX package evaluates them inside the jitted step
in float32; here they are host Python floats, set on the optimizer's groups
before every step.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

LrFn = Callable[[int], float]


def _unit_steps(decay_unit: str, steps_per_epoch: int) -> int:
    return steps_per_epoch if decay_unit == "epoch" else 1


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def timm_cosine(learning_rate: float, epochs: int, steps_per_epoch: int, warmup_epoch: float = 0,
                warmup_start_lr: float = 0.0, eta_min: float = 0.0, warmup_prefix: bool = False,
                decay_unit: str = "step", **_: Any) -> LrFn:
    total = epochs * steps_per_epoch
    warmup = int(warmup_epoch * steps_per_epoch)
    unit = _unit_steps(decay_unit, steps_per_epoch)

    def fn(step: int) -> float:
        step = float(step)
        if step < warmup:
            return warmup_start_lr + (learning_rate - warmup_start_lr) * (step / max(warmup, 1))
        q = math.floor(step / unit) * unit  # epoch-wise decay holds the lr within an epoch
        if warmup_prefix:
            t = _clip01((q - warmup) / max(total - warmup, 1))
        else:
            t = _clip01(q / max(total, 1))
        return eta_min + 0.5 * (learning_rate - eta_min) * (1 + math.cos(math.pi * t))

    return fn


def vit_scheduler(learning_rate: float, epochs: int, steps_per_epoch: int, warmup_epoch: float = 0,
                  start_lr: float = 0.0, decay_type: str = "cosine", linear_end: float = 1e-5,
                  **_: Any) -> LrFn:
    """Warmup, then cosine or linear decay."""
    total = epochs * steps_per_epoch
    warmup = int(warmup_epoch * steps_per_epoch)

    def fn(step: int) -> float:
        step = float(step)
        if step < warmup:
            return start_lr + (learning_rate - start_lr) * (step / max(warmup, 1))
        t = _clip01((step - warmup) / max(total - warmup, 1))
        if decay_type == "linear":
            return linear_end + (learning_rate - linear_end) * (1 - t)
        return 0.5 * learning_rate * (1 + math.cos(math.pi * t))

    return fn


def step_decay(learning_rate: float, epochs: int, steps_per_epoch: int, step_size: int = 30,
               gamma: float = 0.1, warmup_epoch: float = 0, warmup_start_lr: float = 0.0,
               decay_unit: str = "epoch", **_: Any) -> LrFn:
    warmup = int(warmup_epoch * steps_per_epoch)
    unit = _unit_steps(decay_unit, steps_per_epoch)

    def fn(step: int) -> float:
        step = float(step)
        if step < warmup:
            return warmup_start_lr + (learning_rate - warmup_start_lr) * (step / max(warmup, 1))
        return learning_rate * gamma ** math.floor((step / unit) / step_size)

    return fn


def poly(learning_rate: float, epochs: int, steps_per_epoch: int, power: float = 1.0,
         end_lr: float = 0.0, warmup_epoch: float = 0, warmup_start_lr: float = 0.0,
         **_: Any) -> LrFn:
    total = epochs * steps_per_epoch
    warmup = int(warmup_epoch * steps_per_epoch)

    def fn(step: int) -> float:
        step = float(step)
        if step < warmup:
            return warmup_start_lr + (learning_rate - warmup_start_lr) * (step / max(warmup, 1))
        t = _clip01((step - warmup) / max(total - warmup, 1))
        return (learning_rate - end_lr) * (1 - t) ** power + end_lr

    return fn


def multistep(learning_rate: float, epochs: int, steps_per_epoch: int,
              milestones: Sequence[int] = (30, 60, 90), gamma: float = 0.1,
              decay_unit: str = "epoch", **_: Any) -> LrFn:
    unit = _unit_steps(decay_unit, steps_per_epoch)
    ms = sorted(float(m) for m in milestones)

    def fn(step: int) -> float:
        u = math.floor(float(step) / unit)
        return learning_rate * gamma ** sum(u >= m for m in ms)

    return fn


def cosine_warmup(learning_rate: float, epochs: int, steps_per_epoch: int,
                  warmup_epochs: float = 10, warmup_epoch: Optional[float] = None,
                  eta_min: float = 0.0, lr_scaling: Optional[str] = None,
                  global_batch_size: int = 256, base_batch_size: int = 256, **_: Any) -> LrFn:
    """Optional batch-size lr scaling (linear: lr * B / 256, sqrt: lr * sqrt(B)),
    then warmup and cosine."""
    if warmup_epoch is not None:
        warmup_epochs = warmup_epoch
    lr = learning_rate
    if lr_scaling == "linear":
        lr = learning_rate * global_batch_size / base_batch_size
    elif lr_scaling == "sqrt":
        lr = learning_rate * math.sqrt(global_batch_size)
    return timm_cosine(lr, epochs, steps_per_epoch, warmup_epoch=warmup_epochs, eta_min=eta_min)


def constant(learning_rate: float, **_: Any) -> LrFn:
    return lambda step: float(learning_rate)


SCHEDULERS: Dict[str, Callable[..., LrFn]] = {
    "TimmCosine": timm_cosine,
    "ViTLRScheduler": vit_scheduler,
    "Step": step_decay,
    "Poly": poly,
    "MultiStepDecay": multistep,
    "Cosine": timm_cosine,
    "CosineWarmup": cosine_warmup,
    "simclrCosineWarmup": lambda **kw: cosine_warmup(lr_scaling=kw.pop("lr_scaling", "linear"), **kw),
    "Constant": constant,
}


def build_lr_scheduler(config: Dict[str, Any], epochs: int, steps_per_epoch: int,
                       global_batch_size: int = 256) -> LrFn:
    """config: {name: TimmCosine, learning_rate: ..., ...}."""
    cfg = dict(config)
    name = cfg.pop("name", "TimmCosine")
    cfg.setdefault("learning_rate", cfg.pop("lr", 0.1) if "lr" in cfg else 0.1)
    return SCHEDULERS[name](epochs=epochs, steps_per_epoch=steps_per_epoch,
                            global_batch_size=global_batch_size, **cfg)
