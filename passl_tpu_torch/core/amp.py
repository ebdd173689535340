"""Mixed precision: the compute dtype from the config's `FP16` block, and
the dynamic loss scaler for float16.

Counterpart of `passl_tpu/core/amp.py` (`resolve_dtype`, `Policy.from_config`,
`GradScaler`). Parameters stay float32; layers cast them to the compute
dtype where they use them. bf16 needs no loss scaling; `dtype: float16`
turns it on (`Policy.use_loss_scaling`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def resolve_dtype(name: Union[str, torch.dtype, None]) -> torch.dtype:
    """A dtype name as the configs write it (or a torch.dtype) -> torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(k for k in _DTYPES if k)}")
    return _DTYPES[name]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32 where the JAX package casts to float32 for a loss, and
    kept in float64 where it is (a model run in f64 as a numerics yardstick)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def dtype_name(dtype: torch.dtype) -> str:
    """torch.bfloat16 -> "bfloat16" (for configs and artifacts)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Policy:
    """Precision policy threaded into model construction and the step.

    O1/O2 map to bf16 compute unless `dtype: float16` is asked for, which
    also turns on dynamic loss scaling; O0, or `enable: False`, is float32.
    """

    compute_dtype: torch.dtype = torch.float32
    use_loss_scaling: bool = False

    @classmethod
    def from_config(cls, fp16_cfg: Optional[dict]) -> "Policy":
        if not fp16_cfg or not fp16_cfg.get("enable", True) or fp16_cfg.get("level", "O1") == "O0":
            return cls()
        dtype = resolve_dtype(fp16_cfg.get("dtype", "bfloat16"))
        return cls(dtype, dtype == torch.float16)


@dataclasses.dataclass(frozen=True)
class ScalerState:
    scale: float
    growth_tracker: int


@dataclasses.dataclass(frozen=True)
class GradScaler:
    """Dynamic loss scaler: the scale doubles after `incr_every_n_steps`
    finite steps in a row (capped at `max_loss_scaling`) and halves, to no
    less than 1, on a step with a non-finite gradient, which the train step
    then skips. Its state is two host numbers, saved with the train state."""

    init_loss_scaling: float = 2.0**15
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    incr_every_n_steps: int = 2000
    max_loss_scaling: float = 2.0**32

    def init(self) -> ScalerState:
        return ScalerState(float(self.init_loss_scaling), 0)

    def unscale_and_check(self, grads: Sequence[torch.Tensor], state: ScalerState) -> bool:
        """Divides the f32 gradients by the scale in place; True when all are finite."""
        if not grads:
            return True
        torch._foreach_mul_(list(grads), 1.0 / state.scale)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        return bool(finite.item())

    def update(self, state: ScalerState, is_finite: bool) -> ScalerState:
        tracker = state.growth_tracker + 1 if is_finite else 0
        grow = tracker >= self.incr_every_n_steps
        if is_finite:
            scale = min(state.scale * self.incr_ratio, self.max_loss_scaling) if grow else state.scale
        else:
            scale = max(state.scale * self.decr_ratio, 1.0)
        return ScalerState(scale, 0 if grow else tracker)
