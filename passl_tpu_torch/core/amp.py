"""Mixed precision: the compute dtype from the config's `FP16` block.

Counterpart of `passl_tpu/core/amp.py:24-58` (`resolve_dtype`,
`Policy.from_config`). Parameters stay float32; layers cast them to the
compute dtype where they use them. The loss scaler comes with training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

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


def dtype_name(dtype: torch.dtype) -> str:
    """torch.bfloat16 -> "bfloat16" (for configs and artifacts)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Policy:
    """Precision policy threaded into model construction.

    O1/O2 map to bf16 compute unless `dtype: float16` is asked for; O0, or
    `enable: False`, is float32.
    """

    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def from_config(cls, fp16_cfg: Optional[dict]) -> "Policy":
        if not fp16_cfg or not fp16_cfg.get("enable", True) or fp16_cfg.get("level", "O1") == "O0":
            return cls()
        return cls(resolve_dtype(fp16_cfg.get("dtype", "bfloat16")))
