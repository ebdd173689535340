# Copied from passl_tpu/utils/misc.py; the port keeps its own copy and imports nothing of passl_tpu.
# Only what the port uses: AttrDict and create_attr_dict (config.py), SmoothedValue
# (engine/loops.py) without its multi-host synchronisation, which needs jax.
"""Small utilities: AttrDict, meters.

Capability parity with reference `passl/utils/misc.py` (AverageMeter:30,
SmoothedValue:86, AttrDict) — re-implemented for a JAX host loop (no
framework tensors cross this layer; everything is float/ndarray).
"""
from __future__ import annotations

import collections
from typing import Any


class AttrDict(dict):
    """dict with attribute access, recursively converting nested dicts."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo):
        import copy

        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @classmethod
    def from_nested(cls, d: dict) -> "AttrDict":
        def conv(v):
            if isinstance(v, dict):
                return cls({k: conv(x) for k, x in v.items()})
            if isinstance(v, (list, tuple)):
                return type(v)(conv(x) for x in v)
            return v

        return conv(dict(d))


def create_attr_dict(d: dict) -> AttrDict:
    return AttrDict.from_nested(d)


class SmoothedValue:
    """Track a series of values; report median/avg over a sliding window
    and the global average. Mirrors reference `misc.py:86` semantics."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    @property
    def median(self) -> float:
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    @property
    def avg(self) -> float:
        if not self.deque:
            return 0.0
        return sum(self.deque) / len(self.deque)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )
