# Copied from passl_tpu/engine/hooks.py; the port keeps its own copy and imports nothing of passl_tpu.
# Unchanged: its imports are relative, so they reach the port's own `registry` and `logger`.
"""Hook extension API.

Capability parity with the v110 generation's callback system
(`passl_v110/hooks/hook.py:16-69` Hook base with priorities;
LogHook/LRSchedulerHook/CheckpointHook/IterTimerHook etc.). In the
unified Engine the built-in behaviors (logging, lr, checkpoints,
timing, eval) are loop-native; hooks exist as the *user extension
point* — registered classes get called at run/epoch/iter boundaries
with the engine, so downstream projects can add custom behavior
without forking the loops.

Config:
  Global:
    hooks:
      - {name: MyHook, priority: 50, ...kwargs}
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..utils.registry import Registry

HOOKS = Registry("hooks")


class Hook:
    """Override any subset of the boundary methods."""

    priority: int = 50  # lower runs first

    def train_begin(self, engine):
        pass

    def train_end(self, engine):
        pass

    def epoch_begin(self, engine, epoch: int):
        pass

    def epoch_end(self, engine, epoch: int):
        pass

    def iter_end(self, engine, global_step: int, metrics):
        pass

    def eval_end(self, engine, metric: Optional[float]):
        pass


def register_hook(obj=None, name=None):
    return HOOKS.register(obj, name=name)


def build_hooks(cfg_list) -> List[Hook]:
    hooks: List[Hook] = []
    for item in cfg_list or []:
        item = dict(item)
        name = item.pop("name")
        priority = item.pop("priority", None)
        hook = HOOKS.get(name)(**item)
        if priority is not None:
            hook.priority = int(priority)
        hooks.append(hook)
    return sorted(hooks, key=lambda h: h.priority)


class HookList:
    def __init__(self, hooks: List[Hook]):
        self.hooks = hooks

    def call(self, event: str, *args, **kwargs):
        for h in self.hooks:
            getattr(h, event)(*args, **kwargs)


@register_hook
class IterTimerHook(Hook):
    """Example/compat hook: logs mean step wall time at epoch end
    (v110 IterTimerHook)."""

    def __init__(self):
        import time

        self._time = time
        self._t0 = None
        self._steps = 0

    def epoch_begin(self, engine, epoch):
        self._t0 = self._time.perf_counter()
        self._steps = 0

    def iter_end(self, engine, global_step, metrics):
        self._steps += 1

    def epoch_end(self, engine, epoch):
        from ..utils import logger

        if self._t0 and self._steps:
            dt = self._time.perf_counter() - self._t0
            logger.info(f"[IterTimerHook] epoch {epoch}: {dt / self._steps:.4f}s/iter")
