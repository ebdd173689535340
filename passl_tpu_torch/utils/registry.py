# Copied from passl_tpu/utils/registry.py; the port keeps its own copy and imports nothing of passl_tpu.
"""Name → class registry with config-driven construction.

Capability parity with reference `passl_v110/utils/registry.py:25-135`
(`Registry` + `build_from_config`), unified so both framework generations'
factories resolve through one mechanism.
"""
from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Callable) -> None:
        if name in self._obj_map:
            raise KeyError(f"'{name}' already registered in '{self._name}' registry")
        self._obj_map[name] = obj

    def register(self, obj: Optional[Callable] = None, name: Optional[str] = None):
        if obj is None:  # decorator with optional name
            def deco(fn_or_cls):
                self._do_register(name or fn_or_cls.__name__, fn_or_cls)
                return fn_or_cls

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Callable:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()


def build_from_config(cfg: Optional[dict], registry: Registry, default_args: Optional[dict] = None) -> Any:
    """Build an object from {'name': ClassName, **kwargs} config."""
    if cfg is None:
        return None
    assert isinstance(cfg, dict) and ("name" in cfg), f"bad config for {registry.name}: {cfg}"
    cfg = copy.deepcopy(dict(cfg))
    name = cfg.pop("name")
    cls = registry.get(name)
    if default_args:
        for k, v in default_args.items():
            cfg.setdefault(k, v)
    sig = inspect.signature(cls.__init__ if inspect.isclass(cls) else cls)
    has_var_kw = any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values())
    if not has_var_kw:
        accepted = set(sig.parameters)
        cfg = {k: v for k, v in cfg.items() if k in accepted}
    return cls(**cfg)
