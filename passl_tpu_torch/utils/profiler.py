# `ProfilerOptions` copied from passl_tpu/utils/profiler.py as it is; `add_profiler_step` is the
# port's own, on torch.profiler (the JAX one starts and stops jax.profiler).
"""Step-range profiler gate driven by a CLI option string (counterpart of
`passl_tpu/utils/profiler.py`).

`-p "batch_range=[10,20];profile_path=...;exit_on_finished=..."`: torch.profiler
records the host and, where there is a card, its kernels from global step
`batch_range[0]` to `batch_range[1]`, then writes a Chrome trace (viewable in
Perfetto or chrome://tracing) under `profile_path` and, with
`exit_on_finished`, exits the process with code 0. The other options
(`state`, `sorted_key`, `tracer_option`) are parsed as in JAX and not read.
"""
from __future__ import annotations

import ast
import os
import sys
from typing import Optional

import torch


class ProfilerOptions:
    """Parse 'key=value;key=value' option strings."""

    def __init__(self, options_str: Optional[str]):
        self.options = {
            "batch_range": [10, 20],
            "state": "All",
            "sorted_key": "total",
            "tracer_option": "Default",
            "profile_path": "/tmp/passl_tpu_profile",
            "exit_on_finished": True,
        }
        if options_str:
            self._parse(options_str)

    def _parse(self, options_str: str):
        for kv in options_str.replace(" ", "").split(";"):
            if not kv:
                continue
            key, value = kv.split("=", 1)
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
            if key == "batch_range":
                assert isinstance(value, list) and len(value) == 2 and 0 <= value[0] < value[1]
            self.options[key] = value

    def __getitem__(self, name):
        return self.options[name]


_profiler_options: Optional[ProfilerOptions] = None
_profiler: Optional[torch.profiler.profile] = None


def add_profiler_step(options_str: Optional[str] = None, global_step: int = 0) -> Optional[str]:
    """Call once per train step, after it (the JAX loop's place): starts
    torch.profiler at `batch_range[0]`, and at `batch_range[1]` or later stops
    it and writes `trace_<lo>_<hi>.json` under `profile_path` (returning its
    path), then exits with code 0 when `exit_on_finished`. The options string
    is parsed once per process, as in JAX."""
    global _profiler_options, _profiler
    if options_str is None:
        return None
    if _profiler_options is None:
        _profiler_options = ProfilerOptions(options_str)
    lo, hi = _profiler_options["batch_range"]
    if global_step == lo and _profiler is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        _profiler = torch.profiler.profile(activities=activities)
        _profiler.start()
    elif global_step >= hi and _profiler is not None:
        _profiler.stop()
        path = os.path.join(str(_profiler_options["profile_path"]), f"trace_{lo}_{hi}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _profiler.export_chrome_trace(path)
        _profiler = None
        if _profiler_options["exit_on_finished"]:
            sys.exit(0)
        return path
    return None
