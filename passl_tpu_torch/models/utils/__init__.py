"""Helpers of the port's models: `pos_embed` (a copy of the JAX package's
sin-cos tables) and `FixedTable`, a fixed table handed out on a device."""
from __future__ import annotations

import numpy as np
import torch


class FixedTable:
    """A fixed table (numpy, f32 unless `dtype` says otherwise), not a
    parameter and not in the state_dict, copied to a device once on first use
    there (a model built on the meta device, as the exported artifact loads,
    needs no buffer filled)."""

    def __init__(self, array: np.ndarray, dtype=np.float32):
        self.array = np.ascontiguousarray(array, dtype=dtype)
        self._on: dict = {}

    def on(self, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            with torch.inference_mode(False):  # a plain tensor, whatever mode asked first
                t = self._on[device] = torch.from_numpy(self.array).to(device)
        return t
