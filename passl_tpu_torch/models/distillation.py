"""Knowledge distillation (counterpart of `passl_tpu/models/distillation.py`).

`DistillationWrapper` builds a teacher and a student from their config
blocks (both at the wrapper's dtype) and, in training, takes the label-free
loop's `(images, labels)` batch (or `{"image", "label"}`) and returns its
loss dict: `(1 - alpha) ce + alpha distill` with `ce` the cross-entropy of
the student's logits to the labels, and `distill` either the cross-entropy
to the teacher's argmax (`hard_distill`, DeiT's recipe) or the soft term at
temperature T, `-mean(sum(p_t log p_s)) T^2` over f32 softmax and
log-softmax of the logits over T (a cross-entropy, the teacher's entropy
included, as the JAX wrapper has it); `acc1` is a metric. The teacher is
frozen: its parameters match `frozen_patterns()` (the optimizer keeps no
state for them), it runs under `torch.no_grad()`, and it stays in eval mode
(its running statistics, never updated) whatever `train()` asks, as JAX
calls it with `train=False`.

In eval the wrapper returns the student's logits on the images: the eval
step hands it the images alone, where the JAX wrapper's unpacking fails
(ROADMAP.md, Queue 3). The engine refuses the wrapper beside a `Loss.Train`
block, on which the JAX engine fails at its init.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32, resolve_dtype
from ..loss import cross_entropy
from .base import register_model
from .builder import build_submodule

DtypeLike = Union[str, torch.dtype]


@register_model
class DistillationWrapper(nn.Module):
    def __init__(self, teacher: Any = None, student: Any = None, temperature: float = 1.0,
                 alpha: float = 0.5, hard_distill: bool = False,
                 dtype: DtypeLike = torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        self.temperature = temperature
        self.alpha = alpha
        self.hard_distill = hard_distill
        self.teacher = build_submodule(teacher, dtype=dtype)
        self.student = build_submodule(student, dtype=dtype)
        self.teacher.eval()

    @staticmethod
    def frozen_patterns():
        return [r"^teacher\."]

    def train(self, mode: bool = True):
        super().train(mode)
        self.teacher.eval()  # JAX's teacher(images, train=False)
        return self

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        if not self.training:  # the eval step's images
            return self.student(batch)
        images, labels = (batch["image"], batch["label"]) if isinstance(batch, dict) else batch
        s_logits = self.student(images, generator=generator)
        with torch.no_grad():
            t_logits = self.teacher(images)
        ce = cross_entropy(s_logits, labels)
        if self.hard_distill:
            distill = cross_entropy(s_logits, t_logits.argmax(-1))
        else:
            T = self.temperature
            t_prob = torch.softmax(at_least_f32(t_logits) / T, dim=-1)
            s_logp = F.log_softmax(at_least_f32(s_logits) / T, dim=-1)
            distill = -(t_prob * s_logp).sum(-1).mean() * T * T
        loss = (1 - self.alpha) * ce + self.alpha * distill
        acc1 = (s_logits.argmax(-1) == labels).float().mean()
        return {"loss": loss, "ce_loss": ce, "distill_loss": distill, "acc1": acc1}
