"""Train and eval steps (counterpart of `passl_tpu/engine/steps.py:74-265`).

The JAX package compiles one step into one XLA program; here the step runs
eagerly, in the same order: micro-batch accumulation (`accum_steps`), forward
and backward at the loss scale, unscale and finite check, global-norm clip,
the lr of the state's step, the optimizer update (skipped on a non-finite
gradient when loss scaling is on), the full-model EMA, and the metrics `lr`,
`grad_norm` and the loss dict. With a criterion the model maps images to
logits (classification), or a dict of the logits and auxiliary terms whose
`*loss*` entries join the objective (V-MoE); without one (the SSL methods,
`steps.py:96-100` of the JAX package) `model(batch, generator=...)` returns the loss dict itself,
and after the optimizer step a model's `param_transforms` (`param_transforms`,
e.g. SwAV's prototypes l2-normalized) rewrite their parameters in place in
f32, then the EMA pairs (`ema_pairs`, a momentum encoder's target tower
following its online tower) move in f32 with the momentum of the step before
the increment (JAX `steps.py:178-190`). A non-finite step under loss scaling
does neither, and keeps parameters, optimizer state and buffers as they were.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.amp import GradScaler
from ..core.train_state import TrainState


def _total_loss(out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Criterion output -> (scalar objective, loss dict)."""
    if isinstance(out, dict):
        total = out["loss"] if "loss" in out else sum(v for k, v in out.items() if "loss" in k)
        return total, dict(out)
    return out, {"loss": out}


def _split(batch):
    if isinstance(batch, dict):
        return batch["image"], batch["label"]
    return batch


def _micro(x, i: int, acc: int):
    """Micro-batch i of acc of every tensor in x (a tensor, tuple, list or dict)."""
    if acc == 1:
        return x
    if isinstance(x, dict):
        return {k: _micro(v, i, acc) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_micro(v, i, acc) for v in x)
    return x.reshape(acc, -1, *x.shape[1:])[i]


def ema_momentum_schedule(cfg: Dict[str, Any], total_steps: int) -> Callable[[int], float]:
    """The target's momentum at a step (`passl_tpu/engine/steps.py:44-55`):
    with `schedule: cosine`, 1 - (1 - m) (cos(pi t / T) + 1) / 2 with t / T
    clipped to [0, 1], else m; computed in f32 as the JAX step computes it."""
    base_m = np.float32(cfg.get("momentum", 0.996))
    if cfg.get("schedule", None) != "cosine":
        return lambda step: float(base_m)
    total = np.float32(max(total_steps, 1))
    one, half, pi = np.float32(1.0), np.float32(0.5), np.float32(math.pi)

    def fn(step: int) -> float:
        t = np.clip(np.float32(step) / total, np.float32(0.0), one)
        return float(one - (one - base_m) * ((np.cos(pi * t) + one) * half))

    return fn


EmaPair = Tuple[List[torch.Tensor], List[torch.Tensor], Callable[[int], float]]


def ema_pairs_of(model: torch.nn.Module, ema_map: Sequence[tuple],
                 total_steps: int) -> List[EmaPair]:
    """[(src, dst, cfg)] submodule names -> [(src params, dst params, momentum
    fn)], the parameters paired by name; BatchNorm buffers are not paired."""
    out = []
    for src, dst, cfg in ema_map:
        s = dict(model.get_submodule(src).named_parameters())
        d = dict(model.get_submodule(dst).named_parameters())
        if set(s) != set(d):
            raise ValueError(f"EMA pair {src} -> {dst}: the towers' parameters differ: "
                             f"{sorted(set(s) ^ set(d))[:5]}")
        out.append(([s[k] for k in d], list(d.values()), ema_momentum_schedule(cfg, total_steps)))
    return out


@torch.no_grad()
def apply_ema_pairs(pairs: Sequence[EmaPair], step: int) -> None:
    """dst <- m dst + (1 - m) src for each pair, with m = its schedule at `step`."""
    for src, dst, m_fn in pairs:
        m = m_fn(step)
        torch._foreach_mul_(dst, m)
        torch._foreach_add_(dst, src, alpha=1.0 - m)


ParamTransform = Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]


def param_transforms_of(model: torch.nn.Module,
                        transforms: Sequence[tuple]) -> List[ParamTransform]:
    """A model's `param_transforms()`, [(regex, fn)] over dotted names ->
    [(parameter, fn)] for every parameter each regex matches, in order."""
    named = list(model.named_parameters())
    return [(p, fn) for pat, fn in transforms for name, p in named if re.search(pat, name)]


@torch.no_grad()
def apply_param_transforms(transforms: Sequence[ParamTransform]) -> None:
    """p <- fn(p) in place, fn taking and returning f32."""
    for p, fn in transforms:
        p.copy_(fn(p.float()))


class TrainStep:
    """`step(state, batch) -> metrics`: one optimizer step on `batch` (images
    NHWC and labels, hard or soft, or with `criterion=None` the model's own
    input, e.g. an SSL method's views), on the model's device; the
    counterpart of `make_train_step`'s step."""

    def __init__(self, lr_fn: Callable[[int], float], *, criterion: Optional[Callable],
                 grad_clip: Optional[Callable] = None, scaler: Optional[GradScaler] = None,
                 accum_steps: int = 1,
                 full_ema_decay: Optional[Callable[[int], float]] = None,
                 ema_pairs: Sequence[EmaPair] = (),
                 param_transforms: Sequence[ParamTransform] = ()):
        self.lr_fn = lr_fn
        self.criterion = criterion
        self.grad_clip = grad_clip
        self.scaler = scaler
        self.accum_steps = accum_steps
        self.full_ema_decay = full_ema_decay
        self.ema_pairs = list(ema_pairs)
        self.param_transforms = list(param_transforms)

    def _loss(self, model, batch, generator, i: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        acc = self.accum_steps
        if self.criterion is None:  # SSL: the model returns its loss dict
            return _total_loss(model(_micro(batch, i, acc), generator=generator))
        images, labels = _split(batch)
        logits = model(_micro(images, i, acc), generator=generator)
        # a model with auxiliary objectives (V-MoE's router losses) returns
        # {"logits", ...aux}: every `*loss*` entry joins the objective, the others
        # are metrics, and the logged "loss" is the total (JAX `steps.py:106-125`)
        aux = {}
        if isinstance(logits, dict):
            aux = {k: v for k, v in logits.items() if k != "logits"}
            logits = logits["logits"]
        total, loss_dict = _total_loss(self.criterion(logits, _micro(labels, i, acc)))
        for k, v in aux.items():
            if "loss" in k:
                total = total + v
            loss_dict[k] = v
        if aux:
            loss_dict["loss"] = total
        return total, loss_dict

    def forward_backward(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Gradients of the (scaled) loss into the parameters' `.grad`, summed
        over the micro-batches; returns the loss dict averaged over them."""
        model = state.model
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        scale = state.scaler_state.scale if self.scaler is not None else 1.0
        acc = self.accum_steps
        losses: Dict[str, torch.Tensor] = {}
        for i in range(acc):
            total, loss_dict = self._loss(model, batch, state.generator, i)
            (total * (scale / acc)).backward()
            for k, v in loss_dict.items():
                losses[k] = losses.get(k, 0.0) + v.detach() / acc
        for p in params:  # a parameter the loss does not reach gets a zero gradient, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return losses

    def __call__(self, state: TrainState, batch) -> Dict[str, Any]:
        # under loss scaling a non-finite step keeps the BatchNorm statistics too, as in JAX
        buffers = ([b.detach().clone() for b in state.model.buffers()]
                   if self.scaler is not None else None)
        loss_dict = self.forward_backward(state, batch)
        named = dict(state.model.named_parameters())
        grads = {name: p.grad for name, p in named.items()}

        finite = True
        if self.scaler is not None:
            finite = self.scaler.unscale_and_check(list(grads.values()), state.scaler_state)
            state.scaler_state = self.scaler.update(state.scaler_state, finite)

        grad_norm = torch.zeros(())
        if self.grad_clip is not None:
            grad_norm = self.grad_clip(grads)

        lr = self.lr_fn(state.step)
        if finite:  # a non-finite step under loss scaling keeps params and moments
            state.optimizer.step(lr, state.step)
            apply_param_transforms(self.param_transforms)
            apply_ema_pairs(self.ema_pairs, state.step)
        elif buffers:
            with torch.no_grad():
                torch._foreach_copy_(list(state.model.buffers()), buffers)

        if self.full_ema_decay is not None and state.ema_params is not None:
            d = self.full_ema_decay(state.step)
            with torch.no_grad():
                shadow = [state.ema_params[name] for name in named]
                torch._foreach_mul_(shadow, d)
                torch._foreach_add_(shadow, [p.detach() for p in named.values()], alpha=1 - d)

        metrics: Dict[str, Any] = {"lr": lr, "grad_norm": grad_norm, **loss_dict}
        if self.scaler is not None:
            metrics["loss_scale"] = state.scaler_state.scale
        state.step += 1
        return metrics


class EvalStep:
    """The eval forward to logits (the counterpart of `make_eval_step`), on the
    state's EMA shadow with `use_ema`: the host-logits path of the metrics
    other than TopkAcc (mAP)."""

    def __init__(self, *, use_ema: bool = False):
        self.use_ema = use_ema

    @torch.no_grad()
    def __call__(self, state: TrainState, images: torch.Tensor) -> torch.Tensor:
        model = state.model.eval()
        if self.use_ema:
            return torch.func.functional_call(model, state.ema_params, (images,))
        return model(images)


class EvalMetricsStep:
    """Forward plus top-k on the device (the counterpart of
    `make_eval_metrics_step`): returns the batch's sums of correct top-k
    predictions over the `valid` rows and their count, so that only scalars
    reach the host and a padded tail counts exactly. With `use_ema` the
    forward runs on the state's EMA shadow."""

    def __init__(self, topk: Sequence[int] = (1, 5), *, use_ema: bool = False):
        self.topk = tuple(topk)
        self.use_ema = use_ema

    @torch.no_grad()
    def __call__(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        if self.use_ema:
            logits = torch.func.functional_call(model, state.ema_params, (images,))
        else:
            logits = model(images)
        kk = min(max(self.topk), logits.shape[-1])
        pred = torch.sort(logits.float(), dim=-1, descending=True, stable=True).indices[:, :kk]
        correct = (pred == labels[:, None]) & valid[:, None]
        out = {f"top{k}": correct[:, :min(k, kk)].any(-1).float().sum() for k in self.topk}
        out["count"] = valid.float().sum()
        return out
