"""Train and eval steps (counterpart of `passl_tpu/engine/steps.py:74-265`).

The JAX package compiles one step into one XLA program; here the step runs
eagerly, in the same order: micro-batch accumulation (`accum_steps`), forward
and backward at the loss scale, unscale and finite check, global-norm clip,
the lr of the state's step, the optimizer update (skipped on a non-finite
gradient when loss scaling is on), the full-model EMA, and the metrics `lr`,
`grad_norm` and the loss dict. Only the criterion (classification) path is
ported; EMA pairs and `param_transforms` (the SSL methods) are not.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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


class TrainStep:
    """`step(state, batch) -> metrics`: one optimizer step on `batch`
    (images NHWC and labels, hard or soft, on the model's device); the
    counterpart of `make_train_step`'s step."""

    def __init__(self, lr_fn: Callable[[int], float], *, criterion: Callable,
                 grad_clip: Optional[Callable] = None, scaler: Optional[GradScaler] = None,
                 accum_steps: int = 1,
                 full_ema_decay: Optional[Callable[[int], float]] = None):
        self.lr_fn = lr_fn
        self.criterion = criterion
        self.grad_clip = grad_clip
        self.scaler = scaler
        self.accum_steps = accum_steps
        self.full_ema_decay = full_ema_decay

    def forward_backward(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Gradients of the (scaled) loss into the parameters' `.grad`, summed
        over the micro-batches; returns the loss dict averaged over them."""
        model = state.model
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        images, labels = _split(batch)
        scale = state.scaler_state.scale if self.scaler is not None else 1.0
        acc = self.accum_steps
        losses: Dict[str, torch.Tensor] = {}
        for i in range(acc):
            sub_x = images.reshape(acc, -1, *images.shape[1:])[i] if acc > 1 else images
            sub_y = labels.reshape(acc, -1, *labels.shape[1:])[i] if acc > 1 else labels
            total, loss_dict = _total_loss(self.criterion(model(sub_x, generator=state.generator),
                                                          sub_y))
            (total * (scale / acc)).backward()
            for k, v in loss_dict.items():
                losses[k] = losses.get(k, 0.0) + v.detach() / acc
        for p in params:  # a parameter the loss does not reach gets a zero gradient, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return losses

    def __call__(self, state: TrainState, batch) -> Dict[str, Any]:
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
