"""Engine: the config-driven trainer (counterpart of
`passl_tpu/engine/engine.py:137-542`, train and eval modes).

From the same YAML blocks as the JAX engine (Global, FP16, Model, Loss,
Metric, LRScheduler, Optimizer, DataLoader, EMA) it builds, on an explicit
device: the seeded data loaders, the loss and metrics, the precision policy
and loss scaler, the model (initialised from `Global.seed` by
`nn.init.init_module`, or loaded from `Global.pretrained_model`, a torch
state_dict file), the param-group optimizer, the lr schedule and the
gradient clip, the train state, the train and eval steps, and the loops.

Without a `Loss` block (the SSL methods) the model returns its loss dict,
the loop is `ContrastiveLearningTrainingEpochLoop`, and a model's `ema_map`
and `frozen_patterns` are honoured as in the JAX engine (`engine.py:302-388`):
each EMA target tower starts as a copy of its online tower before the
optimizer is built (and, after `Global.pretrained_model`, takes from the
online tower only what the file did not fill), the frozen patterns go to the
optimizer, and the train step moves each target after the optimizer step.
`Global.pretrained_model` loads as the JAX loader does: missing entries and
shape mismatches keep the init, a `pos_embed` of another grid is resized,
keys the model lacks are ignored.

The loaders' worker pools fork in `__init__`, before the model moves to its
device, so no worker is forked from a process that holds a CUDA context.

Not ported yet, and refused when the config asks for them: meshes and
sharding (`DistributedStrategy` degrees above 1, `recompute`), a
`torch.distributed` world of more than one process (nothing reduces the
gradients yet),
`param_transforms` and `optimizer_overrides` (SwAV, DINO and others), hooks
and the profiler.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict, Union

import numpy as np
import torch

from ..core.amp import GradScaler, Policy
from ..core.grad_clip import ClipGradByGlobalNorm
from ..core.train_state import TrainState
from ..data import build_dataloader
from ..loss import build_loss
from ..metrics import TopkAcc, build_metrics
from ..models import build_model
from ..nn.init import init_module
from ..optimizer import build_optimizer
from ..scheduler import build_lr_scheduler
from ..utils import io, logger
from . import loops as loops_mod
from .steps import EvalMetricsStep, TrainStep, ema_pairs_of

_PARALLEL_KEYS = ("tensor_parallel", "mp_degree", "sharding", "sharding_degree", "fsdp_degree",
                  "pipeline_parallel", "pp_degree", "pipeline")


def _refuse_unported(config: Dict[str, Any]) -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        # build_dataloader would give each rank its share of the batch, and
        # nothing would reduce the gradients: each rank would train its own replica
        raise NotImplementedError(
            f"a torch.distributed world of {dist.get_world_size()} processes: data "
            "parallelism is not ported yet, and the port does not reduce gradients "
            "across processes (no all_reduce, no DDP)")
    ds = dict(config.get("DistributedStrategy", {}) or {})
    for key in _PARALLEL_KEYS:
        v = ds.get(key)
        degree = v.get("degree") if isinstance(v, dict) else v
        if degree and int(degree) > 1:
            raise NotImplementedError(f"DistributedStrategy.{key}={v}: model and pipeline "
                                      "parallelism are not ported yet")
    if ds.get("recompute"):
        raise NotImplementedError("DistributedStrategy.recompute is not ported yet")
    g = config.get("Global", {})
    for key in ("hooks", "profiler_options"):
        if g.get(key):
            raise NotImplementedError(f"Global.{key} is not ported yet")


def _device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine: device is cuda but torch.cuda.is_available() is False")
    return device


class Engine:
    def __init__(self, config: Dict[str, Any], mode: str = "train",
                 device: Union[str, torch.device] = "cuda"):
        if mode not in ("train", "eval"):
            raise ValueError(f"Engine mode {mode!r}: the port has train and eval")
        _refuse_unported(config)
        self.config = config
        self.mode = mode
        self.device = _device(device)
        g = config.get("Global", {})

        self.output_dir = g.get("output_dir", "./output")
        os.makedirs(self.output_dir, exist_ok=True)
        logger.init_logger(os.path.join(self.output_dir, f"{mode}.log"))
        self.print_batch_step = int(g.get("print_batch_step", 10))
        self.save_interval = int(g.get("save_interval", 1))
        self.max_num_checkpoint = int(g.get("max_num_latest_checkpoint", 3))
        self.eval_during_train = bool(g.get("eval_during_train", False))
        self.eval_interval = int(g.get("eval_interval", 1))
        self.eval_unit = g.get("eval_unit", "epoch")
        self.epochs = int(g.get("epochs", 1))
        self.accum_steps = int(g.get("accum_steps", 1))
        self.max_train_step = g.get("max_train_step", None)
        self.checkpoint_path = g.get("checkpoint", None)
        self.save_on_interrupt = bool(g.get("save_on_interrupt", True))
        self.pretrained_model = g.get("pretrained_model", None)
        self.pretrained_report = None  # what Global.pretrained_model filled (`_load_pretrained`)
        self.seed = int(g.get("seed", 42))
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        random.seed(self.seed + rank)  # ambient RNGs; the loader keys its own per sample
        np.random.seed((self.seed + rank) % 2**31)

        # ---- data
        dl_cfg = config.get("DataLoader", {})
        self.train_dataloader = self.eval_dataloader = None
        self.global_batch_size = 256
        if mode == "train" and "Train" in dl_cfg:
            self.train_dataloader = build_dataloader(dl_cfg["Train"], "Train", seed=self.seed)
            self.global_batch_size = dl_cfg["Train"]["sampler"].get("batch_size", 128)
        if "Eval" in dl_cfg:
            self.eval_dataloader = build_dataloader(dl_cfg["Eval"], "Eval", seed=self.seed)
            if mode != "train":
                self.global_batch_size = dl_cfg["Eval"]["sampler"].get("batch_size", 128)
        for loader in (self.train_dataloader, self.eval_dataloader):
            if loader is not None:  # fork the workers now, before the model goes to the card
                loader._get_pool()
        self.steps_per_epoch = len(self.train_dataloader) if self.train_dataloader else 0
        self.total_steps = self.steps_per_epoch * self.epochs

        # ---- loss and metrics
        self.criterion = build_loss(config.get("Loss", {}).get("Train")) if config.get("Loss") else None
        metric_cfg = config.get("Metric", {})
        self.metric_fns = (build_metrics(metric_cfg.get("Eval") or metric_cfg.get("Train"))
                           if metric_cfg else [])
        if not self.metric_fns and self.eval_dataloader is not None:
            self.metric_fns = [TopkAcc()]
        if not all(isinstance(m, TopkAcc) for m in self.metric_fns):
            raise NotImplementedError("the port evaluates TopkAcc metrics only")

        # ---- precision
        fp16_cfg = config.get("FP16", None)
        self.policy = Policy.from_config(fp16_cfg)
        self.scaler = None
        if self.policy.use_loss_scaling:
            sc = (fp16_cfg or {}).get("GradScaler", {})
            self.scaler = GradScaler(**{k: v for k, v in sc.items()
                                        if k in GradScaler.__dataclass_fields__})

        # ---- model: fresh from the seed, then the pretrained weights if any
        model_cfg = dict(config.get("Model", {}))
        if "dtype" not in model_cfg and self.policy.compute_dtype != torch.float32:
            model_cfg["dtype"] = self.policy.compute_dtype
        self.model = build_model(model_cfg)
        for hook in ("param_transforms", "optimizer_overrides"):
            if hasattr(self.model, hook):
                raise NotImplementedError(f"model {model_cfg.get('name')} has {hook}, which the "
                                          "port's engine does not handle yet")
        ema_map = list(self.model.ema_map()) if hasattr(self.model, "ema_map") else []
        init_module(self.model, torch.Generator().manual_seed(self.seed))
        for src, dst, _ in ema_map:  # each target starts as its online tower (JAX :319-322)
            self.model.get_submodule(dst).load_state_dict(
                self.model.get_submodule(src).state_dict())
        if self.pretrained_model:
            self._load_pretrained(ema_map)
        self.model.to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info(f"model {model_cfg.get('name')}: {n_params / 1e6:.2f}M params, "
                    f"compute dtype {self.policy.compute_dtype}, device {self.device}")

        # ---- optimizer, schedule, clip
        opt_cfg = dict(config.get("Optimizer", {}) or {"name": "Momentum"})
        lrs_cfg = dict(config.get("LRScheduler", {}) or {"name": "Constant", "learning_rate": 0.0})
        spe = max(self.steps_per_epoch, 1)
        self.lr_fn = build_lr_scheduler(lrs_cfg, self.epochs, spe, self.global_batch_size)
        grad_clip_cfg = opt_cfg.pop("grad_clip", None)
        self.grad_clip = None
        if grad_clip_cfg:
            self.grad_clip = ClipGradByGlobalNorm(**{k: v for k, v in grad_clip_cfg.items()
                                                     if k != "name"})
        num_layers = int(model_cfg.get("depth", 0) or len(getattr(self.model, "blocks", ())))
        if num_layers == 0 and (opt_cfg.get("layerwise_decay") or 0):
            logger.warning("Optimizer.layerwise_decay is set but the model depth is unknown "
                           "(num_layers=0): layer decay is a no-op")
        frozen = list(self.model.frozen_patterns()) if hasattr(self.model, "frozen_patterns") else []
        self.optimizer = build_optimizer(opt_cfg, dict(self.model.named_parameters()),
                                         frozen_patterns=frozen, num_layers=num_layers,
                                         lr_args=(self.epochs, spe, self.global_batch_size))
        logger.info(f"optimizer groups: {self.optimizer.describe()}")

        # ---- full-model EMA
        ema_cfg = config.get("EMA", None)
        self.full_ema_decay = None
        if ema_cfg:
            decay, thres = float(ema_cfg["decay"]), int(ema_cfg.get("thres_steps", 0))
            self.full_ema_decay = lambda step: 0.0 if step < thres else decay

        # ---- state (the DropPath generator is seeded apart from the init's)
        generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        ema = ({n: p.detach().clone() for n, p in self.model.named_parameters()}
               if self.full_ema_decay else None)
        self.state = TrainState(self.model, self.optimizer, generator,
                                scaler_state=self.scaler.init() if self.scaler else None,
                                ema_params=ema)

        # ---- steps and loops
        self.train_step = None
        if mode == "train":
            self.train_step = TrainStep(self.lr_fn, criterion=self.criterion,
                                        grad_clip=self.grad_clip, scaler=self.scaler,
                                        accum_steps=self.accum_steps,
                                        full_ema_decay=self.full_ema_decay,
                                        ema_pairs=ema_pairs_of(self.model, ema_map,
                                                               self.total_steps))
        topk = sorted({k for m in self.metric_fns for k in m.topk}) or [1]
        self.eval_metrics_step = EvalMetricsStep(topk)
        self.eval_metrics_step_ema = (EvalMetricsStep(topk, use_ema=True)
                                      if self.full_ema_decay else None)
        loop_name = g.get("train_loop", None) or (
            "ClassificationTrainingEpochLoop" if self.criterion is not None
            else "ContrastiveLearningTrainingEpochLoop")
        if loop_name not in loops_mod.LOOPS:
            raise NotImplementedError(f"train loop {loop_name!r} is not ported yet")
        self.train_loop = loops_mod.LOOPS[loop_name](self) if mode == "train" else None
        self.eval_loop = (loops_mod.ClassificationEvaluationLoop(self)
                          if self.eval_dataloader is not None else None)

    def _load_pretrained(self, ema_map: list) -> None:
        """`Global.pretrained_model` (a torch state_dict file) into the model
        with the JAX loader's tolerance (`utils.io.load_pretrained`); the
        report of what the file filled stays as `pretrained_report`. An EMA
        target tower keeps what the file filled and takes from its online
        tower what it did not (JAX `engine.py:340-381`)."""
        report = io.load_pretrained(self.model, self.pretrained_model)
        self.pretrained_report = report
        loaded = report["loaded"]
        for src, dst, _ in ema_map:
            dst_state = self.model.get_submodule(dst).state_dict()
            missing = [k for k in dst_state if f"{dst}.{k}" not in loaded]
            if not missing:
                logger.info(f"pretrained file fully covers EMA tower '{dst}': keeping its "
                            f"loaded weights (no re-sync from '{src}')")
                continue
            src_state = self.model.get_submodule(src).state_dict()
            orphans = [k for k in missing if k not in src_state]
            if orphans:
                logger.warning(f"EMA tower '{dst}': {len(orphans)} entries are in neither the "
                               f"pretrained file nor online tower '{src}' and stay at fresh "
                               f"init: {orphans[:5]}")
            fill = {k: src_state[k] for k in missing if k in src_state}
            logger.info(f"pretrained file covers {len(dst_state) - len(missing)}/{len(dst_state)} "
                        f"entries of EMA tower '{dst}': re-syncing the {len(fill)} uncovered "
                        f"from '{src}'")
            self.model.get_submodule(dst).load_state_dict(fill, strict=False)

    def prepare_batch(self, batch):
        """A loader batch as the train step takes it: the SSL loops strip the
        label of ((view1, view2), label) batches (JAX `engine.py:511-518`)."""
        if (self.criterion is None and isinstance(batch, (tuple, list)) and len(batch) == 2
                and isinstance(batch[0], (tuple, list)) and getattr(batch[1], "ndim", 2) <= 1):
            return batch[0]
        return batch

    def train(self) -> None:
        if self.mode != "train":
            raise RuntimeError("Engine.train needs mode='train'")
        logger.info(f"start training: {self.epochs} epochs x {self.steps_per_epoch} steps, "
                    f"global batch {self.global_batch_size}, device {self.device}")
        try:
            self.train_loop.run()
        finally:
            self.close()

    def eval(self):
        if self.checkpoint_path:
            io.load_checkpoint(self.checkpoint_path, self.state, self.device)
        try:
            return self.eval_loop.run()
        finally:
            self.close()

    def close(self) -> None:
        """Stop the loaders' worker processes."""
        for loader in (self.train_dataloader, self.eval_dataloader):
            if loader is not None:
                loader.close()
