"""Training and evaluation loops (counterpart of `passl_tpu/engine/loops.py`).

`TrainingEpochLoop` resumes from `Global.checkpoint` (skipping the batches of
a partial epoch at the index level), trains epoch by epoch, stops at
`max_train_step` or on SIGTERM/SIGINT (checkpointing `latest` first), saves
`latest` and `epoch_N` every `save_interval` epochs and `best` after an eval
that improves, and logs `batch_cost`, `reader_cost`, `ips` and the peak
device memory every `print_batch_step` steps. It calls the engine's hooks
where the JAX loop does (`train_begin`, `epoch_begin`, `iter_end` after each
step, `epoch_end`, `eval_end` after each eval, `train_end`) and, with
`Global.profiler_options`, the profiler gate after every step.
`ClassificationEvaluationLoop` runs the eval set through the on-device top-k
step, or, for another metric (mAP), scores the eval step's logits on the
host, and divides by the exact count of real samples. One process: the
collectives of multi-process runs are not ported yet.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data import to_device
from ..utils import io, logger, profiler
from ..utils.misc import SmoothedValue


def _peak_mem_str(device: torch.device) -> str:
    if device.type != "cuda":
        return ""
    return f" max_mem: {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GB"


class TrainingEpochLoop:
    def __init__(self, engine):
        self.engine = engine
        self.time_info = {
            "batch_cost": SmoothedValue(window_size=engine.print_batch_step),
            "reader_cost": SmoothedValue(window_size=engine.print_batch_step),
        }
        self.best_metric = {"metric": float("-inf"), "epoch": 0, "global_step": 0}
        self.last_metrics: Optional[Dict[str, Any]] = None
        # one entry per logged step: the step, its metrics as floats, batch and reader cost
        self.history: List[Dict[str, float]] = []
        self._interrupted = False

    def log_line(self, epoch: int, step_in_epoch: int, steps_per_epoch: int,
                 metrics: Dict[str, Any]) -> None:
        e = self.engine
        m = {k: float(v) for k, v in metrics.items()}  # reading the values waits for the card
        bc, rc = self.time_info["batch_cost"], self.time_info["reader_cost"]
        ips = e.global_batch_size / max(bc.avg, 1e-9)
        eta = datetime.timedelta(seconds=int((e.total_steps - e.state.step) * bc.global_avg))
        loss_str = " ".join(f"{k}: {v:.5f}" for k, v in m.items() if k != "lr")
        logger.info(f"[Train][Epoch {epoch}/{e.epochs}][Iter: {step_in_epoch}/{steps_per_epoch}] "
                    f"lr: {m.get('lr', 0):.8f} {loss_str} batch_cost: {bc.avg:.5f}s "
                    f"reader_cost: {rc.avg:.5f}s ips: {ips:.2f} imgs/s eta: {eta}"
                    f"{_peak_mem_str(e.device)}")
        self.history.append({"step": e.state.step, **m, "batch_cost": bc.deque[-1],
                             "reader_cost": rc.deque[-1]})

    def run(self) -> None:
        e = self.engine
        start_epoch, skip_steps = 1, 0
        if e.checkpoint_path:
            io.load_checkpoint(e.checkpoint_path, e.state, e.device)
            spe = max(e.steps_per_epoch, 1)
            start_epoch, skip_steps = e.state.step // spe + 1, e.state.step % spe
            if skip_steps:
                logger.info(f"mid-epoch resume: skipping {skip_steps} already-trained batches "
                            f"of epoch {start_epoch}")
        self._interrupted = False
        old_handlers = self._install_signal_handlers() if e.save_on_interrupt else {}
        try:
            e.hooks.call("train_begin", e)
            self._run_epochs(start_epoch, skip_steps)
            e.hooks.call("train_end", e)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _install_signal_handlers(self) -> dict:
        old = {}
        owner = os.getpid()

        def on_signal(signum, frame):
            if os.getpid() != owner:  # a loader worker forked while this was installed
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
                return
            if self._interrupted:  # a second signal: the step boundary is not coming
                signal.signal(signum, old.get(signum, signal.SIG_DFL))
                raise KeyboardInterrupt
            self._interrupted = True
            logger.warning(f"signal {signum}: checkpointing and exiting at the next step "
                           "boundary (repeat to force)")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                break
        return old

    def _run_epochs(self, start_epoch: int, skip_steps: int) -> None:
        e = self.engine
        for epoch in range(start_epoch, e.epochs + 1):
            e.train_dataloader.set_epoch(epoch)
            e.hooks.call("epoch_begin", e, epoch)
            stop = self.train_one_epoch(epoch, skip_steps=skip_steps)
            skip_steps = 0
            e.hooks.call("epoch_end", e, epoch)
            if e.eval_during_train and e.eval_unit == "epoch" and epoch % e.eval_interval == 0:
                self._run_eval(epoch)
            if stop or (e.save_interval > 0 and epoch % e.save_interval == 0):
                io.save_checkpoint(e.state, e.output_dir, prefix="latest",
                                   max_num_checkpoint=e.max_num_checkpoint)
                if not stop:
                    io.save_checkpoint(e.state, e.output_dir, prefix=f"epoch_{epoch}",
                                       max_num_checkpoint=e.max_num_checkpoint)
            if stop:
                logger.info("interrupted: checkpoint saved, exiting for resume" if self._interrupted
                            else f"reached max_train_step {e.max_train_step}, stopping")
                return
        # all epochs done: a final latest even when save_interval skipped the last epoch
        if e.epochs >= start_epoch and (e.save_interval <= 0 or e.epochs % e.save_interval != 0):
            io.save_checkpoint(e.state, e.output_dir, prefix="latest",
                               max_num_checkpoint=e.max_num_checkpoint)

    def train_one_epoch(self, epoch: int, skip_steps: int = 0) -> bool:
        e = self.engine
        for v in self.time_info.values():
            v.reset()
        steps_per_epoch = len(e.train_dataloader)
        if skip_steps:
            e.train_dataloader.set_skip(skip_steps)
        metrics = None
        tic = time.perf_counter()
        # closing the iterator on an early return stops and joins the loader's prefetch thread
        with contextlib.closing(iter(e.train_dataloader)) as batches:
            for i, batch in enumerate(batches, start=skip_steps):
                self.time_info["reader_cost"].update(time.perf_counter() - tic)
                metrics = e.train_step(e.state, to_device(e.prepare_batch(batch), e.device))
                if (i + 1) % e.print_batch_step == 0:
                    # the log line reads the metrics, which waits for the step to finish
                    m = {k: float(v) for k, v in metrics.items()}
                    self.time_info["batch_cost"].update(time.perf_counter() - tic)
                    self.log_line(epoch, i + 1, steps_per_epoch, m)
                else:
                    self.time_info["batch_cost"].update(time.perf_counter() - tic)
                tic = time.perf_counter()
                global_step = (epoch - 1) * steps_per_epoch + i + 1
                e.hooks.call("iter_end", e, global_step, metrics)
                if e.profiler_options:
                    profiler.add_profiler_step(e.profiler_options, global_step)
                if e.eval_during_train and e.eval_unit == "step" and global_step % e.eval_interval == 0:
                    self._run_eval(epoch)
                if self._interrupted or (e.max_train_step and global_step >= e.max_train_step):
                    self.last_metrics = metrics
                    return True
        self.last_metrics = metrics
        return False

    def _run_eval(self, epoch: int) -> None:
        e = self.engine
        if e.eval_loop is None:
            return
        metric = e.eval_loop.run()
        e.hooks.call("eval_end", e, metric)
        if metric is not None and metric > self.best_metric["metric"]:
            self.best_metric.update(metric=metric, epoch=epoch, global_step=e.state.step)
            io.save_checkpoint(e.state, e.output_dir, prefix="best",
                               max_num_checkpoint=e.max_num_checkpoint, metrics={"metric": metric})
        logger.info(f"[Eval][Epoch {epoch}] best metric: {self.best_metric['metric']:.5f} "
                    f"(epoch {self.best_metric['epoch']})")


class ClassificationTrainingEpochLoop(TrainingEpochLoop):
    """The criterion-driven loop: the engine builds its step with the criterion."""


class ContrastiveLearningTrainingEpochLoop(TrainingEpochLoop):
    """The label-free loop: the model returns its loss dict; the views go to
    the device as they come from the loader (uint8 NHWC)."""


class SimSiamTrainingEpochLoop(ContrastiveLearningTrainingEpochLoop):
    """The JAX package's alias: its param-group optimizer needs no loop of its own."""


class ClassificationEvaluationLoop:
    """The metrics over the eval set, divided by the count of real samples (a
    ragged tail batch is padded to the batch size and masked out): TopkAcc as
    per-batch sums on the device; another metric (mAP) on the host, over each
    batch's logits of real samples, weighted by their count (JAX
    `loops.py:345-408`, one process)."""

    def __init__(self, engine):
        self.engine = engine
        self.last_metrics: Optional[Dict[str, float]] = None

    def run(self) -> Optional[float]:
        e = self.engine
        if e.eval_dataloader is None:
            return None
        n_total = len(e.eval_dataloader.dataset)
        seen, denom, full_bs = 0, 0, None
        sums: Dict[str, float] = {}
        tic = time.perf_counter()
        with contextlib.closing(iter(e.eval_dataloader)) as batches:
            for batch in batches:
                images, labels = batch if not isinstance(batch, dict) else (batch["image"], batch["label"])
                images, labels = np.asarray(images), np.asarray(labels)
                bs = len(labels)
                if seen >= n_total:
                    break
                take = min(bs, n_total - seen)
                full_bs = full_bs or bs
                if bs < full_bs:  # ragged tail: pad to the steady batch size, mask the pad
                    pad = full_bs - bs
                    images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)])
                    labels = np.concatenate([labels, np.repeat(labels[-1:], pad, axis=0)])
                valid = np.zeros(full_bs, dtype=bool)
                valid[:take] = True
                if e.eval_metrics_step is not None:
                    self._device_sums(sums, images, labels, valid)
                else:
                    self._host_sums(sums, images, labels, take)
                    denom += take
                seen += take
        if e.eval_metrics_step is not None:
            denom = sums.pop("count", 0.0)
        if denom == 0:
            return None
        avg = {k: v / denom for k, v in sums.items()}
        cost = time.perf_counter() - tic
        logger.info("[Eval] " + " ".join(f"{k}: {v:.5f}" for k, v in avg.items())
                    + f" ({int(denom)} samples, {cost:.1f}s, {denom / cost:.1f} imgs/s)")
        self.last_metrics = avg
        return avg["top1" if "top1" in avg else next(iter(avg))]

    def _device_sums(self, sums: Dict[str, float], images, labels, valid) -> None:
        """TopkAcc's sums of one batch and its count of real samples, on the device."""
        e = self.engine
        gi, gl, gv = to_device((images, labels.astype(np.int64), valid), e.device)
        for suffix, step in (("", e.eval_metrics_step), ("_ema", e.eval_metrics_step_ema)):
            if step is None:
                continue
            out = step(e.state, gi, gl, gv)
            count = float(out.pop("count"))
            if not suffix:
                sums["count"] = sums.get("count", 0.0) + count
            for k, v in out.items():
                sums[k + suffix] = sums.get(k + suffix, 0.0) + float(v)

    def _host_sums(self, sums: Dict[str, float], images, labels, take: int) -> None:
        """Each metric of one batch's first `take` rows, scored on the host over
        the eval step's logits (and the EMA shadow's), times `take`."""
        e = self.engine
        if take == 0:
            return
        gi = to_device(images, e.device)
        lab = torch.from_numpy(np.asarray(labels[:take]))
        for suffix, step in (("", e.eval_step), ("_ema", e.eval_step_ema)):
            if step is None:
                continue
            logits = step(e.state, gi)[:take].float().cpu()
            for metric in e.metric_fns:
                for k, v in metric(logits, lab).items():
                    sums[k + suffix] = sums.get(k + suffix, 0.0) + float(v) * take


LOOPS = {
    "TrainingEpochLoop": TrainingEpochLoop,
    "ClassificationTrainingEpochLoop": ClassificationTrainingEpochLoop,
    "ContrastiveLearningTrainingEpochLoop": ContrastiveLearningTrainingEpochLoop,
    "SimSiamTrainingEpochLoop": SimSiamTrainingEpochLoop,
    "ClassificationEvaluationLoop": ClassificationEvaluationLoop,
}
