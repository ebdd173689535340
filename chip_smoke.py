"""Smoke run of the PyTorch port (`passl_tpu_torch`) on one NVIDIA GPU.

Run from the repo root:  python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from passl_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc per source, side by side.
3. Holds the talking-heads forward against its plain PyTorch version on the
   card at the shapes CaiT uses, through whichever of its two kernels the C
   entry point picks (warp-row for bf16 / f16 with h <= 8 and k <= 256,
   block-row otherwise), checks that two launches are bitwise equal, logs
   the warp-row kernel's registers, shared memory, blocks an SM and spills,
   times kernel and plain version at CaiT-S24's shapes and, for the record
   of its next step, the kernel alone at cait_s24_384's [16, 8, 576, 576].
   Every other timed kernel
   is timed in turns with its plain version and, where one PyTorch call
   computes the same function, that call (`library_ms`), and set against its
   bound: the larger of its bytes (each input read once, each output
   written once) over 3.35 TB/s and its products' flops over the card's
   peak for the inputs' type (989 TFLOP/s bf16/f16, 67 TFLOP/s f32).
4. Holds the talking-heads backward against its plain version at the same
   shapes (ds, dproj_l, dproj_w), through whichever of its two kernels the C
   entry point picks (the warp-row kernel for bf16 / f16 with h <= 8 and
   k <= 256, the block-row kernel otherwise; both run here), checks that two
   launches give bitwise equal weight gradients, times both at CaiT-S24's
   shapes, and logs the warp-row kernel's registers, shared memory, blocks an
   SM and spills there.
5. Holds the window-attention forward kernel against its plain version at
   Swin-T's four stage shapes (serving batch 32, training batch 128), with no
   mask, one mask for every group, d = 59 and 64, and Swin-B's head counts,
   in bf16 and f32, and times both at each of Swin-T's four stage shapes with
   128 images in bf16 (stage 1 in f32 too), and the stages weighted by their
   blocks as one training step's time in the kernel.
6. The same for the window-attention backward kernel (dq, dk, dv, and dbias
   within 1e-4 of its largest entry), checking that two launches are bitwise
   equal. Both window phases time F.scaled_dot_product_attention beside the
   kernels, with q as [B/nWm, nWm, h, L, d] and bias + mask as a float
   attn_mask [nWm, h, L, L] (bias alone at stage 4, which has no mask).
6b. Holds the flash-attention forward kernel (out, m, l) and its dK/dV and
   dQ backward kernels against their plain versions at the ViT family's
   shapes (ViT-B/16 at 32 and 128 images in bf16 and f32, ViT-B/32, ViT-B/16
   at 384, ViT-L/16, ViT-H/14, ViT-g/14, MoCo v3 ViT-S, 65 tokens, 4,096
   tokens, one f16 case), with q, k, v read as views of one qkv tensor as
   the model hands them, logs the tensor-core kernels' registers, shared
   memory and blocks an SM, checks that all three kernels are bitwise the
   same on a second launch, and times them at ViT-B/16's 128 images against
   their plain versions and F.scaled_dot_product_attention (forward;
   backward; forward + backward through autograd).
7. Serves CaiT-S24 at 224 through the user's entry points: the export CLI's
   `main` on configs/classification/cait_s24_224_in1k.yaml (random weights
   from Global.seed), then `Predictor(device="cuda")` answering 4 requests of
   32 images. Checks that every self-attention block went through the kernel,
   that the logits are finite, and that they agree with the same weights
   served through the plain version (th_impl=einsum), in bf16 and in f32.
   Prints each path's request latency, its split into preprocess / predict /
   postprocess, and a torch.profiler view of one more request (device busy
   time, idle share, the kernels that take the most device time).
8. Serves Swin-T at 224 the same way from
   configs/classification/swin_tiny_patch4_window7_224_in1k.yaml with
   Model.attn_impl=fused: 12 window-attention launches per forward, finite
   logits, top-5; and against the same weights through the einsum path in
   the config's bf16, at softmax_dtype=float32, and in f32.
9. Trains CaiT-S24 at 224, full width and depth, bf16, through
   `Engine(config, mode="train", device="cuda").train()` as tools/train does,
   on the same config with synthetic images in place of ImageNet (the
   config's own transforms, RepeatedAugSampler and Mixup/Cutmix), batch 64,
   8 steps. Checks: the first step's per-parameter gradients of the kernel
   path against the plain path (th_impl=einsum) from the same seed and batch;
   every loss finite; 24 forward and 24 backward kernel launches per step;
   the checkpoint resumes with its step, through the engine's loader with 2
   workers and no prefetch thread left after it; the eval loop gives top-1
   and top-5 over 256 images. Prints both paths' step time, images/s, reader-cost
   share and peak memory, and a torch.profiler view of one step of each.
10. Trains Swin-T at 224 the same way, full width and depth, bf16, batch 128
   (the recipe's per-card batch), 8 steps, with Model.attn_impl=fused: 12
   forward and 12 backward launches per step, first-step gradients against
   the einsum path at softmax_dtype=float32 (overall and for each of the 12
   relative_position_bias_tables), resume, eval; and the device busy time of
   one profiled step on the fused path and on the einsum path.
11. Serves ViT-B/16 at 224 from configs/classification/vit_base_patch16_224_in1k.yaml
   with Model.attn_impl=flash as Swin-T is served: 12 flash forward
   launches per forward, and the same weights through the einsum path in
   bf16 (cosine >= 0.999), at softmax_dtype=float32 (>= 0.9999) and in f32.
12. Trains ViT-B/16 at 224 the same way, full width and depth, bf16, batch
   128 (4,096 over the 32 cards of the recipe), drop path 0.1 and EMA, 8
   steps, with Model.attn_impl=flash: 12 forward, 12 dK/dV and 12 dQ
   launches per step, first-step gradients against the einsum path at
   softmax_dtype=float32 (overall and for each of the 12 attn.qkv.weight),
   resume, eval.
13. Holds the fused augmentation kernels (`fused_augment`, BYOL's device
   recipe in one pass; the fast kernel for its compiled radii and channel
   counts, the generic kernel for the rest) against their plain version on
   the same draws, at BYOL's views [128, 224, 224, 3] with view 1's settings
   (blur 1.0, solarize 0.0) and view 2's (blur 0.1, solarize 0.2),
   [256, 32, 32, 3], a non-square [8, 160, 224, 3], [4, 16, 16, 3] at 23
   taps (every position an edge), one channel, taps 1, 3, 4 and 25, an image
   lower than the radius with an odd row width, a misaligned contiguous view,
   one channel at a compiled radius, two channels (generic) and the widest
   row the generic kernel takes, with deterministic and random settings:
   every entry within one bf16 ulp, the share of bitwise equal entries and
   the kernel printed, two launches bitwise equal, identical images with
   other draws different, and at 4,096 images the blur and solarize rates
   within 4 sigma of their probabilities. Logs the fast kernel's registers,
   shared memory, blocks an SM and spills at BYOL's shape. Its path is its
   own op (the JAX package calls it from no model): the op's entry point on
   BYOL's two views is the path whose launches are counted. Times it at
   both views from a replayed CUDA graph (the loop's reading beside it)
   against its plain version, and, as context only, the port's plain
   `byol_device_augment` on two such views.
14. Trains BYOL ResNet-50 at 224, full width and depth, through
   `Engine(config, mode="train", device="cuda").train()` on
   configs/byol/byol_r50_in1k.yaml with synthetic images in place of
   ImageNet (the config's own two-view transforms), batch 128 per view, bf16,
   use_device_augment, MomentumLARS and the cosine EMA, 8 steps. Checks:
   every loss finite and in [0, 8]; after every step each target parameter
   is m(t) target + (1 - m(t)) online in f32; the target has no optimizer
   state; the BatchNorm statistics of both towers moved; the checkpoint
   resumes at its step; and the first step's loss and gradients on the card
   against the same step on the CPU from the same init and batch, in f32 and
   in f64 (4 pairs, no device augmentation), beside f32 against f64 on the
   CPU as the yardstick of f32's rounding. Prints step time, pairs/s and
   views/s, reader share, peak memory, and device busy, idle share and top
   kernels of one profiled step.
15. Trains SimCLR ResNet-50 the same way on configs/simclr/simclr_r50_in1k.yaml:
   128 pairs, bf16, use_device_augment at jitter strength 1.0, MomentumLARS
   and simclrCosineWarmup, 8 steps. Checks: every loss finite and every acc1
   in [0, 1]; the BatchNorm statistics of the backbone and the neck moved;
   resume; the first step card vs CPU (4 pairs, no device augmentation) in
   f32 and f64 with BYOL's limits; and the plain `simclr_device_augment_core`
   on the card against the CPU on the same draws at [128, 224, 224, 3]
   within 1e-5 of the views' largest magnitude.
16. Trains MoCo v2 ResNet-50 the same way on configs/moco/mocov2_r50_in1k.yaml:
   the config's batch of 256 in 8 BatchNorm splits, K = 65,536, Momentum
   SGD, bf16, 8 steps. Checks: after every step each encoder_k parameter is
   0.999 k + 0.001 q in f32, queue_ptr is 256 t mod 65,536, the 256 keys
   written are unit-norm and every column not yet written holds its init
   bitwise; encoder_k has no optimizer state; both encoders' BatchNorm
   statistics moved; every loss finite and every acc1 in [0, 1]; the resumed
   engine starts from the checkpoint's queue and pointer bitwise; the first
   step card vs CPU at 16 images (2 a split) with one permutation handed to
   both devices, in f32 and f64.
17. Prints the card line, a JSON line of the eight kernels' results, and
   last the contract line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero; it prints no result line
then. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from passl_tpu_torch.data import build_dataloader, to_device
from passl_tpu_torch.data.loader import PREFETCH_THREAD
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.ops import _build
from passl_tpu_torch.models import moco
from passl_tpu_torch.nn.norm import SplitBatchNorm
from passl_tpu_torch.ops.augment import (byol_device_augment, simclr_device_augment_core,
                                         simclr_draws)
from passl_tpu_torch.ops.augment_kernel import (fused_augment, fused_augment_draws,
                                                fused_augment_kernel_for, fused_augment_ref,
                                                fused_augment_resources,
                                                fused_augment_with_draws)
from passl_tpu_torch.ops.attention import (flash_attention, flash_attention_di,
                                           flash_attention_dkv, flash_attention_dkv_ref,
                                           flash_attention_dq, flash_attention_dq_ref,
                                           flash_attention_fwd, flash_attention_fwd_ref,
                                           flash_kernel_resources)
from passl_tpu_torch.ops.talking_heads import (talking_heads_bwd_kernel_for,
                                               talking_heads_bwd_resources,
                                               talking_heads_fwd_kernel_for,
                                               talking_heads_fwd_resources,
                                               talking_heads_softmax, talking_heads_softmax_bwd,
                                               talking_heads_softmax_bwd_ref,
                                               talking_heads_softmax_ref)
from passl_tpu_torch.ops.window_attention import (fused_window_attention,
                                                  fused_window_attention_bwd,
                                                  window_attention_bwd_ref, window_attention_ref)
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.cuda_timing import graph_ms, loop_ms

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "classification", "cait_s24_224_in1k.yaml")
MODEL_NAME = "cait_s24_224"
DEPTH = 24  # talking-heads blocks of CaiT-S24: one kernel launch each per forward
SWIN_CONFIG = os.path.join(REPO, "configs", "classification",
                           "swin_tiny_patch4_window7_224_in1k.yaml")
SWIN_NAME = "swin_tiny_patch4_window7_224"
SWIN_BLOCKS = 12  # Swin-T's window-attention blocks: one kernel launch each per forward
BATCH, REQUESTS = 32, 4
IMG, NUM_CLASSES = 224, 1000
NORMALIZE = [{"NormalizeImage": {"scale": 1.0 / 255, "mean": [0.485, 0.456, 0.406],
                                 "std": [0.229, 0.224, 0.225]}}]
# kernel vs plain version. f32: both sum the same f32 terms in another
# order. bf16/f16: both round the same f32 value once, so they differ by at
# most one unit in the last place of the stored type (bf16 2^-8 relative, as
# in tests/test_talking_heads_kernel.py; f16 2^-11, doubled).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
# the talking-heads forward (atol, rtol): its outputs are probabilities mixed
# over heads, about 1/k each, below TOL's atol. One ulp of the stored type is
# at most 2^-7 of the value in bf16 and 2^-10 in f16; the two f32 values
# before that rounding (__expf against expf, sums in another order) differ by
# under 1e-5, for which atol leaves ten times room. f32 as TOL.
FWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 2**-7),
           torch.float16: (1e-4, 2**-10)}
# (shape, dtype): CaiT-S24 at 224 (h=8, q=k=196) at batch 64 and at the
# serving batch of 32; the small (2, 4, 49, 49); cait_xs24_384's 6 heads over
# 576 tokens in f16; cait_m36/m48's 16 heads over the longest rows (784).
CASES = [
    ((64, 8, 196, 196), torch.bfloat16),
    ((64, 8, 196, 196), torch.float32),
    ((BATCH, 8, 196, 196), torch.bfloat16),
    ((2, 4, 49, 49), torch.float32),
    ((2, 4, 49, 49), torch.bfloat16),
    ((4, 6, 576, 576), torch.float16),
    ((2, 16, 784, 784), torch.bfloat16),
]
LONG_ROW_CASE = (16, 8, 576, 576)  # cait_s24_384's scores at 16 images: timed alone, bf16
SERVE_CASE = ((BATCH, 8, 196, 196), torch.bfloat16)  # what the serving path hands the kernel
TRAIN_BATCH, TRAIN_STEPS = 64, 8
TRAIN_CASE = ((TRAIN_BATCH, 8, 196, 196), torch.bfloat16)  # what the train step hands both kernels
SWIN_TRAIN_BATCH = 128  # the recipe's per-card batch: 1,024 over 8 cards
# window attention (B, h, L, d, nWm): Swin-T's stages 1-4 at 128 and at 32
# images (stage i packs 2 windows into L = 98 and cycles nWm = 32, 8, 2 masks;
# stage 4's window covers its map: L = 49, no mask); one mask for every
# group; swin_huge's d = 59 and swin_giant's d = 64 (2 images, stage 1);
# Swin-B's 4 and 32 heads (stages 1 and 4, 32 images)
WATTN_SHAPES = [
    (4096, 3, 98, 32, 32), (1024, 6, 98, 32, 8), (256, 12, 98, 32, 2), (128, 24, 49, 32, None),
    (1024, 3, 98, 32, 32), (256, 6, 98, 32, 8), (64, 12, 98, 32, 2), (32, 24, 49, 32, None),
    (64, 4, 98, 32, 1), (64, 6, 98, 59, 32), (64, 8, 98, 64, 32),
    (1024, 4, 98, 32, 32), (32, 32, 49, 32, None),
]
WATTN_TIMED = (4096, 3, 98, 32, 32)  # Swin-T stage 1, 128 images: timed in bf16 and f32
# Swin-T's four stages at 128 images (window-attention blocks per stage): each
# timed in bf16, and weighted by its blocks into the kernels' time per step
WATTN_STAGES = {(4096, 3, 98, 32, 32): 2, (1024, 6, 98, 32, 8): 2, (256, 12, 98, 32, 2): 6,
                (128, 24, 49, 32, None): 2}
DBIAS_TOL = 1e-4  # dbias: f32 sums over B groups in another order, of the largest entry
VIT_CONFIG = os.path.join(REPO, "configs", "classification", "vit_base_patch16_224_in1k.yaml")
VIT_NAME = "ViT_base_patch16_224"
VIT_BLOCKS = 12  # ViT-B/16's attention blocks: one launch of each flash kernel per forward
VIT_TRAIN_BATCH = 128  # the recipe's per-card batch: 4,096 over 32 cards
# flash attention (n, l, h, d) and type: ViT-B/16 at 224 with 32 and 128
# images; ViT-B/32 (50 tokens, below the resolver's 65); ViT-B/16 at 384;
# ViT-L/16; ViT-H/14 (d = 80); ViT-g/14 (d = 104); MoCo v3 ViT-S (d = 32);
# the resolver's shortest flash sequence; 4,096 tokens, where `auto` turns
# to flash; ViT-L/16 in f16
FLASH_TIMED = (128, 197, 12, 64)  # ViT-B/16 training: timed in bf16 and f32
FLASH_CASES = [
    ((32, 197, 12, 64), torch.bfloat16), ((32, 197, 12, 64), torch.float32),
    (FLASH_TIMED, torch.bfloat16), (FLASH_TIMED, torch.float32),
    ((32, 50, 12, 64), torch.bfloat16), ((8, 577, 12, 64), torch.bfloat16),
    ((16, 197, 16, 64), torch.bfloat16), ((4, 257, 16, 80), torch.bfloat16),
    ((2, 257, 16, 104), torch.bfloat16), ((16, 197, 12, 32), torch.bfloat16),
    ((2, 65, 2, 32), torch.float32), ((2, 4096, 8, 64), torch.bfloat16),
    ((16, 197, 16, 64), torch.float16),
]
# m and l: f32 sums and maxima of the same products taken in another order
STAT_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM dense peaks: tensor cores for bf16/f16, the CUDA cores for f32
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    card = card_line()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # every f32 comparison below is in full f32: cuDNN convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build() -> None:
    _build.load()
    info = _build.build_info
    for cmd in info["commands"]:
        log("[build] " + " ".join(cmd))
    if info["log"]:
        log(info["log"].strip())
    log(f"[build] {info['seconds']:.2f} s -> {info['path']} (built={info['built']})")


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    h = shape[1]
    s = torch.tensor(rng.randn(*shape) * 3.0, dtype=dtype, device="cuda")
    wl = torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
    ww = torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
    return s, wl, ww


def _bound(nbytes: int, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or the
    products' flops over the peak for the inputs' type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _time_pair(kernel, plain, nbytes: int, flops: float, dtype: torch.dtype,
               library: Optional[Callable] = None, kernel_timer: Callable = loop_ms) -> dict:
    """Kernel, plain version and (where there is one) the PyTorch call that
    computes the same function, timed in turns (plain, kernel, library,
    library, kernel, plain), with the kernel's rate and its bound. The
    library's two turns are kept beside their mean (`library_ms_turns`): its
    time can move between turns, and a ranking against it names the reading.
    `kernel_timer` times the kernel's turns (`graph_ms` for a kernel shorter
    than its wrapper's host time)."""
    fns = (plain, kernel, library, library, kernel, plain)
    timers = (loop_ms, kernel_timer, loop_ms, loop_ms, kernel_timer, loop_ms)
    plain_a, kern_a, lib_a, lib_b, kern_b, plain_b = (
        t(f) if f is not None else None for t, f in zip(timers, fns))
    rec = {"ms": (kern_a + kern_b) / 2, "plain_ms": (plain_a + plain_b) / 2,
           "library_ms": None if library is None else (lib_a + lib_b) / 2,
           **_bound(nbytes, flops, dtype)}
    if library is not None:
        rec["library_ms_turns"] = [lib_a, lib_b]
    rec["kernel_GBps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def _fmt(rec: dict) -> str:
    return ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in rec.items())


def phase_kernel() -> dict:
    results = {}
    with torch.inference_mode():
        for i, (shape, dtype) in enumerate(CASES):
            s, wl, ww = _inputs(shape, dtype, seed=i)
            out = talking_heads_softmax(s, wl, ww)
            ref = talking_heads_softmax_ref(s, wl, ww)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == s.shape, f"kernel output {out.dtype} {tuple(out.shape)}")
            err = (out.float() - ref.float()).abs().max().item()
            atol, rtol = FWD_TOL[dtype]
            torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
            check(torch.equal(out, talking_heads_softmax(s, wl, ww)),
                  f"forward at {shape} {dtype}: two launches differ")
            rec = {"kernel": talking_heads_fwd_kernel_for(shape[1], shape[3], dtype),
                   "max_abs_err": err, "atol": atol, "rtol": rtol}
            if rec["kernel"] == "warp-row":
                rec["resources"] = talking_heads_fwd_resources(dtype, shape[1], shape[3])
            if shape[1:] == (8, 196, 196):  # CaiT-S24: time kernel and plain in turns
                # read s, write p; the two head mixes' products, 2 h flops per
                # score each (no PyTorch call computes this function). The
                # kernel's turns replay a CUDA graph: the wrapper's host time
                # would pace the card at 32 images; `host_paced_ms` is the
                # plain loop's reading, as a caller without a graph sees it
                rec.update(_time_pair(lambda: talking_heads_softmax(s, wl, ww),
                                      lambda: talking_heads_softmax_ref(s, wl, ww),
                                      2 * s.numel() * s.element_size(),
                                      4 * shape[1] * s.numel(), dtype, kernel_timer=graph_ms))
                rec["host_paced_ms"] = loop_ms(lambda: talking_heads_softmax(s, wl, ww))
            results[(shape, dtype)] = rec
            log(f"[kernel] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
                ", repeatable bitwise")
        # cait_s24_384's rows (k = 576), the block-row kernel's: for the record of its next step
        s, wl, ww = _inputs(LONG_ROW_CASE, torch.bfloat16, seed=len(CASES))
        h, k = LONG_ROW_CASE[1], LONG_ROW_CASE[3]
        rec = {"kernel": talking_heads_fwd_kernel_for(h, k, s.dtype),
               "ms": graph_ms(lambda: talking_heads_softmax(s, wl, ww)),
               **_bound(2 * s.numel() * s.element_size(), 4 * h * s.numel(), s.dtype)}
        log(f"[kernel] {LONG_ROW_CASE} bfloat16, timed alone: {_fmt(rec)}")
    return results


# backward vs plain backward: ds at TOL (one rounding of the same
# f32 value to the stored type); dproj_l / dproj_w are f32 sums over n*q*k
# products taken in another order (a fixed two-stage tree here, cuBLAS in
# the plain version): 1e-4 of the largest entry
WGRAD_TOL = 1e-4


def _wgrad_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_kernel_bwd() -> dict:
    results = {}
    for i, (shape, dtype) in enumerate(CASES):
        s, wl, ww = _inputs(shape, dtype, seed=100 + i)
        dp = torch.tensor(np.random.RandomState(200 + i).randn(*shape), dtype=dtype, device="cuda")
        ds, dwl, dww = talking_heads_softmax_bwd(s, dp, wl, ww)
        ref = talking_heads_softmax_bwd_ref(s, dp, wl, ww)
        torch.cuda.synchronize()
        check(ds.dtype == dtype and ds.shape == s.shape, f"backward ds {ds.dtype} {tuple(ds.shape)}")
        tol = TOL[dtype]
        torch.testing.assert_close(ds.float(), ref[0].float(), atol=tol, rtol=tol)
        rec = {"kernel": talking_heads_bwd_kernel_for(shape[1], shape[3], dtype),
               "max_abs_err": (ds.float() - ref[0].float()).abs().max().item(), "tol": tol,
               "dproj_l_rel_err": _wgrad_err(dwl, ref[1]), "dproj_w_rel_err": _wgrad_err(dww, ref[2]),
               "wgrad_tol": WGRAD_TOL}
        check(rec["dproj_l_rel_err"] <= WGRAD_TOL and rec["dproj_w_rel_err"] <= WGRAD_TOL,
              f"backward weight gradients at {shape} {dtype}: {rec}")
        again = talking_heads_softmax_bwd(s, dp, wl, ww)
        check(all(torch.equal(a, b) for a, b in zip((ds, dwl, dww), again)),
              f"backward at {shape} {dtype}: two launches differ")
        if shape[1:] == (8, 196, 196):  # CaiT-S24: time kernel and plain in turns
            # read s and dp, write ds; the products of the recomputed first
            # mix, the two mixes' backward and the two weight gradients, 2 h
            # flops per score each
            rec.update(_time_pair(lambda: talking_heads_softmax_bwd(s, dp, wl, ww),
                                  lambda: talking_heads_softmax_bwd_ref(s, dp, wl, ww),
                                  3 * s.numel() * s.element_size(),
                                  10 * shape[1] * s.numel(), dtype))
            # the same 5 h^2 multiply-adds a column on the CUDA cores alone (f32 peak)
            rec["cuda_core_floor_ms"] = 10 * shape[1] * s.numel() / PEAK_FLOPS[torch.float32] * 1e3
            if rec["kernel"] == "warp-row":
                rec["resources"] = talking_heads_bwd_resources(dtype, shape[1], shape[3])
        results[(shape, dtype)] = rec
        log(f"[kernel-bwd] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
            ", repeatable bitwise")
    return results


def _wattn_inputs(shape, dtype, seed):
    """q, k, v and do [B, h, L, d] at dtype; bias [h, L, L] f32; mask
    [nWm, L, L] of 0 and -100 as Swin's shift and pack masks, or None. Drawn
    on the card from a seeded generator (numpy takes seconds at stage 1)."""
    b, h, l, d, n_mask = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    q, k, v, do = (randn(b, h, l, d).to(dtype) for _ in range(4))
    bias = randn(h, l, l) * 0.5
    mask = None
    if n_mask:
        mask = torch.where(torch.rand(n_mask, l, l, generator=gen, device="cuda") > 0.7, -100.0, 0.0)
    return q, k, v, do, bias, mask


def _wattn_sdpa(q, k, v, bias, mask, do=None):
    """The window function as one F.scaled_dot_product_attention call: q, k, v
    as [B/nWm, nWm, h, L, d] and bias + mask as a float attn_mask [nWm, h, L,
    L] at q's type (nWm = 1 and bias alone without a mask). Returns the call,
    or with `do` the call's backward (dq, dk, dv and the mask's gradient) on a
    graph kept for repeated timing."""
    b, h, l, d = q.shape
    n_mask = 1 if mask is None else mask.shape[0]
    view = (b // n_mask, n_mask, h, l, d)
    q5, k5, v5 = (t.detach().reshape(view).clone() for t in (q, k, v))
    attn_mask = (bias[None] if mask is None else bias[None] + mask[:, None]).to(q.dtype)
    if do is None:
        return lambda: F.scaled_dot_product_attention(q5, k5, v5, attn_mask=attn_mask)
    leaves = [t.requires_grad_() for t in (q5, k5, v5, attn_mask)]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
    return lambda: torch.autograd.grad(out, leaves, do.view(view), retain_graph=True)


def _wattn_bytes_flops(q, bias, mask, tensors: int, products: int) -> tuple[int, int]:
    """`tensors` [B, h, L, d] tensors moved once plus the f32 bias and mask
    read once; `products` L x L x d products (2 flops each) per (group, head)."""
    b, h, l, d = q.shape
    extra = (bias.numel() + (0 if mask is None else mask.numel())) * 4
    return tensors * q.numel() * q.element_size() + extra, products * 2 * b * h * l * l * d


def _wattn_cases():
    return [(shape, dtype) for shape in WATTN_SHAPES for dtype in (torch.bfloat16, torch.float32)]


def _wattn_timed(shape, dtype) -> bool:
    """Every Swin-T stage in bf16; stage 1 in f32 too."""
    return shape == WATTN_TIMED or (shape in WATTN_STAGES and dtype == torch.bfloat16)


def _wattn_step_ms(results: dict, tag: str) -> dict:
    """A Swin-T training step's time in one window kernel: each stage's
    measured time (kernel, plain, SDPA, bound) times its blocks."""
    step = {key: sum(n * results[(shape, torch.bfloat16)][key] for shape, n in WATTN_STAGES.items())
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"[{tag}] Swin-T step at 128 images, bf16, {sum(WATTN_STAGES.values())} launches "
        f"weighted by stage: {_fmt(step)}")
    return step


def phase_wattn() -> dict:
    results = {}
    with torch.inference_mode():
        for i, (shape, dtype) in enumerate(_wattn_cases()):
            q, k, v, _, bias, mask = _wattn_inputs(shape, dtype, seed=300 + i)
            out = fused_window_attention(q, k, v, bias, mask)
            ref = window_attention_ref(q, k, v, bias, mask)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == q.shape, f"wattn output {out.dtype} {tuple(out.shape)}")
            tol = TOL[dtype]
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            rec = {"max_abs_err": (out.float() - ref.float()).abs().max().item(), "tol": tol}
            if _wattn_timed(shape, dtype):  # read q, k, v and write out once; q k^T and p v
                rec.update(_time_pair(lambda: fused_window_attention(q, k, v, bias, mask),
                                      lambda: window_attention_ref(q, k, v, bias, mask),
                                      *_wattn_bytes_flops(q, bias, mask, 4, 2), dtype,
                                      library=_wattn_sdpa(q, k, v, bias, mask)))
            results[(shape, dtype)] = rec
            log(f"[wattn] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}")
            del q, k, v, bias, mask, out, ref
    torch.cuda.empty_cache()
    _wattn_step_ms(results, "wattn")
    return results


def phase_wattn_bwd() -> dict:
    results = {}
    for i, (shape, dtype) in enumerate(_wattn_cases()):
        q, k, v, do, bias, mask = _wattn_inputs(shape, dtype, seed=400 + i)
        got = fused_window_attention_bwd(q, k, v, bias, mask, do)
        want = window_attention_bwd_ref(q, k, v, bias, mask, do)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        rec = {"tol": tol}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dtype and g.shape == q.shape, f"wattn-bwd {name} {g.dtype} {tuple(g.shape)}")
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol, msg=name)
            rec[f"{name}_max_abs_err"] = (g.float() - w.float()).abs().max().item()
        rec["max_abs_err"] = max(rec["dq_max_abs_err"], rec["dk_max_abs_err"], rec["dv_max_abs_err"])
        rec["dbias_rel_err"] = _wgrad_err(got[3], want[3])
        rec["dbias_tol"] = DBIAS_TOL
        check(rec["dbias_rel_err"] <= DBIAS_TOL, f"wattn-bwd dbias at {shape} {dtype}: {rec}")
        again = fused_window_attention_bwd(q, k, v, bias, mask, do)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"wattn-bwd at {shape} {dtype}: two launches differ")
        if _wattn_timed(shape, dtype):
            # read q, k, v, do and write dq, dk, dv once (and dbias, h L^2 f32,
            # counted with the bias); recompute q k^T, then p^T do, do v^T,
            # ds k and ds^T q
            rec.update(_time_pair(lambda: fused_window_attention_bwd(q, k, v, bias, mask, do),
                                  lambda: window_attention_bwd_ref(q, k, v, bias, mask, do),
                                  *_wattn_bytes_flops(q, bias, mask, 7, 5), dtype,
                                  library=_wattn_sdpa(q, k, v, bias, mask, do)))
        results[(shape, dtype)] = rec
        log(f"[wattn-bwd] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
            ", repeatable bitwise")
        del q, k, v, bias, mask, do, got, want, again
    torch.cuda.empty_cache()
    _wattn_step_ms(results, "wattn-bwd")
    return results


def _flash_inputs(shape, dtype, seed):
    """q, k, v [n, l, h, d] as views of one qkv tensor [n, l, 3, h, d] (the
    layout ViT's Attention hands the kernels) and do [n, l, h, d], drawn on the
    card from a seeded generator."""
    n, l, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(n, l, 3, h, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(n, l, h, d, generator=gen, device="cuda").to(dtype)
    return (*qkv.unbind(2), do)


def _flash_bytes_flops(shape, dtype, tensors: int, stats: int, products: int) -> tuple[int, int]:
    """`tensors` [n, l, h, d] tensors and `stats` f32 [n, h, l] row vectors
    moved once; `products` l x l x d products (2 flops each) per (image, head)."""
    n, l, h, d = shape
    esize = torch.empty((), dtype=dtype).element_size()
    return (tensors * n * l * h * d * esize + stats * n * h * l * 4,
            products * 2 * n * h * l * l * d)


def _sdpa(q, k, v, scale):
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          scale=scale)


def _flash_resources() -> None:
    """Registers, shared memory and blocks an SM of the three tensor-core
    flash kernels at each (type, head dim) of FLASH_CASES."""
    for dtype, d in sorted({(dt, shape[-1]) for shape, dt in FLASH_CASES if dt != torch.float32},
                           key=str):
        for kernel in ("fwd", "dkv", "dq"):
            r = flash_kernel_resources(kernel, dtype, d)
            log(f"[flash] resources {kernel} {str(dtype).removeprefix('torch.')} d={d}: "
                f"{r['registers']} registers, {r['shared_bytes']} B shared, "
                f"{r['blocks_per_sm']} blocks of {r['warps']} warps an SM, "
                f"{r['spill_bytes']} B spilled")


def phase_flash() -> dict:
    _flash_resources()
    results = {}
    with torch.inference_mode():
        for i, (shape, dtype) in enumerate(FLASH_CASES):
            q, k, v, _ = _flash_inputs(shape, dtype, seed=500 + i)
            scale = shape[-1] ** -0.5
            o, m, lsum = flash_attention_fwd(q, k, v, scale)
            o_ref, m_ref, l_ref = flash_attention_fwd_ref(q, k, v, scale)
            torch.cuda.synchronize()
            check(o.dtype == dtype and o.shape == shape, f"flash output {o.dtype} {tuple(o.shape)}")
            tol = TOL[dtype]
            torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(m, m_ref, atol=STAT_TOL, rtol=STAT_TOL, msg="m")
            torch.testing.assert_close(lsum, l_ref, atol=STAT_TOL, rtol=STAT_TOL, msg="l")
            rec = {"max_abs_err": (o.float() - o_ref.float()).abs().max().item(), "tol": tol}
            again = flash_attention_fwd(q, k, v, scale)
            check(all(torch.equal(a, b) for a, b in zip((o, m, lsum), again)),
                  f"flash at {shape} {dtype}: two launches differ")
            if shape == FLASH_TIMED:  # read q, k, v, write o, m, l; q k^T and p v
                rec.update(_time_pair(lambda: flash_attention_fwd(q, k, v, scale),
                                      lambda: flash_attention_fwd_ref(q, k, v, scale),
                                      *_flash_bytes_flops(shape, dtype, 4, 2, 2), dtype,
                                      library=lambda: _sdpa(q, k, v, scale)))
            results[(shape, dtype)] = rec
            log(f"[flash] {shape} {str(dtype).removeprefix('torch.')}: {_fmt(rec)}"
                ", repeatable bitwise")
            del q, k, v, o, m, lsum, o_ref, m_ref, l_ref, again
    torch.cuda.empty_cache()
    return results


def _autograd_ms(shape, dtype, seed) -> dict:
    """Forward + backward through autograd, from qkv to its gradient: the
    port's flash_attention (one forward and two backward launches) against
    F.scaled_dot_product_attention on the same views."""
    n, l, h, d = shape
    scale = d ** -0.5
    q, k, v, do = _flash_inputs(shape, dtype, seed)
    qkv = torch.stack((q, k, v), dim=2).detach().requires_grad_()
    do_flat = do.reshape(n, l, h * d)

    def port():
        qkv.grad = None
        flash_attention(*qkv.unbind(2), scale).backward(do_flat)

    def library():
        qkv.grad = None
        _sdpa(*qkv.unbind(2), scale).backward(do.transpose(1, 2))

    lib_a, port_a, port_b, lib_b = (loop_ms(f, iters=20) for f in (library, port, port, library))
    return {"autograd_ms": (port_a + port_b) / 2, "library_autograd_ms": (lib_a + lib_b) / 2}


def phase_flash_bwd() -> dict:
    results = {}
    for i, (shape, dtype) in enumerate(FLASH_CASES):
        q, k, v, do = _flash_inputs(shape, dtype, seed=600 + i)
        scale = shape[-1] ** -0.5
        with torch.no_grad():
            o, m, lsum = flash_attention_fwd_ref(q, k, v, scale)
            di = flash_attention_di(o, do)
            got = (*flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
                   flash_attention_dq(q, k, v, do, m, lsum, di, scale))
            want = (*flash_attention_dkv_ref(q, k, v, do, m, lsum, di, scale),
                    flash_attention_dq_ref(q, k, v, do, m, lsum, di, scale))
            torch.cuda.synchronize()
            tol = TOL[dtype]
            rec = {"tol": tol}
            for name, g, w in zip(("dk", "dv", "dq"), got, want):
                check(g.dtype == dtype and g.shape == shape, f"flash-bwd {name} {g.dtype} {tuple(g.shape)}")
                torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol, msg=name)
                rec[f"{name}_max_abs_err"] = (g.float() - w.float()).abs().max().item()
            again = (*flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
                     flash_attention_dq(q, k, v, do, m, lsum, di, scale))
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash-bwd at {shape} {dtype}: two launches differ")
            if shape == FLASH_TIMED:
                # dK/dV reads q, k, v, do and m, l, di and writes dk, dv; it
                # recomputes q k^T, then p^T do, do v^T and ds^T q. dQ reads
                # the same and writes dq: q k^T, do v^T and ds k. The library
                # yardstick is SDPA's whole backward (dq, dk and dv in one call)
                lib = _sdpa_backward(q, k, v, do, scale)
                rec["dkv"] = _time_pair(
                    lambda: flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
                    lambda: flash_attention_dkv_ref(q, k, v, do, m, lsum, di, scale),
                    *_flash_bytes_flops(shape, dtype, 6, 3, 4), dtype, library=lib)
                rec["dq"] = _time_pair(
                    lambda: flash_attention_dq(q, k, v, do, m, lsum, di, scale),
                    lambda: flash_attention_dq_ref(q, k, v, do, m, lsum, di, scale),
                    *_flash_bytes_flops(shape, dtype, 5, 3, 3), dtype, library=lib)
                del lib
        if shape == FLASH_TIMED:
            rec.update(_autograd_ms(shape, dtype, seed=700 + i))
        results[(shape, dtype)] = rec
        log(f"[flash-bwd] {shape} {str(dtype).removeprefix('torch.')}: "
            + _fmt({k: v for k, v in rec.items() if k not in ("dkv", "dq")}) + ", repeatable bitwise")
        for name in ("dkv", "dq"):
            if name in rec:
                log(f"[flash-bwd] {shape} {str(dtype).removeprefix('torch.')} {name} timed: "
                    f"{_fmt(rec[name])}")
        del q, k, v, do, o, m, lsum, di, got, want, again
    torch.cuda.empty_cache()
    return results


def _sdpa_backward(q, k, v, do, scale):
    """SDPA's backward alone (dq, dk, dv), on a graph kept for repeated timing."""
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = _sdpa(*leaves, scale)
    grad = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def _export(config: str, out_dir: str, *overrides: str) -> None:
    argv = ["-c", config, "-o", f"Global.output_dir={out_dir}"]
    for o in overrides:
        argv += ["-o", o]
    export.main(argv)


def _profile(fn, rec: Optional[dict] = None) -> str:
    """`fn()` once under torch.profiler: device busy time against its wall time
    (also into `rec` as busy_ms and wall_ms when given)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    count = 0
    for ev in prof.events():  # kernels and copies; not the ranges annotated on the device
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            count += 1
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    if rec is not None:
        rec.update(busy_ms=busy / 1e3, wall_ms=wall_us / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"({100 * (1 - busy / wall_us):.1f}% idle), {count} kernels and copies; top: "
            + "; ".join(f"{100 * t / busy:.1f}% {name[:60]}" for name, t in top))


def _serve(model_dir: str, name: str, requests, kernel) -> tuple[np.ndarray, list, int, str]:
    """Warm-up plus the requests, then one profiled request. Returns the
    requests' logits, per-request (preprocess, predict, postprocess) seconds,
    the launches of `kernel` over warm-up plus requests, and the profile line."""
    pred = Predictor(model_dir, name=name, transform=NORMALIZE, device="cuda")
    kernel.launches = 0
    pred(requests[0])  # warm-up
    logits, stages = [], []
    for imgs in requests:
        t0 = time.perf_counter()
        batch = pred.preprocess(imgs)
        t1 = time.perf_counter()
        out = pred.predict(batch)  # ends in a device-to-host copy: waits for the card
        t2 = time.perf_counter()
        res = pred.postprocess(out)
        stages.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        check(out.shape == (BATCH, NUM_CLASSES) and out.dtype == np.float32, f"logits {out.shape} {out.dtype}")
        check(bool(np.isfinite(out).all()), "non-finite logits")
        check(len(res) == BATCH and len(res[0]["class_ids"]) == 5, "top-5 results")
        logits.append(out)
    launches = kernel.launches
    prof = _profile(lambda: pred(requests[0]))
    del pred
    torch.cuda.empty_cache()
    return np.concatenate(logits), stages, launches, prof


def _report(tag: str, stages: list, prof: str) -> None:
    lat = [sum(st) for st in stages]
    mean = sum(lat) / len(lat)
    med = np.median(np.asarray(stages), axis=0) * 1e3
    log(f"[serve] {tag}: per-request latency ms " + ", ".join(f"{t * 1e3:.3f}" for t in lat)
        + f"; mean {mean * 1e3:.3f} ms, {BATCH / mean:.1f} images/s; median stages ms: "
        f"preprocess {med[0]:.3f}, predict {med[1]:.3f}, postprocess {med[2]:.3f}")
    log(f"[profile] {tag}: {prof}")


def _requests() -> list:
    rng = np.random.RandomState(0)
    return [list(rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)) for _ in range(REQUESTS)]


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_serve() -> int:
    requests = _requests()
    forwards = 1 + REQUESTS
    with tempfile.TemporaryDirectory() as tmp:
        # bf16 (the config's FP16 block, softmax_dtype bfloat16): kernel vs plain
        _export(CONFIG, os.path.join(tmp, "bf16"))
        _export(CONFIG, os.path.join(tmp, "bf16_einsum"), "Model.th_impl=einsum")
        fused, st_f, launches, prof_f = _serve(os.path.join(tmp, "bf16"), MODEL_NAME, requests,
                                               talking_heads_softmax)
        check(launches == DEPTH * forwards, f"kernel launched {launches}x, want {DEPTH * forwards}")
        plain, st_p, plain_launches, prof_p = _serve(os.path.join(tmp, "bf16_einsum"), MODEL_NAME,
                                                     requests, talking_heads_softmax)
        check(plain_launches == 0, f"plain path launched the kernel {plain_launches}x")
        _report("bf16 kernel path", st_f, prof_f)
        _report("bf16 plain path ", st_p, prof_p)
        cos = _cosines(fused, plain)
        log(f"[serve] bf16 kernel vs plain: min cosine {cos.min():.6f}, "
            f"max abs diff {np.abs(fused - plain).max():.4g}, launches {launches} "
            f"= {DEPTH} x {forwards} forwards")
        # both paths do the talking-heads step in f32 and round once to bf16, so
        # they may differ only where that rounding flips (an H100 gave cosine
        # 1.000000, max diff 0): 1e-4 of cosine is far above that, tighter than 1e-3
        check(cos.min() >= 0.9999, f"bf16 logits disagree: min cosine {cos.min()}")

        # f32 (FP16.enable=False; TF32 off above): the same f32 math with the
        # head mixes summed in another order (an H100 gave 6e-8): atol 1e-5
        _export(CONFIG, os.path.join(tmp, "f32"), "FP16.enable=False")
        _export(CONFIG, os.path.join(tmp, "f32_einsum"), "FP16.enable=False", "Model.th_impl=einsum")
        fused32, st_f32, launches32, prof_f32 = _serve(os.path.join(tmp, "f32"), MODEL_NAME,
                                                       requests, talking_heads_softmax)
        plain32, st_p32, _, prof_p32 = _serve(os.path.join(tmp, "f32_einsum"), MODEL_NAME,
                                              requests, talking_heads_softmax)
        check(launches32 == DEPTH * forwards, f"f32: kernel launched {launches32}x")
        _report("f32 kernel path ", st_f32, prof_f32)
        _report("f32 plain path  ", st_p32, prof_p32)
        log(f"[serve] f32 kernel vs plain: max abs diff {np.abs(fused32 - plain32).max():.4g}")
        np.testing.assert_allclose(fused32, plain32, atol=1e-5, rtol=0)
    return launches


def _serve_kernel_vs_einsum(tag: str, config: str, name: str, blocks: int, kernel,
                            kernel_cfg: str) -> dict:
    """A model through export and Predictor on its kernel path (`kernel_cfg`)
    against its einsum path on the same weights (Global.seed), in the config's
    bf16 with its softmax_dtype, at softmax_dtype=float32, and in f32
    throughout (FP16.enable=False, softmax_dtype=float32). Returns
    {precision: (min cosine, max abs diff, launches)}."""
    requests = _requests()
    forwards = 1 + REQUESTS
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (the in1k configs set softmax_dtype: bfloat16, so f32 throughout
        # sets it to float32 as well)
        for prec, overrides in (("bf16", ()), ("bf16, softmax f32", ("Model.softmax_dtype=float32",)),
                                ("f32", ("FP16.enable=False", "Model.softmax_dtype=float32"))):
            d_k, d_p = os.path.join(tmp, "kernel"), os.path.join(tmp, "plain")
            _export(config, d_k, kernel_cfg, *overrides)
            _export(config, d_p, *overrides)
            fused, st_f, launches, prof_f = _serve(d_k, name, requests, kernel)
            check(launches == blocks * forwards,
                  f"{tag} {prec}: kernel launched {launches}x, want {blocks * forwards}")
            plain, st_p, plain_launches, prof_p = _serve(d_p, name, requests, kernel)
            check(plain_launches == 0, f"{tag} {prec}: the einsum path launched the kernel")
            _report(f"{tag} {prec} kernel path", st_f, prof_f)
            _report(f"{tag} {prec} einsum path", st_p, prof_p)
            cos = _cosines(fused, plain)
            log(f"[serve] {tag} {prec} kernel vs einsum: min cosine {cos.min():.7f}, max abs diff "
                f"{np.abs(fused - plain).max():.4g} (largest logit {np.abs(plain).max():.4g}), "
                f"launches {launches} = {blocks} x {forwards} forwards")
            out[prec] = (cos.min(), np.abs(fused - plain).max(), launches)
    return out


def phase_serve_swin() -> int:
    """Swin-T at 224 through export and Predictor: the kernel path
    (attn_impl=fused) against the einsum path on the same weights (Global.seed)."""
    out = _serve_kernel_vs_einsum("Swin-T", SWIN_CONFIG, SWIN_NAME, SWIN_BLOCKS,
                                  fused_window_attention, "Model.attn_impl=fused")
    # bf16: the einsum path rounds the scores, the bias and mask sums and the
    # softmax to bf16 (2^-8 relative each) where the kernel keeps them in f32,
    # over 12 blocks; the tiny CPU model gave cosine >= 0.99998
    # (tests/test_torch_swin.py): 1e-3 of cosine leaves room for 12 blocks,
    # and a wrong mask or bias drops far below it
    check(out["bf16"][0] >= 0.999, f"Swin-T bf16 logits disagree: {out['bf16']}")
    # softmax f32: both paths compute f32 scores and softmax and round p to bf16
    # once; they differ only by where the scale and that rounding fall
    check(out["bf16, softmax f32"][0] >= 0.9999,
          f"Swin-T bf16 (softmax f32) logits disagree: {out['bf16, softmax f32']}")
    # f32 throughout: sums in another order (as tests/test_window_attention_kernel.py:129)
    check(out["f32"][1] <= 1e-4, f"Swin-T f32 logits disagree: {out['f32']}")
    return out["bf16"][2]


def phase_serve_vit() -> int:
    """ViT-B/16 at 224 through export and Predictor: the flash kernel path
    (attn_impl=flash) against the einsum path on the same weights."""
    out = _serve_kernel_vs_einsum("ViT-B/16", VIT_CONFIG, VIT_NAME, VIT_BLOCKS, flash_attention,
                                  "Model.attn_impl=flash")
    # bf16: the einsum path rounds the scores and the softmax to bf16 (the
    # config's softmax_dtype) where the kernel keeps them in f32, over 12
    # blocks; a wrong mask of the ragged last tile or a wrong scale drops far
    # below 1e-3 of cosine
    check(out["bf16"][0] >= 0.999, f"ViT-B/16 bf16 logits disagree: {out['bf16']}")
    # softmax f32: both compute f32 scores and softmax; they differ by where
    # the scale, p's rounding to bf16 and the normalisation fall
    check(out["bf16, softmax f32"][0] >= 0.9999,
          f"ViT-B/16 bf16 (softmax f32) logits disagree: {out['bf16, softmax f32']}")
    # f32 throughout: the same function with sums in another order
    check(out["f32"][1] <= 1e-4, f"ViT-B/16 f32 logits disagree: {out['f32']}")
    return out["bf16"][2]


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """One model's train phase: the kernel path timed against a plain path."""

    tag: str
    config: str
    batch: int
    blocks: int  # launches of each kernel per step
    n_fed: int  # parameters whose gradients the backward kernels give
    fwd: Callable  # the forward kernel's wrapper (its `.launches`)
    bwd: tuple  # the backward kernels' wrappers, each launched `blocks` times a step
    kernel: tuple  # overrides of the kernel path
    plain: tuple  # overrides of the plain path timed beside it
    grad_plain: tuple  # overrides of the path the first-step gradients are held against
    kernel_fed: Callable[[str], bool]  # the parameters whose gradients the backward kernels give
    resume_workers: int = 0  # loader workers of the one-step resume


CAIT_TRAIN = TrainSpec("CaiT-S24", CONFIG, TRAIN_BATCH, DEPTH, 2 * DEPTH, talking_heads_softmax,
                       (talking_heads_softmax_bwd,), (), ("Model.th_impl=einsum",),
                       ("Model.th_impl=einsum",),
                       lambda n: n.endswith("proj_l") or n.endswith("proj_w"), resume_workers=2)
# the fused path's softmax is f32 whatever softmax_dtype says; its gradients
# are held against the einsum path at softmax_dtype float32
SWIN_TRAIN = TrainSpec("Swin-T", SWIN_CONFIG, SWIN_TRAIN_BATCH, SWIN_BLOCKS, SWIN_BLOCKS,
                       fused_window_attention, (fused_window_attention_bwd,),
                       ("Model.attn_impl=fused",), (), ("Model.softmax_dtype=float32",),
                       lambda n: n.endswith("relative_position_bias_table"))
# the flash path's softmax is f32 whatever softmax_dtype says; its gradients
# are held against the einsum path at softmax_dtype float32. The dK/dV and dQ
# kernels feed every attn.qkv.weight
VIT_TRAIN = TrainSpec("ViT-B/16", VIT_CONFIG, VIT_TRAIN_BATCH, VIT_BLOCKS, VIT_BLOCKS,
                      flash_attention, (flash_attention_dkv, flash_attention_dq),
                      ("Model.attn_impl=flash",), (), ("Model.softmax_dtype=float32",),
                      lambda n: n.endswith("attn.qkv.weight"))


# loader worker processes of the timed runs. The Engine forks its pools before
# it moves the model to the card, and each loop joins its prefetch thread when
# it ends; CaiT-S24's one-step resume goes through the engine's loader with 2
# workers, as tools/train runs it (`TrainSpec.resume_workers`). The other
# resumes and the evals load in the main thread (no workers, no prefetch thread)
WORKERS = 6  # leaves cores to the training process on an 8-core host


def _loader_threads(loader: dict, workers: int) -> None:
    loader["num_workers"] = workers
    if not workers:
        loader["prefetch"] = 0


def _train_config(spec: TrainSpec, out_dir: str, *overrides: str, workers: int = WORKERS):
    """The in1k config with synthetic images (ImageNet is not on the card's
    machine; the config's own transforms stay), the spec's batch, TRAIN_STEPS steps."""
    config = cfg_util.get_config(spec.config, overrides=[
        f"Global.output_dir={out_dir}", f"Global.max_train_step={TRAIN_STEPS}",
        "Global.print_batch_step=1", "Global.eval_during_train=False", *overrides])
    for mode, size, bs in (("Train", 1024, spec.batch), ("Eval", 256, 128)):
        dl = config["DataLoader"][mode]
        dl["dataset"] = {"name": "SyntheticDataset", "size": size, "image_size": IMG,
                         "num_classes": NUM_CLASSES, "transform": dl["dataset"]["transform"]}
        dl["sampler"]["batch_size"] = bs
        _loader_threads(dl["loader"], workers)
    return config


def _first_batch(config) -> tuple:
    """Epoch 1's first training batch, built as the engine's loader builds it."""
    dl = dict(config["DataLoader"]["Train"], loader={"num_workers": 0, "prefetch": 0})
    loader = build_dataloader(dl, "Train", seed=int(config["Global"]["seed"]))
    loader.set_epoch(1)
    return to_device(next(iter(loader)), torch.device("cuda"))


def _grads(engine: Engine, batch) -> tuple[float, dict]:
    """Loss and per-parameter gradients of one forward and backward, leaving
    the state (generator, parameters, step) as it was."""
    rng = engine.state.generator.get_state()
    loss = float(engine.train_step.forward_backward(engine.state, batch)["loss"])
    grads = {n: p.grad.float().clone() for n, p in engine.model.named_parameters()}
    engine.state.generator.set_state(rng)
    for p in engine.model.parameters():
        p.grad = None
    return loss, grads


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.dot(a, b) / (a.norm() * b.norm())).item()


def _step_report(tag: str, engine: Engine, batch_size: int) -> dict:
    hist = engine.train_loop.history
    check(len(hist) == TRAIN_STEPS, f"{tag}: {len(hist)} logged steps, want {TRAIN_STEPS}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"{tag}: non-finite loss in {losses}")
    steady = hist[1:]  # the first step pays for cuBLAS and allocator warm-up
    batch = float(np.median([h["batch_cost"] for h in steady]))
    reader = float(np.median([h["reader_cost"] for h in steady]))
    rep = {"first_step_s": hist[0]["batch_cost"], "step_s_median": batch,
           "images_per_s": batch_size / batch, "reader_s_median": reader,
           "reader_share": reader / batch,
           "max_mem_GB": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[train] {tag}: losses " + ", ".join(f"{v:.5f}" for v in losses) + "; " + _fmt(rep))
    return rep


def _same_start(a: Engine, b: Engine) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))


def _launches(spec: TrainSpec) -> dict:
    return {w.__name__: w.launches for w in (spec.fwd, *spec.bwd)}


def _reset_launches(spec: TrainSpec) -> None:
    for w in (spec.fwd, *spec.bwd):
        w.launches = 0


def phase_train(spec: TrainSpec) -> dict:
    out = {}
    n = spec.blocks
    with tempfile.TemporaryDirectory() as tmp:
        cfg_k = _train_config(spec, os.path.join(tmp, "kernel"), *spec.kernel)
        e_k = Engine(cfg_k, mode="train", device="cuda")
        e_p = Engine(_train_config(spec, os.path.join(tmp, "plain"), *spec.plain),
                     mode="train", device="cuda")
        check(_same_start(e_k, e_p), f"{spec.tag}: the two paths start from different weights")
        e_g = e_p
        if spec.grad_plain != spec.plain:
            e_g = Engine(_train_config(spec, os.path.join(tmp, "grad"), *spec.grad_plain),
                         mode="train", device="cuda")
            check(_same_start(e_k, e_g), f"{spec.tag}: the gradient reference starts elsewhere")

        # the first step's gradients, kernel path against plain path
        batch = _first_batch(cfg_k)
        _reset_launches(spec)
        loss_k, g_k = _grads(e_k, batch)
        one_step = _launches(spec)
        check(set(one_step.values()) == {n},
              f"{spec.tag}: one step launched {one_step}, want {n} of each kernel")
        loss_p, g_p = _grads(e_g, batch)
        check(_launches(spec) == one_step, f"{spec.tag}: the plain path launched a kernel")
        if e_g is not e_p:
            e_g.close()
            del e_g
        cos_all = _cos(torch.cat([g.flatten() for g in g_k.values()]),
                       torch.cat([g.flatten() for g in g_p.values()]))
        cos_kf = {name: _cos(g_k[name].flatten(), g_p[name].flatten()) for name in g_k
                  if spec.kernel_fed(name)}
        worst = min(cos_kf, key=cos_kf.get)
        log(f"[train] {spec.tag} first-step gradients, kernel vs plain path: loss {loss_k:.6f} vs "
            f"{loss_p:.6f}, cosine overall {cos_all:.7f}, lowest kernel-fed cosine "
            f"{cos_kf[worst]:.7f} ({worst}), {len(cos_kf)} checked")
        check(len(cos_kf) == spec.n_fed,
              f"{spec.tag}: {len(cos_kf)} kernel-fed parameters, want {spec.n_fed}")
        # both paths compute the softmax in f32 and round p (and ds) to bf16
        # once, so they differ only where such a rounding flips (and in
        # summation order): 1e-3 of cosine leaves room for that, and a wrong
        # gradient term (a transposed mix, a missing softmax term, a dbias
        # summed over the wrong groups) falls far below
        check(cos_all >= 0.999 and cos_kf[worst] >= 0.999,
              f"{spec.tag}: gradients disagree: overall {cos_all}, {worst} {cos_kf[worst]}")
        check(abs(loss_k - loss_p) <= 1e-3 * abs(loss_p),
              f"{spec.tag}: losses disagree: {loss_k} vs {loss_p}")
        out["grad_cos"] = cos_all
        out["grad_cos_min_kernel_fed"] = cos_kf[worst]
        del g_k, g_p

        # the main path: TRAIN_STEPS steps through the kernels, as tools/train runs them
        _reset_launches(spec)
        torch.cuda.reset_peak_memory_stats()
        e_k.train()
        out["launches"] = _launches(spec)
        check(set(out["launches"].values()) == {n * TRAIN_STEPS},
              f"{spec.tag}: {TRAIN_STEPS} steps launched {out['launches']}, "
              f"want {n * TRAIN_STEPS} of each kernel")
        log(f"[train] {spec.tag}: launches over {TRAIN_STEPS} steps {out['launches']}")
        out["kernel"] = _step_report(f"{spec.tag} bf16 kernel path", e_k, spec.batch)
        ckpt = os.path.join(tmp, "kernel", "latest.pt")
        check(os.path.exists(ckpt) and e_k.state.step == TRAIN_STEPS, "no checkpoint after training")

        torch.cuda.reset_peak_memory_stats()
        e_p.train()
        check(_launches(spec) == out["launches"], f"{spec.tag}: the plain path launched a kernel")
        out["plain"] = _step_report(f"{spec.tag} bf16 plain path ", e_p, spec.batch)

        busy_k, busy_p = {}, {}
        log(f"[profile] {spec.tag} train step, bf16 kernel path: "
            f"{_profile(lambda: float(e_k.train_step(e_k.state, batch)['loss']), busy_k)}")
        log(f"[profile] {spec.tag} train step, bf16 plain path:  "
            f"{_profile(lambda: float(e_p.train_step(e_p.state, batch)['loss']), busy_p)}")
        out["busy_ms"] = {"kernel": busy_k["busy_ms"], "plain": busy_p["busy_ms"]}
        log(f"[train] {spec.tag} device busy per step: kernel path {busy_k['busy_ms']:.3f} ms, "
            f"plain path {busy_p['busy_ms']:.3f} ms")
        del e_k, e_p
        torch.cuda.empty_cache()

        # resume: one more step from the checkpoint, then evaluate it
        e_r = Engine(_train_config(spec, os.path.join(tmp, "resume"), *spec.kernel,
                                   f"Global.checkpoint={ckpt}",
                                   f"Global.max_train_step={TRAIN_STEPS + 1}",
                                   workers=spec.resume_workers),
                     mode="train", device="cuda")
        check(e_r.train_dataloader.num_workers == spec.resume_workers,
              f"{spec.tag}: resume loader has {e_r.train_dataloader.num_workers} workers")
        e_r.train()
        check(not [t for t in threading.enumerate() if t.name == PREFETCH_THREAD],
              f"{spec.tag}: a loader prefetch thread outlived the resume")
        hist = e_r.train_loop.history
        check(len(hist) == 1 and hist[0]["step"] == TRAIN_STEPS + 1 and np.isfinite(hist[0]["loss"]),
              f"{spec.tag}: resume from step {TRAIN_STEPS}: history {hist}")
        log(f"[train] {spec.tag} resumed from {ckpt} at step {TRAIN_STEPS} with "
            f"{spec.resume_workers} loader workers, trained step {hist[0]['step']}: "
            f"loss {hist[0]['loss']:.5f}")
        del e_r
        e_v = Engine(_train_config(spec, os.path.join(tmp, "eval"), *spec.kernel,
                                   f"Global.checkpoint={ckpt}", workers=0),
                     mode="eval", device="cuda")
        top1 = e_v.eval()
        m = e_v.eval_loop.last_metrics
        # a config with an EMA block is also evaluated on the EMA weights
        keys = {"top1", "top5"} | ({"top1_ema", "top5_ema"} if e_v.eval_metrics_step_ema else set())
        check(set(m) == keys and all(0.0 <= v <= 1.0 for v in m.values())
              and top1 == m["top1"], f"{spec.tag}: eval metrics {m}")
        log(f"[eval] {spec.tag}: {len(e_v.eval_dataloader.dataset)} synthetic images: "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())))
        del e_v
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ fused augment

# BYOL's two views (reference BYOL.py:239): view 1 always blurred, never
# solarized; view 2 blurred with p 0.1, solarized with p 0.2
AUG_VIEW1 = dict(blur_prob=1.0, solarize_prob=0.0)
AUG_VIEW2 = dict(blur_prob=0.1, solarize_prob=0.2)
AUG_BYOL = (128, IMG, IMG, 3)  # one view of BYOL's per-card batch
# (shape, settings): deterministic (coins at 0/1, one sigma) and random ones
AUG_CASES = [
    (AUG_BYOL, AUG_VIEW1),
    (AUG_BYOL, AUG_VIEW2),
    ((256, 32, 32, 3), dict(blur_prob=0.5, solarize_prob=0.5)),
    ((8, 160, 224, 3), dict(blur_prob=1.0, solarize_prob=1.0, sigma_range=(1.5, 1.5))),
    ((4, 16, 16, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=23, sigma_range=(2.0, 2.0))),
    ((16, 64, 48, 1), dict(blur_prob=1.0, solarize_prob=1.0, sigma_range=(0.1, 2.0),
                           mean=(0.45,), std=(0.226,))),
    ((64, 224, 224, 3), dict(blur_prob=0.0, solarize_prob=0.0)),
    # the fast kernel's other radii: taps 1, 3 (W C = 36: 4-byte staging), 4 and 25
    ((16, 40, 36, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=1)),
    ((16, 37, 12, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=3)),
    ((16, 48, 40, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=4)),
    ((16, 50, 44, 3), dict(blur_prob=1.0, solarize_prob=1.0, taps=25)),
    # an image lower than the radius, W C = 39 odd (byte staging, 2-byte stores)
    ((16, 5, 13, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=23)),
    # a misaligned contiguous view (`offset` bytes into a buffer): byte staging and streaming
    ((32, 33, 40, 3), dict(blur_prob=0.5, solarize_prob=0.5, offset=1)),
    # one channel at a compiled radius; two channels, which the generic kernel takes
    ((16, 40, 36, 1), dict(blur_prob=1.0, solarize_prob=0.5, taps=23, mean=(0.45,),
                           std=(0.226,))),
    ((16, 24, 20, 2), dict(blur_prob=0.5, solarize_prob=0.5, mean=(0.5, 0.4), std=(0.2, 0.25))),
    # the widest row the generic kernel takes at 23 taps (W C = 7,224, one row a block)
    ((4, 8, 2408, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=23)),
]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 (8 significant bits) at |x|, with a
    floor of 1e-5 near zero (x close to the mean), where the bf16 grid is
    finer than the f32 values' own error: x carries a few f32 ulps of 1 from
    the blur's sums, scaled by 1 / std (the plain version was 2.8e-6 from
    float64 on an H100)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.clamp(torch.exp2(e - 7), min=1e-5)


def _aug_images(shape, seed, offset: int = 0) -> torch.Tensor:
    """uint8 images from `seed`; with `offset`, a contiguous view that starts
    `offset` bytes into a buffer."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    if offset:
        buf = torch.zeros(imgs.numel() + offset, dtype=torch.uint8, device="cuda")
        imgs = buf[offset:offset + imgs.numel()].view(shape).copy_(imgs)
        check(imgs.is_contiguous() and imgs.data_ptr() % 16 == offset % 16,
              f"augment: the view at offset {offset} is not misaligned")
    return imgs


def _aug_rates(seed: int) -> dict:
    """4,096 copies of one 4 x 4 image through the kernel: which of the four
    (blur, solarize) outcomes each got, against their probabilities."""
    n = 4096
    one = _aug_images((1, 4, 4, 1), seed)
    kw = dict(taps=3, sigma_range=(1.0, 1.0), mean=(0.0,), std=(1.0,))
    outcomes = {(b, so): fused_augment_ref(one, torch.zeros(1, 3, device="cuda"),
                                           blur_prob=float(b), solarize_prob=float(so), **kw)[0]
                for b in (0, 1) for so in (0, 1)}
    check(len({tuple(v.flatten().tolist()) for v in outcomes.values()}) == 4,
          "augment rates: the four outcomes are not distinct")
    out = {}
    for blur_prob, sol_prob in ((AUG_VIEW2["blur_prob"], AUG_VIEW2["solarize_prob"]), (0.5, 0.8)):
        got = fused_augment(one.expand(n, -1, -1, -1).contiguous(), seed, blur_prob=blur_prob,
                            solarize_prob=sol_prob, **kw)
        which = {k: (got == v).flatten(1).all(1) for k, v in outcomes.items()}
        check(int(sum(w.sum() for w in which.values())) == n, "augment rates: unknown outcome")
        for name, share, p in (
                ("blur", (which[(1, 0)] | which[(1, 1)]).float().mean().item(), blur_prob),
                ("solarize", (which[(0, 1)] | which[(1, 1)]).float().mean().item(), sol_prob)):
            sigma = float(np.sqrt(p * (1 - p) / n))
            check(abs(share - p) <= 4 * sigma, f"augment {name} rate {share} at p {p}")
            out[f"{name}_rate@{p}"] = share
            out[f"{name}_z@{p}"] = (share - p) / sigma
    return out


def phase_augment() -> dict:
    results = {}
    with torch.inference_mode():
        for i, (shape, kw) in enumerate(AUG_CASES):
            kw = dict(kw)
            offset = kw.pop("offset", 0)
            imgs = _aug_images(shape, seed=800 + i, offset=offset)
            u = fused_augment_draws(shape[0], 900 + i, imgs.device)
            got = fused_augment_with_draws(imgs, u, **kw)
            want = fused_augment_ref(imgs, u, **kw)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16 and got.shape == imgs.shape,
                  f"augment output {got.dtype} {tuple(got.shape)}")
            g, w = got.float(), want.float()
            diff = (g - w).abs()
            over = diff > _bf16_ulp(torch.maximum(g.abs(), w.abs()))
            beyond = int(over.sum())
            rec = {"kernel": fused_augment_kernel_for(*shape[1:], kw.get("taps", 23)),
                   "max_abs_err": diff.max().item(), "bitwise_equal_share":
                   (got.view(torch.int16) == want.view(torch.int16)).float().mean().item(),
                   "blurred": int((u[:, 1] < kw["blur_prob"]).sum()),
                   "solarized": int((u[:, 2] < kw["solarize_prob"]).sum())}
            check(beyond == 0, f"augment at {shape} {kw}: {beyond} entries beyond one bf16 ulp, "
                               f"{rec}, (kernel, plain): "
                               f"{list(zip(g[over][:5].tolist(), w[over][:5].tolist()))}")
            check(torch.equal(got, fused_augment_with_draws(imgs, u, **kw)),
                  f"augment at {shape}: two launches differ")
            if shape == AUG_BYOL:
                check(rec["kernel"] == "fast", f"augment at {shape}: the {rec['kernel']} kernel")
                # read u8 once, write bf16 once; each blurred image's taps are
                # 2 passes x 2 flops x taps per element (view 1: every image;
                # view 2: its blurred images only). The kernel's turns replay a
                # CUDA graph: the wrapper's host time would pace a launch this
                # short; `host_paced_ms` is the plain loop's reading
                elems = imgs.numel()
                flops = 4 * 23 * (elems // shape[0]) * rec["blurred"]
                rec.update(_time_pair(lambda: fused_augment_with_draws(imgs, u, **kw),
                                      lambda: fused_augment_ref(imgs, u, **kw),
                                      3 * elems, flops, torch.float32, kernel_timer=graph_ms))
                rec["host_paced_ms"] = loop_ms(lambda: fused_augment_with_draws(imgs, u, **kw))
                if kw == AUG_VIEW1:
                    rec["resources"] = fused_augment_resources(*shape[1:], 23)
                    v2 = _aug_images(shape, seed=850)
                    gen = torch.Generator(device="cuda")
                    rec["byol_device_augment_plain_ms"] = loop_ms(
                        lambda: byol_device_augment(imgs, v2, gen.manual_seed(0)), iters=10)
            results[(shape, tuple(sorted(kw.items())))] = rec
            log(f"[augment] {shape} {kw}{f' at offset {offset}' if offset else ''}: "
                f"{_fmt(rec)}, repeatable bitwise")
            del imgs, u, got, want, g, w, diff
        # per-image draws: identical images with other draws come out different
        same = _aug_images((1, 64, 64, 3), seed=860).expand(8, -1, -1, -1).contiguous()
        out = fused_augment(same, 7, blur_prob=1.0, solarize_prob=0.0,
                            sigma_range=(0.1, 3.0)).float()
        differ = all(not torch.equal(out[0], out[j]) for j in range(1, 8))
        check(differ, "augment: identical images with other draws came out equal")
        rates = _aug_rates(seed=11)
        log(f"[augment] identical images, other draws: all differ; rates at 4096 images: "
            f"{_fmt(rates)}")
        # the op's own path: BYOL's two views through its entry point
        v1, v2 = _aug_images(AUG_BYOL, 870), _aug_images(AUG_BYOL, 871)
        fused_augment.launches = 0
        a1 = fused_augment(v1, 1, **AUG_VIEW1)
        a2 = fused_augment(v2, 2, **AUG_VIEW2)
        torch.cuda.synchronize()
        launches = fused_augment.launches
        check(launches == 2 and all(bool(torch.isfinite(a.float()).all()) for a in (a1, a2)),
              f"augment path: {launches} launches")
        log(f"[augment] BYOL's two views through fused_augment: launches {launches}")
    torch.cuda.empty_cache()
    return {"cases": results, "launches": launches}


# ------------------------------------------------- SSL ResNet-50: BYOL, SimCLR, MoCo v2


@dataclasses.dataclass(frozen=True)
class SSLSpec:
    """An SSL recipe's training phase: its config, per-card batch (pairs),
    the first step's size and overrides for the card-vs-CPU gradients, the
    momentum tower that takes no gradient (if any), and the backbone whose
    stem and layer4 convolutions the gradient check names."""
    tag: str
    config: str
    batch: int
    grad_batch: int
    grad_overrides: tuple
    backbone: str
    no_grad: Optional[str] = None


BYOL_SPEC = SSLSpec("BYOL-R50", os.path.join(REPO, "configs", "byol", "byol_r50_in1k.yaml"),
                    128,  # per view: the recipe's 4,096 over 32 cards
                    4, ("Model.use_device_augment=False",), "online.backbone.", "target.")
SIMCLR_SPEC = SSLSpec("SimCLR-R50", os.path.join(REPO, "configs", "simclr",
                                                 "simclr_r50_in1k.yaml"),
                      128,  # pairs: the recipe's 4,096 over 32 cards
                      4, ("Model.use_device_augment=False",), "backbone.")
MOCO_SPEC = SSLSpec("MoCoV2-R50", os.path.join(REPO, "configs", "moco", "mocov2_r50_in1k.yaml"),
                    256,  # the config's own batch, in 8 BatchNorm splits
                    16, (), "encoder_q.backbone.", "encoder_k.")  # 2 images a split


def _ssl_config(spec: SSLSpec, out_dir: str, batch: int, *overrides: str,
                workers: int = WORKERS):
    """The in1k config with synthetic images in place of ImageNet (the
    config's own two-view transforms stay), `batch` pairs, TRAIN_STEPS steps."""
    config = cfg_util.get_config(spec.config, overrides=[
        f"Global.output_dir={out_dir}", f"Global.max_train_step={TRAIN_STEPS}",
        "Global.print_batch_step=1", *overrides])
    dl = config["DataLoader"]["Train"]
    dl["dataset"] = {"name": "SyntheticDataset", "size": 1024, "image_size": IMG,
                     "num_classes": NUM_CLASSES, "transform": dl["dataset"]["transform"]}
    dl["sampler"]["batch_size"] = batch
    _loader_threads(dl["loader"], workers)
    return config


def _ssl_first_batch(engine: Engine, device: str):
    """Epoch 1's first batch of views; uint8 where the model augments on the
    device or takes raw crops (BYOL, SimCLR), f32 where the host normalizes (MoCo)."""
    dl = dict(engine.config["DataLoader"]["Train"], loader={"num_workers": 0, "prefetch": 0})
    loader = build_dataloader(dl, "Train", seed=engine.seed)
    loader.set_epoch(1)
    batch = engine.prepare_batch(next(iter(loader)))
    dtypes = {np.asarray(v).dtype for v in batch}
    host_normalized = any("NormalizeImage" in t for t in _transform_names(dl))
    check(dtypes == {np.dtype(np.float32 if host_normalized else np.uint8)},
          f"views reach the device as {dtypes}")
    return to_device(batch, torch.device(device))


def _transform_names(dl: dict) -> list:
    two_views = dl["dataset"]["transform"][-1]["TwoViewsTransform"]
    return [next(iter(t)) for t in two_views["base_transform1"]]


def _to_f64(model: torch.nn.Module) -> None:
    """Every parameter, buffer and compute dtype of `model` in float64 (a
    numerics yardstick only: the port computes in f32 or bf16)."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64


def _ssl_first_step(spec: SSLSpec, tmp: str, device: str, f64: bool) -> tuple[float, dict]:
    e = Engine(_ssl_config(spec, os.path.join(tmp, f"grads_{device}_{f64}"), spec.grad_batch,
                           "FP16.enable=False", *spec.grad_overrides),
               mode="train", device=device)
    if f64:
        _to_f64(e.model)
    loss = float(e.train_step.forward_backward(e.state, _ssl_first_batch(e, device))["loss"])
    grads = {n: p.grad.detach().double().cpu().clone() for n, p in e.model.named_parameters()
             if not (spec.no_grad and n.startswith(spec.no_grad))}  # the EMA tower takes none
    e.close()
    del e
    torch.cuda.empty_cache()
    return loss, grads


def _grad_agreement(spec: SSLSpec, tag: str, a: tuple, b: tuple) -> dict:
    """Loss and gradient cosines of two first steps (loss, grads): overall and
    the lowest of the stem's and layer4's conv weights."""
    (l_a, g_a), (l_b, g_b) = a, b
    names = list(g_a)
    cos_all = _cos(torch.cat([g_a[n].flatten() for n in names]),
                   torch.cat([g_b[n].flatten() for n in names]))
    convs = [n for n in names if g_a[n].dim() == 4 and (
        n == f"{spec.backbone}conv1.weight" or n.startswith(f"{spec.backbone}layer4."))]
    check(len(convs) == 11, f"{spec.tag}: {len(convs)} stem/layer4 convs, want 11")
    cos_conv = {n: _cos(g_a[n].flatten(), g_b[n].flatten()) for n in convs}
    worst = min(cos_conv, key=cos_conv.get)
    rel = abs(l_a - l_b) / abs(l_b)
    log(f"[train] {spec.tag} first step, {tag} ({spec.grad_batch} pairs): loss {l_a:.9f} vs "
        f"{l_b:.9f} (rel {rel:.3g}), gradient cosine overall {cos_all:.9f}, lowest of "
        f"{len(convs)} stem/layer4 convs {cos_conv[worst]:.9f} ({worst})")
    return {"loss_rel": rel, "grad_cos": cos_all, "grad_cos_min_conv": cos_conv[worst]}


def _grads_card_vs_cpu(spec: SSLSpec, tmp: str) -> dict:
    """The first step's loss and gradients on the card against the same step
    on the CPU, from the same init and batch, in f32 (TF32 off) and in f64;
    and, as the yardstick of f32 rounding, f32 against f64 on the CPU."""
    runs = {(d, f64): _ssl_first_step(spec, tmp, d, f64) for f64 in (False, True)
            for d in ("cuda", "cpu")}
    f32 = _grad_agreement(spec, "f32, card vs CPU", runs["cuda", False], runs["cpu", False])
    f64 = _grad_agreement(spec, "f64, card vs CPU", runs["cuda", True], runs["cpu", True])
    ref = _grad_agreement(spec, "CPU, f32 vs f64", runs["cpu", False], runs["cpu", True])
    # at ResNet-50's random init the gradient of a weight that feeds a
    # BatchNorm is a small remainder of large sums, which f32 resolves only to
    # the yardstick's cosine: in f32 the card and the CPU must agree at least
    # as well, and to 1e-3; f64 resolves it, and there they must agree to 1e-6
    for rec, tol in ((f32, 1e-3), (f64, 1e-6)):
        check(rec["loss_rel"] <= 1e-4 and min(rec["grad_cos"], rec["grad_cos_min_conv"]) >= 1 - tol,
              f"{spec.tag} card vs CPU first step: {rec}")
    check(f32["grad_cos"] >= ref["grad_cos"],
          f"{spec.tag} f32 card vs CPU {f32} further apart than f32 from f64 {ref}")
    return {f"{prec}_{k}": v for prec, rec in (("f32", f32), ("f64", f64), ("f32_vs_f64", ref))
            for k, v in rec.items()}


class _EmaCheck:
    """Wraps the engine's train step: after every step each target parameter
    must be m(t) target_prev + (1 - m(t)) online_new in f32, m(t) the momentum
    schedule at the step before the increment."""

    def __init__(self, tag: str, engine: Engine):
        self.tag, self.engine, self.step_fn = tag, engine, engine.train_step
        (self.src, self.dst, self.m_fn), = self.step_fn.ema_pairs
        self.worst = 0.0

    def __call__(self, state, batch):
        prev = [t.detach().clone() for t in self.dst]
        m = self.m_fn(state.step)
        metrics = self.step_fn(state, batch)
        with torch.no_grad():
            for s, d, p in zip(self.src, self.dst, prev):
                want = p * m + s * (1.0 - m)
                err = ((d - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
                self.worst = max(self.worst, err)
        # the same two f32 roundings in another kernel (foreach against per tensor)
        check(self.worst <= 1e-6, f"{self.tag} EMA rule broken at step {state.step}: {self.worst}")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


def _ssl_report(spec: SSLSpec, engine: Engine, batch, loss_range=(0.0, float("inf"))) -> dict:
    """The main path's losses (and acc1, where the method reports it) over
    TRAIN_STEPS steps, step time, pairs/s and views/s, reader share, peak
    memory, and device busy and idle share of one more profiled step."""
    hist = engine.train_loop.history
    losses = [h["loss"] for h in hist]
    lo, hi = loss_range
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses))
          and all(lo <= v <= hi for v in losses), f"{spec.tag} losses {losses}")
    accs = [h["acc1"] for h in hist if "acc1" in h]
    check(all(0.0 <= a <= 1.0 for a in accs), f"{spec.tag} acc1 {accs}")
    steady = hist[1:]  # the first step pays for cuDNN's and the allocator's warm-up
    step_s = float(np.median([h["batch_cost"] for h in steady]))
    reader = float(np.median([h["reader_cost"] for h in steady]))
    rep = {"first_step_s": hist[0]["batch_cost"], "step_s_median": step_s,
           "pairs_per_s": spec.batch / step_s, "views_per_s": 2 * spec.batch / step_s,
           "reader_s_median": reader, "reader_share": reader / step_s,
           "max_mem_GB": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[train] {spec.tag} bf16: losses " + ", ".join(f"{v:.5f}" for v in losses)
        + (("; acc1 " + ", ".join(f"{a:.4f}" for a in accs)) if accs else "") + "; " + _fmt(rep))
    prof: dict = {}
    log(f"[profile] {spec.tag} train step, bf16: "
        f"{_profile(lambda: float(engine.train_step(engine.state, batch)['loss']), prof)}")
    rep.update(busy_ms=prof["busy_ms"], idle_share=1 - prof["busy_ms"] / prof["wall_ms"])
    return rep


def _ssl_resume(spec: SSLSpec, tmp: str, ckpt: str, on_first_step=None) -> None:
    """One more step from the checkpoint (`on_first_step(engine)` runs on the
    restored state before it), as tools/train resumes."""
    e_r = Engine(_ssl_config(spec, os.path.join(tmp, "resume"), spec.batch,
                             f"Global.checkpoint={ckpt}",
                             f"Global.max_train_step={TRAIN_STEPS + 1}", workers=0),
                 mode="train", device="cuda")
    if on_first_step is not None:
        step_fn = e_r.train_step

        def first(state, batch):
            on_first_step(e_r)
            e_r.train_step = step_fn
            return step_fn(state, batch)

        e_r.train_step = first
    e_r.train()
    hist = e_r.train_loop.history
    check(len(hist) == 1 and hist[0]["step"] == TRAIN_STEPS + 1
          and np.isfinite(hist[0]["loss"]), f"{spec.tag} resume: history {hist}")
    log(f"[train] {spec.tag} resumed from {ckpt} at step {TRAIN_STEPS}, trained step "
        f"{hist[0]['step']}: loss {hist[0]['loss']:.5f}")
    del e_r
    torch.cuda.empty_cache()


def _stats_moved(spec: SSLSpec, engine: Engine, stats0: dict, prefixes) -> None:
    moved = {p: all(not torch.equal(v, stats0[k]) for k, v in engine.model.state_dict().items()
                    if k.startswith(p) and "running" in k) for p in prefixes}
    check(all(moved.values()), f"{spec.tag}: BatchNorm statistics moved {moved}")


def _no_optimizer_state_on(spec: SSLSpec, engine: Engine) -> None:
    stateful = {id(p) for p in engine.optimizer.torch_optimizer.state}
    named = list(engine.model.named_parameters())
    check(all((id(p) in stateful) != n.startswith(spec.no_grad) for n, p in named),
          f"{spec.tag}: {spec.no_grad} has optimizer state, or the online tower lacks it")


def phase_train_byol() -> dict:
    spec = BYOL_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        check(e.policy.compute_dtype == torch.bfloat16 and e.model.use_device_augment
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS",
              "BYOL-R50: not the recipe's bf16 / device augment / LARS")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        batch = _ssl_first_batch(e, "cuda")
        ema = _EmaCheck(spec.tag, e)
        e.train_step = ema
        torch.cuda.reset_peak_memory_stats()
        e.train()  # the main path, as tools/train runs it
        e.train_step = ema.step_fn
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("online.", "target."))
        log("[train] BYOL-R50: the EMA rule held at every step, the target has no optimizer "
            "state, BatchNorm statistics of both towers moved")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no BYOL-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch, loss_range=(0.0, 8.0)),
                   ema_max_rel_err=ema.worst)
        del e, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


# f32 on both sides, summed in another order, with exp, cos and sin of another
# library: 1e-5 of the views' largest magnitude (2.64 after normalize). At strength
# 1.0 the jitter's values reach 1.8^3 before the clip, where an f32 ulp is 4.8e-7,
# and normalize multiplies by 1 / 0.225: on an H100 the largest difference was
# 1.73e-5, at a value of 0.23 (3.9e-6 in [0, 1])
SIMCLR_AUG_TOL = 1e-5


def _simclr_augment_card_vs_cpu() -> dict:
    """The plain `simclr_device_augment_core` on the card against the CPU, on
    the same draws and SimCLR's per-card views [128, 224, 224, 3] uint8, at
    the recipe's jitter strength 1.0."""
    rng = np.random.RandomState(14)
    views = [torch.from_numpy(rng.randint(0, 256, (SIMCLR_SPEC.batch, IMG, IMG, 3),
                                          dtype=np.uint8)) for _ in range(2)]
    draws = simclr_draws(SIMCLR_SPEC.batch, torch.Generator().manual_seed(14),
                         torch.device("cpu"), jitter_strength=1.0)
    want = simclr_device_augment_core(*views, draws)
    on_card = [{k: ({j: t.cuda() for j, t in v.items()} if isinstance(v, dict) else v.cuda())
                for k, v in d.items()} for d in draws]
    got = [g.cpu() for g in simclr_device_augment_core(*(v.cuda() for v in views), on_card)]
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    check(err <= SIMCLR_AUG_TOL * scale,
          f"SimCLR device augmentation, card vs CPU: max abs err {err} of values up to {scale}")
    log(f"[augment] SimCLR's plain device augmentation on [{SIMCLR_SPEC.batch}, {IMG}, {IMG}, 3] "
        f"x 2 views, card vs CPU on the same draws: max abs err {err:.3g}, values up to "
        f"{scale:.4g} (limit {SIMCLR_AUG_TOL} of that)")
    return {"aug_max_abs_err": err, "aug_max_abs_value": scale}


def phase_train_simclr() -> dict:
    spec = SIMCLR_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_grads_card_vs_cpu(spec, tmp))
        out.update(_simclr_augment_card_vs_cpu())
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        check(e.policy.compute_dtype == torch.bfloat16 and e.model.use_device_augment
              and e.model.jitter_strength == 1.0
              and type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS"
              and e.config["LRScheduler"]["name"] == "simclrCosineWarmup",
              "SimCLR-R50: not the recipe's bf16 / device augment / LARS / simclrCosineWarmup")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        batch = _ssl_first_batch(e, "cuda")
        torch.cuda.reset_peak_memory_stats()
        e.train()  # the main path, as tools/train runs it
        _stats_moved(spec, e, stats0, ("backbone.", "neck."))
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no SimCLR-R50 checkpoint")
        out.update(_ssl_report(spec, e, batch))
        log("[train] SimCLR-R50: every loss finite, every acc1 in [0, 1], BatchNorm statistics "
            "of the backbone and the neck moved")
        del e, batch
        torch.cuda.empty_cache()
        _ssl_resume(spec, tmp, ckpt)
    return out


class _QueueCheck:
    """Wraps MoCo's train step: after step t the pointer is N t mod K, the N
    columns written at step t are unit-norm, and every column not yet
    written holds its init bitwise."""

    def __init__(self, engine: Engine):
        self.engine, self.step_fn = engine, engine.train_step
        self.queue0 = engine.model.queue.clone()
        self.worst_norm_err = 0.0

    def __call__(self, state, batch):
        model = self.engine.model
        n, k = self.engine.global_batch_size, model.K
        start = int(model.queue_ptr)
        metrics = self.step_fn(state, batch)
        t = state.step
        check(int(model.queue_ptr) == n * t % k,
              f"MoCoV2-R50: queue_ptr {int(model.queue_ptr)} after {t} steps, want {n * t % k}")
        norms = model.queue[:, start:start + n].norm(dim=0)
        self.worst_norm_err = max(self.worst_norm_err, (norms - 1).abs().max().item())
        check(self.worst_norm_err <= 1e-5, f"MoCoV2-R50: written keys' norms off 1 by "
                                           f"{self.worst_norm_err} at step {t}")
        check(torch.equal(model.queue[:, n * t:], self.queue0[:, n * t:]),
              f"MoCoV2-R50: a column past {n * t} changed by step {t}")
        return metrics

    def __getattr__(self, name):
        return getattr(self.step_fn, name)


@contextlib.contextmanager
def _one_permutation(n: int):
    """MoCo's shuffle-BN draws one fixed permutation of n, on every device."""
    perm = np.random.RandomState(15).permutation(n)
    orig = moco.shuffle_permutation
    moco.shuffle_permutation = lambda n_, generator, device: torch.from_numpy(perm).to(device)
    try:
        yield
    finally:
        moco.shuffle_permutation = orig


def phase_train_moco() -> dict:
    spec = MOCO_SPEC
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with _one_permutation(spec.grad_batch):
            out.update(_grads_card_vs_cpu(spec, tmp))
        e = Engine(_ssl_config(spec, os.path.join(tmp, "bf16"), spec.batch), mode="train",
                   device="cuda")
        splits = {m.num_splits for m in e.model.modules() if isinstance(m, SplitBatchNorm)}
        check(e.policy.compute_dtype == torch.bfloat16 and splits == {8}
              and e.model.K == 65536 and e.model.queue.dtype == torch.float32
              and e.config["Optimizer"]["name"] == "Momentum",
              f"MoCoV2-R50: not the recipe's bf16 / bn_splits 8 ({splits}) / K 65,536 / Momentum")
        stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
        batch = _ssl_first_batch(e, "cuda")
        ema = _EmaCheck(spec.tag, e)
        queue = _QueueCheck(e)
        queue.step_fn, e.train_step = ema, queue
        torch.cuda.reset_peak_memory_stats()
        e.train()  # the main path, as tools/train runs it
        e.train_step = ema.step_fn
        check(ema.m_fn(0) == ema.m_fn(TRAIN_STEPS) == float(np.float32(0.999)),
              "MoCoV2-R50: the key encoder's momentum is not the constant 0.999")
        _no_optimizer_state_on(spec, e)
        _stats_moved(spec, e, stats0, ("encoder_q.", "encoder_k."))
        log(f"[train] MoCoV2-R50: the EMA rule (m 0.999) held at every step "
            f"(max rel err {ema.worst:.3g}), encoder_k has no optimizer state, queue_ptr "
            f"{int(e.model.queue_ptr)} = {spec.batch} x {TRAIN_STEPS}, written keys unit-norm to "
            f"{queue.worst_norm_err:.3g}, unwritten columns bitwise at their init")
        ckpt = os.path.join(tmp, "bf16", "latest.pt")
        check(os.path.exists(ckpt) and e.state.step == TRAIN_STEPS, "no MoCoV2-R50 checkpoint")
        saved = {k: e.model.state_dict()[k].clone() for k in ("queue", "queue_ptr")}
        out.update(_ssl_report(spec, e, batch), ema_max_rel_err=ema.worst,
                   key_norm_max_err=queue.worst_norm_err)
        del e, batch, queue
        torch.cuda.empty_cache()

        def restored(engine):
            state = engine.model.state_dict()
            check(all(torch.equal(state[k], v) for k, v in saved.items()),
                  "MoCoV2-R50: the resumed queue or pointer differs from the checkpoint's")
            log("[train] MoCoV2-R50 resume: queue and queue_ptr bitwise as saved")

        _ssl_resume(spec, tmp, ckpt, restored)
    return out


def _timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"  # the JAX library (jax 0.9.0)


def _kernel_row(name: str, source: str, replaces: str, launches: int, err: float,
                rec: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"passl_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **{k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    _timed("build", phase_build)
    fwd = _timed("kernel", phase_kernel)
    bwd = _timed("kernel-bwd", phase_kernel_bwd)
    wfwd = _timed("wattn", phase_wattn)
    wbwd = _timed("wattn-bwd", phase_wattn_bwd)
    ffwd = _timed("flash", phase_flash)
    fbwd = _timed("flash-bwd", phase_flash_bwd)
    serve_launches = _timed("serve CaiT-S24", phase_serve)
    log(f"[serve] forward kernel launches on the serving path: {serve_launches}")
    swin_serve_launches = _timed("serve Swin-T", phase_serve_swin)
    log(f"[serve] window-attention launches on Swin-T's serving path: {swin_serve_launches}")
    vit_serve_launches = _timed("serve ViT-B/16", phase_serve_vit)
    log(f"[serve] flash forward launches on ViT-B/16's serving path: {vit_serve_launches}")
    train = _timed("train CaiT-S24", phase_train, CAIT_TRAIN)["launches"]
    swin = _timed("train Swin-T", phase_train, SWIN_TRAIN)["launches"]
    vit = _timed("train ViT-B/16", phase_train, VIT_TRAIN)["launches"]
    aug = _timed("augment", phase_augment)
    _timed("train BYOL-R50", phase_train_byol)
    _timed("train SimCLR-R50", phase_train_simclr)
    _timed("train MoCoV2-R50", phase_train_moco)
    a_rec = aug["cases"][(AUG_BYOL, tuple(sorted(AUG_VIEW1.items())))]
    f_rec, b_rec = fwd[TRAIN_CASE], bwd[TRAIN_CASE]
    wf_rec, wb_rec = wfwd[(WATTN_TIMED, torch.bfloat16)], wbwd[(WATTN_TIMED, torch.bfloat16)]
    ff_rec, fb_rec = ffwd[(FLASH_TIMED, torch.bfloat16)], fbwd[(FLASH_TIMED, torch.bfloat16)]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [
        _kernel_row("talking_heads_softmax", "talking_heads.cu",
                    "passl_tpu/ops/pallas/talking_heads.py:79", train["talking_heads_softmax"],
                    f_rec["max_abs_err"], f_rec),
        _kernel_row("talking_heads_softmax_bwd", "talking_heads_bwd.cu",
                    "passl_tpu/ops/pallas/talking_heads.py:87",
                    train["talking_heads_softmax_bwd"], b_rec["max_abs_err"], b_rec),
        _kernel_row("fused_window_attention", "window_attention.cu",
                    "passl_tpu/ops/pallas/window_attention.py:92", swin["fused_window_attention"],
                    wf_rec["max_abs_err"], wf_rec),
        _kernel_row("fused_window_attention_bwd", "window_attention_bwd.cu",
                    "passl_tpu/ops/pallas/window_attention.py:104",
                    swin["fused_window_attention_bwd"], wb_rec["max_abs_err"], wb_rec),
        _kernel_row("flash_attention", "flash_attention.cu",
                    f"{_LIB}:331 (via passl_tpu/ops/attention.py:111)", vit["flash_attention"],
                    ff_rec["max_abs_err"], ff_rec),
        _kernel_row("flash_attention_dkv", "flash_attention_bwd.cu",
                    f"{_LIB}:796 (via passl_tpu/ops/attention.py:111)", vit["flash_attention_dkv"],
                    max(fb_rec["dk_max_abs_err"], fb_rec["dv_max_abs_err"]), fb_rec["dkv"]),
        _kernel_row("flash_attention_dq", "flash_attention_bwd.cu",
                    f"{_LIB}:1146 (via passl_tpu/ops/attention.py:111)", vit["flash_attention_dq"],
                    fb_rec["dq_max_abs_err"], fb_rec["dq"]),
        _kernel_row("fused_augment", "augment.cu", "passl_tpu/ops/pallas/augment_kernel.py:36",
                    aug["launches"], a_rec["max_abs_err"], a_rec),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
