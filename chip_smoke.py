"""Smoke run of the PyTorch port (`passl_tpu_torch`) on one NVIDIA GPU.

Run from the repo root:  python3 chip_smoke.py

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from passl_tpu_torch/csrc/ with nvcc (sm_90a).
3. Holds the talking-heads kernel against its plain PyTorch version on the
   card at the shapes CaiT uses, and times both.
4. Serves CaiT-S24 at 224 through the user's entry points: the export CLI's
   `main` on configs/classification/cait_s24_224_in1k.yaml (random weights
   from Global.seed), then `Predictor(device="cuda")` answering 4 requests of
   32 images. Checks that every self-attention block went through the kernel,
   that the logits are finite, and that they agree with the same weights
   served through the plain version (th_impl=einsum), in bf16 and in f32.
   Prints each path's request latency, its split into preprocess / predict /
   postprocess, and a torch.profiler view of one more request (device busy
   time, idle share, the kernels that take the most device time).
5. Prints the card line, a JSON line of kernel results, and last the
   contract line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero; it prints no result line
then. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.ops import _build
from passl_tpu_torch.ops.talking_heads import talking_heads_softmax, talking_heads_softmax_ref
from passl_tpu_torch.tools import export

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "classification", "cait_s24_224_in1k.yaml")
MODEL_NAME = "cait_s24_224"
DEPTH = 24  # talking-heads blocks of CaiT-S24: one kernel launch each per forward
BATCH, REQUESTS = 32, 4
IMG, NUM_CLASSES = 224, 1000
NORMALIZE = [{"NormalizeImage": {"scale": 1.0 / 255, "mean": [0.485, 0.456, 0.406],
                                 "std": [0.229, 0.224, 0.225]}}]
# kernel vs plain version. f32: both sum the same f32 terms in another
# order. bf16/f16: both round the same f32 value once, so they differ by at
# most one unit in the last place of the stored type (bf16 2^-8 relative, as
# in tests/test_talking_heads_kernel.py; f16 2^-11, doubled).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
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
MAIN_CASE = ((BATCH, 8, 196, 196), torch.bfloat16)  # what the serving path hands the kernel


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
    if info["command"]:
        log("[build] " + " ".join(info["command"]))
        log(info["log"].strip())
    log(f"[build] {info['seconds']:.2f} s -> {info['path']} (built={info['built']})")


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    h = shape[1]
    s = torch.tensor(rng.randn(*shape) * 3.0, dtype=dtype, device="cuda")
    wl = torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
    ww = torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
    return s, wl, ww


def _time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            tol = TOL[dtype]
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            rec = {"max_abs_err": err, "tol": tol}
            if shape[1:] == (8, 196, 196):  # CaiT-S24: time kernel and plain in turns
                plain_a = _time_ms(lambda: talking_heads_softmax_ref(s, wl, ww))
                kern_a = _time_ms(lambda: talking_heads_softmax(s, wl, ww))
                kern_b = _time_ms(lambda: talking_heads_softmax(s, wl, ww))
                plain_b = _time_ms(lambda: talking_heads_softmax_ref(s, wl, ww))
                rec.update(ms=(kern_a + kern_b) / 2, plain_ms=(plain_a + plain_b) / 2)
                nbytes = 2 * s.numel() * s.element_size()
                rec["kernel_GBps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
            results[(shape, dtype)] = rec
            log(f"[kernel] {shape} {str(dtype).removeprefix('torch.')}: "
                + ", ".join(f"{k}={v:.6g}" for k, v in rec.items()))
    return results


def _export(out_dir: str, *overrides: str) -> None:
    argv = ["-c", CONFIG, "-o", f"Global.output_dir={out_dir}"]
    for o in overrides:
        argv += ["-o", o]
    export.main(argv)


def _profile(pred: Predictor, imgs) -> str:
    """One more request under torch.profiler: device busy time against its wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(imgs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"({100 * (1 - busy / wall_us):.1f}% idle); top: "
            + "; ".join(f"{100 * t / busy:.1f}% {name[:60]}" for name, t in top))


def _serve(model_dir: str, requests) -> tuple[np.ndarray, list, int, str]:
    """Warm-up plus the requests, then one profiled request. Returns the
    requests' logits, per-request (preprocess, predict, postprocess) seconds,
    the kernel launches of warm-up plus requests, and the profile line."""
    pred = Predictor(model_dir, name=MODEL_NAME, transform=NORMALIZE, device="cuda")
    talking_heads_softmax.launches = 0
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
    launches = talking_heads_softmax.launches
    prof = _profile(pred, requests[0])
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


def phase_serve() -> int:
    rng = np.random.RandomState(0)
    requests = [list(rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8))
                for _ in range(REQUESTS)]
    forwards = 1 + REQUESTS
    with tempfile.TemporaryDirectory() as tmp:
        # bf16 (the config's FP16 block, softmax_dtype bfloat16): kernel vs plain
        _export(os.path.join(tmp, "bf16"))
        _export(os.path.join(tmp, "bf16_einsum"), "Model.th_impl=einsum")
        fused, st_f, launches, prof_f = _serve(os.path.join(tmp, "bf16"), requests)
        check(launches == DEPTH * forwards, f"kernel launched {launches}x, want {DEPTH * forwards}")
        plain, st_p, plain_launches, prof_p = _serve(os.path.join(tmp, "bf16_einsum"), requests)
        check(plain_launches == 0, f"plain path launched the kernel {plain_launches}x")
        _report("bf16 kernel path", st_f, prof_f)
        _report("bf16 plain path ", st_p, prof_p)
        cos = (fused * plain).sum(-1) / (np.linalg.norm(fused, axis=-1) * np.linalg.norm(plain, axis=-1))
        log(f"[serve] bf16 kernel vs plain: min cosine {cos.min():.6f}, "
            f"max abs diff {np.abs(fused - plain).max():.4g}, launches {launches} "
            f"= {DEPTH} x {forwards} forwards")
        # both paths do the talking-heads step in f32 and round once to bf16, so
        # they may differ only where that rounding flips (an H100 gave cosine
        # 1.000000, max diff 0): 1e-4 of cosine is far above that, tighter than 1e-3
        check(cos.min() >= 0.9999, f"bf16 logits disagree: min cosine {cos.min()}")

        # f32 (FP16.enable=False; TF32 off above): the same f32 math with the
        # head mixes summed in another order (an H100 gave 6e-8): atol 1e-5
        _export(os.path.join(tmp, "f32"), "FP16.enable=False")
        _export(os.path.join(tmp, "f32_einsum"), "FP16.enable=False", "Model.th_impl=einsum")
        fused32, st_f32, launches32, prof_f32 = _serve(os.path.join(tmp, "f32"), requests)
        plain32, st_p32, _, prof_p32 = _serve(os.path.join(tmp, "f32_einsum"), requests)
        check(launches32 == DEPTH * forwards, f"f32: kernel launched {launches32}x")
        _report("f32 kernel path ", st_f32, prof_f32)
        _report("f32 plain path  ", st_p32, prof_p32)
        log(f"[serve] f32 kernel vs plain: max abs diff {np.abs(fused32 - plain32).max():.4g}")
        np.testing.assert_allclose(fused32, plain32, atol=1e-5, rtol=0)
    return launches


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernel = phase_kernel()
    launches = phase_serve()
    main_rec = kernel[MAIN_CASE]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "talking_heads_softmax",
        "route": "cuda",
        "source": "passl_tpu_torch/csrc/talking_heads.cu",
        "replaces": "passl_tpu/ops/pallas/talking_heads.py:79",
        "launches": launches,
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
