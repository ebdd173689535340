"""How far MoCo v3 ViT-B/16's f32 first step lies from f64, on the card and on
the CPU, over several inits and batches.

chip_smoke.py's MoCo v3 phase holds the card's f32 first step (4 pairs, the
einsum attention path, TF32 off) to f64 by the CPU's f32 error: the card's
1 - gradient cosine against f64 may be at most `f32_error_ratio` times the
CPU's. This script reads both errors and their ratio at each of several
seeds (the init and the batch change with `Global.seed`), each error also
over the encoder's blocks, the projection head and the predictor alone, so
that the limit is set from a spread and not from one reading.

  python tests/perf/mocov3_f32_spread.py [--seeds 42 1 2 3 4 5] [--pairs 4]

Needs a CUDA card; prints one JSON line per seed and a summary line.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)  # run as a script from anywhere: the repo's modules first

import chip_smoke as cs  # noqa: E402
from passl_tpu_torch.engine.engine import Engine  # noqa: E402

GROUPS = {"blocks": "base.encoder.blocks.", "head": "base.head.", "predictor": "base.predictor."}


def _error(a: dict, b: dict, prefix: str = "") -> float:
    """1 - the cosine of two gradient sets, over the names under `prefix`, in f64."""
    names = [n for n in a if n.startswith(prefix)]
    return 1.0 - cs._cos(torch.cat([a[n].flatten() for n in names]),
                         torch.cat([b[n].flatten() for n in names]))


def first_step(spec, tmp: str, device: str, f64: bool) -> tuple:
    """(loss, {name: gradient in f64 on the CPU}) of the spec's first step on
    `device`, in f32 or f64, from the engine's init (the same on every call:
    `Global.seed`) and epoch 1's first batch, the spec's draws handed in."""
    e = Engine(cs._ssl_config(spec, os.path.join(tmp, "grads"), spec.grad_batch,
                              "FP16.enable=False", *spec.grad_overrides, workers=0),
               mode="train", device="cpu")
    if spec.first_step_init is not None:
        spec.first_step_init(e.model)
    if f64:
        cs._to_f64(e.model)
    e.model.to(device)
    e.state.generator = torch.Generator(device=device).manual_seed(e.seed + 1)
    with spec.draws() if spec.draws else contextlib.nullcontext():
        loss = float(e.train_step.forward_backward(e.state, cs._ssl_first_batch(e, device))["loss"])
    grads = {n: p.grad.detach().double().cpu() for n, p in e.model.named_parameters()
             if not (spec.no_grad and n.startswith(spec.no_grad))}
    e.close()
    return loss, grads


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 1, 2, 3, 4, 5])
    ap.add_argument("--pairs", type=int, default=cs.MOCOV3_SPEC.grad_batch)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mocov3_f32_spread: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    ratios = []
    for seed in args.seeds:
        spec = dataclasses.replace(cs.MOCOV3_SPEC, grad_batch=args.pairs, grad_overrides=(
            *cs.MOCOV3_SPEC.grad_overrides, f"Global.seed={seed}"))
        with tempfile.TemporaryDirectory() as tmp:
            (_, f64), (_, cpu), (_, card) = (first_step(spec, tmp, d, f)
                                             for d, f in (("cpu", True), ("cpu", False),
                                                          ("cuda", False)))
        rec = {"seed": seed, "pairs": args.pairs, "card": _error(card, f64),
               "cpu": _error(cpu, f64)}
        rec["ratio"] = rec["card"] / rec["cpu"]
        for g, prefix in GROUPS.items():
            rec[f"card_{g}"], rec[f"cpu_{g}"] = _error(card, f64, prefix), _error(cpu, f64, prefix)
        ratios.append(rec["ratio"])
        print(json.dumps(rec), flush=True)
    print(json.dumps({"pairs": args.pairs, "ratio_min": min(ratios), "ratio_max": max(ratios)}))


if __name__ == "__main__":
    main()
