"""Where LV-ViT-S's f32 first step on the card parts from f64: cuDNN's
convolutions and BatchNorms against PyTorch's native ones.

chip_smoke.py holds LV-ViT's card f32 first step (4 images, 4 blocks, one
MixToken box handed to both devices, TF32 off) to f64 by the CPU's f32
error, with cuDNN off, and logs the same step through cuDNN beside it. This
script takes the step on the CPU in f64 (the reference) and in f32, and on
the card in f32 four ways: through cuDNN, with cuDNN off, with only the
convolutions on PyTorch's native kernels, and with only the BatchNorms
there; it prints each one's relative distance from f64 and the parameters
that carry most of the cuDNN step's error.

  python tests/perf/lvvit_first_step_convs.py
  NVIDIA_TF32_OVERRIDE=0 python tests/perf/lvvit_first_step_convs.py  # TF32 off in the libraries too

Needs a CUDA card; prints one JSON line.
"""
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)  # run as a script from anywhere: the repo's modules first

import chip_smoke as cs  # noqa: E402
from mocov3_f32_spread import first_step  # noqa: E402  (this directory is on the path)
from passl_tpu_torch.nn.layers import Conv  # noqa: E402
from passl_tpu_torch.nn.norm import BatchNorm  # noqa: E402


def _native(cls) -> None:
    """`cls`'s forward with cuDNN off, every other module's with cuDNN on."""
    orig = cls.forward

    def forward(self, *args, **kwargs):
        with cs._cudnn_off(True):
            return orig(self, *args, **kwargs)

    cls.forward = forward
    cls._cudnn_forward = orig


def _restore(cls) -> None:
    cls.forward = cls._cudnn_forward


def _distance(grads: dict, ref: dict) -> float:
    err = sum(((grads[n] - ref[n]) ** 2).sum().item() for n in ref) ** 0.5
    return err / torch.cat([g.flatten() for g in ref.values()]).norm().item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lvvit_first_step_convs: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    spec = cs.LVVIT_SPEC
    rec = {"card": cs.card_line(), "NVIDIA_TF32_OVERRIDE": os.environ.get("NVIDIA_TF32_OVERRIDE")}
    with tempfile.TemporaryDirectory() as tmp:
        _, ref = first_step(spec, tmp, "cpu", True)
        _, cpu = first_step(spec, tmp, "cpu", False)
        _, cudnn = first_step(spec, tmp, "cuda", False)
        runs = {"cpu_f32": cpu, "card_cudnn": cudnn}
        with cs._cudnn_off(True):
            runs["card_cudnn_off"] = first_step(spec, tmp, "cuda", False)[1]
        for name, cls in (("card_native_convs", Conv), ("card_native_batchnorms", BatchNorm)):
            _native(cls)
            try:
                runs[name] = first_step(spec, tmp, "cuda", False)[1]
            finally:
                _restore(cls)
    rec.update({k: _distance(g, ref) for k, g in runs.items()})
    worst = sorted(ref, key=lambda n: -((cudnn[n] - ref[n]) ** 2).sum().item())[:8]
    rec["cudnn_worst"] = [
        {"name": n, "cudnn_rel": ((cudnn[n] - ref[n]).norm() / ref[n].norm()).item(),
         "cpu_rel": ((cpu[n] - ref[n]).norm() / ref[n].norm()).item()} for n in worst]
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
