"""PixPro's learning-check config (tests/e2e/pixpro_structured.yaml) in both
packages from one init: the JAX engine's at the config's seed.

  python tests/perf/pixpro_jax_init.py init OUT.pt
      writes the JAX engine's initial PixPro variables (the key tower a copy
      of the online one, as the JAX engine makes it) as a torch state_dict
      for the port's PixPro, to start the port's pretrain from:
        python -m passl_tpu_torch.tools.train -c tests/e2e/pixpro_structured.yaml \
            --device cuda -o Global.pretrained_model=OUT.pt -o Global.print_batch_step=8
  python tests/perf/pixpro_jax_init.py steps N [f32|bf16]
      runs the first N steps of the config in both packages on the CPU from
      that init, on the JAX loader's batches, and prints each step's loss
      side by side (the step-8, 16, 24 losses are the checks' epoch 1-3 log
      lines at `print_batch_step=8`).
  python tests/perf/pixpro_jax_init.py jax-check OUT_DIR [f32|bf16]
      the JAX package's PixPro learning check (the three steps of
      tests/e2e/run_learning_check.sh pixpro: pretrain, extract, probe) with
      a log line each epoch (`print_batch_step=8`), in f32 or as the config
      asks (bf16), its outputs under OUT_DIR; prints the probe's top-1.

A diagnosis script for the CPU: it imports JAX and the JAX package.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)  # run as a script from anywhere: the repo's packages first
CFG = os.path.join(REPO, "tests", "e2e", "pixpro_structured.yaml")


def _jax_engine(overrides, out_dir):
    from passl_tpu.engine import Engine as JaxEngine
    from passl_tpu_torch.utils import cfg_util

    cfg = cfg_util.get_config(CFG, overrides=[*overrides, f"Global.output_dir={out_dir}"],
                              show=False)
    return JaxEngine(cfg, mode="train")


def init_state(engine) -> dict:
    import jax

    from passl_tpu_torch.models import build_model
    from passl_tpu_torch.utils import cfg_util
    from passl_tpu_torch.utils.convert import flax_to_torch

    state = jax.device_get(engine.state)
    port = build_model(dict(cfg_util.get_config(CFG, show=False)["Model"]))
    return flax_to_torch(state.params, port, state.model_state.get("batch_stats"))


def jax_check(out: str, prec: str) -> None:
    import re
    import subprocess

    over = ["-o", "Global.print_batch_step=8"] + (["-o", "FP16.enable=False"] if prec == "f32"
                                                 else [])
    steps = [
        ["passl_tpu.tools.train", "-c", CFG, "-o", f"Global.output_dir={out}/pretrain", *over],
        ["passl_tpu.tools.extract_weights", "--checkpoint", f"{out}/pretrain/latest.ckpt",
         "--prefix", "encoder/backbone", "--rename", "backbone",
         "--output", f"{out}/backbone.params"],
        ["passl_tpu.tools.train", "-c", os.path.join(REPO, "tests", "e2e", "probe_structured.yaml"),
         "-o", f"Global.output_dir={out}/probe", "-o",
         f"Global.pretrained_model={out}/backbone.params"],
    ]
    os.makedirs(out, exist_ok=True)
    log = ""
    for cmd in steps:
        run = subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, capture_output=True,
                             text=True, check=True)
        log += run.stdout + run.stderr
        print(f"{cmd[0]}: done", flush=True)
    with open(os.path.join(out, "jax_check.log"), "w") as f:
        f.write(log)
    losses = re.findall(r"Epoch (\d+)/\d+\]\[Iter: 8/8\].*? loss: (-?[0-9.]+)", log)
    print("pretrain loss at the end of each epoch: " + ", ".join(f"{e} {v}" for e, v in losses))
    print(f"FINAL JAX PixPro ({prec}) linear-probe top1: "
          f"{re.findall(r'top1: ([0-9.]+)', log)[-1]}")


def main(argv) -> None:
    import tempfile

    import torch

    if argv[0] == "jax-check":
        jax_check(argv[1], argv[2] if len(argv) > 2 else "bf16")
        return
    if argv[0] == "init":
        with tempfile.TemporaryDirectory() as tmp:
            je = _jax_engine([], tmp)
            torch.save(init_state(je), argv[1])
            je.train_dataloader.close()
        print(f"wrote the JAX engine's init to {argv[1]}")
        return
    steps, prec = int(argv[1]), (argv[2] if len(argv) > 2 else "f32")
    over = ["Global.print_batch_step=1", f"Global.max_train_step={steps}"]
    if prec == "f32":
        over.append("FP16.enable=False")
    from passl_tpu_torch.engine.engine import Engine
    from passl_tpu_torch.utils import cfg_util

    with tempfile.TemporaryDirectory() as tmp:
        je = _jax_engine(over, f"{tmp}/jax")
        init = f"{tmp}/init.pt"
        torch.save(init_state(je), init)
        je.train_dataloader.set_epoch(1)
        jax_losses = []
        for b in je.train_dataloader:  # epochs of 8 steps: one loader pass is enough for 8
            je.state, m = je.train_step(je.state, je.shard_batch(b))
            jax_losses.append(float(m["loss"]))
            if len(jax_losses) == min(steps, len(je.train_dataloader)):
                break
        for epoch in range(2, -(-steps // len(je.train_dataloader)) + 1):
            je.train_dataloader.set_epoch(epoch)
            for b in je.train_dataloader:
                je.state, m = je.train_step(je.state, je.shard_batch(b))
                jax_losses.append(float(m["loss"]))
                if len(jax_losses) == steps:
                    break
        je.train_dataloader.close()
        e = Engine(cfg_util.get_config(CFG, overrides=[
            *over, f"Global.output_dir={tmp}/port", f"Global.pretrained_model={init}"],
            show=False), mode="train", device="cpu")
        e.train()
        port_losses = [h["loss"] for h in e.train_loop.history]
    print(f"PixPro, {prec}, both packages from the JAX engine's init, the CPU:")
    for i, (a, b) in enumerate(zip(jax_losses, port_losses)):
        print(f"step {i + 1}: jax {a:.6f} port {b:.6f} rel {abs(a - b) / max(abs(a), 1e-12):.2e}")
    worst = max(abs(a - b) / max(abs(a), 1e-12) for a, b in zip(jax_losses, port_losses))
    print(f"largest relative difference {worst:.3e} over {len(port_losses)} steps")
    assert len(port_losses) == len(jax_losses) == steps and np.isfinite(worst)


if __name__ == "__main__":
    main(sys.argv[1:])
