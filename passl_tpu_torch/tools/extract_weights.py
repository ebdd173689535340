"""Extract a sub-module's weights from a training checkpoint (counterpart of
`passl_tpu/tools/extract_weights.py`).

Pulls the backbone out of an SSL checkpoint so that a linear-probe or
fine-tune config can load it with `Global.pretrained_model=`. It reads a
checkpoint the port's trainer wrote (`<output_dir>/<prefix>.pt`, or the
file a `Global.checkpoint` names; a JAX `.ckpt` is refused) and writes a
torch `state_dict` of the entries under `--prefix`, a dotted module path:
`backbone` (SimCLR), `online.backbone` (BYOL), `encoder_q.backbone` (MoCo).
The BatchNorm running statistics travel with the parameters (the JAX
tool's `batch_stats` bundling): a frozen backbone normalizing with fresh
statistics gives useless features.

Usage:
  python -m passl_tpu_torch.tools.extract_weights \\
      --checkpoint out/mocov2/latest.pt \\
      --prefix encoder_q.backbone \\
      --output out/mocov2/backbone.pt \\
      [--no-strip-prefix]          # keep the prefix in the saved keys
      [--rename backbone]          # re-root the entries under a new name
      [--check-config tests/e2e/probe_structured.yaml]

With `--check-config`, the output is then loaded into that config's model
as `Global.pretrained_model` loads it (the tolerant loader, which keeps the
init of whatever the file lacks), and the tool exits non-zero naming every
entry under the `--rename` name (or the prefix) that the file left
unfilled: a probe over a backbone that silently kept its random init
measures nothing.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from passl_tpu_torch.models import build_model
from passl_tpu_torch.utils import cfg_util, io, logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("passl_tpu_torch extract weights")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--prefix", required=True,
                    help="module path of the entries, e.g. encoder_q.backbone")
    ap.add_argument("--output", required=True)
    ap.add_argument("--strip-prefix", action=argparse.BooleanOptionalAction, default=True,
                    help="drop the prefix from saved keys (--no-strip-prefix keeps it)")
    ap.add_argument("--rename", default=None, help="re-root under this name")
    ap.add_argument("--check-config", default=None,
                    help="a config whose model must take every extracted entry")
    return ap.parse_args(argv)


def extract(state: dict, prefix: str, strip_prefix: bool = True,
            rename: Optional[str] = None) -> dict:
    """The entries of a model `state_dict` under `prefix` (parameters and
    buffers), renamed as the CLI's flags say; SystemExit when none is."""
    prefix = prefix.replace("/", ".").rstrip(".") + "."
    cut = len(prefix) if strip_prefix else 0
    picked = {k[cut:]: v for k, v in state.items() if k.startswith(prefix)}
    if not picked:
        available = sorted({k.split(".")[0] for k in state})
        raise SystemExit(f"no entries under '{prefix[:-1]}'. top-level names: {available}")
    if rename:
        picked = {f"{rename}.{k}": v for k, v in picked.items()}
    return picked


def unfilled(config_path: str, weights: str, root: str) -> list:
    """The entries under `root` of the config's model that `weights` leaves
    unfilled when loaded as `Global.pretrained_model` is."""
    model_cfg = dict(cfg_util.get_config(config_path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    model.to_empty(device="cpu")
    report = io.load_pretrained(model, weights)
    root = root.replace("/", ".").rstrip(".") + "."
    return sorted(k for k in report["missing"] + report["mismatched"] if k.startswith(root))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    ckpt = torch.load(io.resolve_checkpoint(args.checkpoint), map_location="cpu",
                      weights_only=True)
    picked = extract(ckpt["model"], args.prefix, args.strip_prefix, args.rename)
    torch.save(picked, args.output)
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in picked)
    logger.info(f"extracted {len(picked)} tensors ({n_stats} BN statistics) from "
                f"'{args.prefix}' of {args.checkpoint} (step {ckpt['step']}) -> {args.output}")
    if args.check_config:
        left = unfilled(args.check_config, args.output, args.rename or args.prefix)
        if left:
            raise SystemExit(f"{args.output} leaves {len(left)} entries of {args.check_config}'s "
                             f"model unfilled: {left}")
        logger.info(f"{args.output} fills every '{args.rename or args.prefix}' entry of "
                    f"{args.check_config}'s model")
    return picked


if __name__ == "__main__":
    main()
