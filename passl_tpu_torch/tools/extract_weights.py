"""Extract a sub-module's weights from a training checkpoint (counterpart of
`passl_tpu/tools/extract_weights.py`).

Pulls the backbone out of an SSL checkpoint so that a linear-probe or
fine-tune config can load it with `Global.pretrained_model=`. It reads a
checkpoint the port's trainer wrote (`<output_dir>/<prefix>.pt`, or the
file a `Global.checkpoint` names; a JAX `.ckpt` is refused) and writes a
torch `state_dict` of the entries under `--prefix`, a dotted module path:
`backbone` (SimCLR, SwAV), `online.backbone` (BYOL, MoCo-BYOL),
`encoder_q.backbone` (MoCo), `encoder.backbone` (SimSiam),
`student.backbone` (DINO, DINOv2; `--rename encoder` for their probes, as
`tests/e2e/run_learning_check.sh:34-42` does; DINOv2's `mask_token` is one
entry the probe does not take), `encoder` (BEiT, `--rename encoder`; its
`mask_token` too). `--prefix` takes several paths, comma-separated, where a
model keeps its encoder at its top level (CAE: `patch_embed,blocks,norm
--no-strip-prefix`), and the empty prefix takes every entry (a dVAE
checkpoint's, `--rename tokenizer` for BEiT's and CAE's
`Global.pretrained_model`: the tokenizer takes its encoder and ignores its
codebook and decoder), as `tests/e2e/run_learning_check.sh:85-183` does.
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

MAE's encoder is no sub-module of its own: `mae_encoder` takes it out of a
`MaskedAutoencoderViT` state (the learning check's extract, as
`tests/e2e/run_learning_check.sh:175-212` does for the JAX package), and
`convmae_encoder` ConvMAE's stages out of a `MaskedAutoencoderConvViT`'s
(`:160-173`).
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
                    help="module path of the entries, e.g. encoder_q.backbone; several "
                         "comma-separated; empty for every entry")
    ap.add_argument("--output", required=True)
    ap.add_argument("--strip-prefix", action=argparse.BooleanOptionalAction, default=True,
                    help="drop the prefix from saved keys (--no-strip-prefix keeps it)")
    ap.add_argument("--rename", default=None, help="re-root under this name")
    ap.add_argument("--check-config", default=None,
                    help="a config whose model must take every extracted entry")
    return ap.parse_args(argv)


def _roots(prefix: str) -> tuple:
    """'a.b,c' -> ('a.b.', 'c.'); '' -> ('',): every name starts with it."""
    return tuple(p.replace("/", ".").strip().rstrip(".") + "." if p.strip() else ""
                 for p in prefix.split(","))


def extract(state: dict, prefix: str, strip_prefix: bool = True,
            rename: Optional[str] = None) -> dict:
    """The entries of a model `state_dict` under `prefix` (parameters and
    buffers; several comma-separated paths, or '' for all), renamed as the
    CLI's flags say; SystemExit when none is."""
    roots = _roots(prefix)
    if strip_prefix and len(roots) > 1:
        raise SystemExit(f"--prefix {prefix}: several paths are kept whole (--no-strip-prefix)")
    cut = len(roots[0]) if strip_prefix else 0
    picked = {k[cut:]: v for k, v in state.items() if k.startswith(roots)}
    if not picked:
        available = sorted({k.split(".")[0] for k in state})
        raise SystemExit(f"no entries under '{prefix}'. top-level names: {available}")
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
    return sorted(k for k in report["missing"] + report["mismatched"] if k.startswith(_roots(root)))


def require_filled(config_path: str, weights: str, root: str) -> None:
    """SystemExit naming every entry under `root` of the config's model that
    `weights` leaves unfilled (`--check-config`)."""
    left = unfilled(config_path, weights, root)
    if left:
        raise SystemExit(f"{weights} leaves {len(left)} entries of {config_path}'s model "
                         f"unfilled: {left}")
    logger.info(f"{weights} fills every '{root}' entry of {config_path}'s model")


def mae_encoder(state: dict, img_size: int, rename: str = "backbone") -> dict:
    """The encoder of a `MaskedAutoencoderViT` state (`patch_embed`,
    `cls_token`, `blocks`; not the decoder and not the pretrain `norm`) under
    `rename`, with the fixed sin-cos table the pretrain added as the probe
    ViT's `pos_embed` [1, grid^2 + 1, D] (a zero class slot), the grid
    `img_size` over the patch size: what the JAX package's learning check
    extracts. The global-pool probe's `fc_norm`, which the pretrain has none
    of, goes in at a LayerNorm's init (ones, zeros), where the JAX check's
    fresh probe starts it."""
    from passl_tpu_torch.models.utils.pos_embed import get_2d_sincos_pos_embed

    picked = {f"{rename}.{k}": v for k, v in state.items()
              if k.startswith(("patch_embed.", "blocks.")) or k == "cls_token"}
    weight = state["patch_embed.proj.weight"]
    grid = img_size // weight.shape[-1]
    table = get_2d_sincos_pos_embed(weight.shape[0], grid, cls_token=True)[None]
    picked[f"{rename}.pos_embed"] = torch.from_numpy(table)
    picked[f"{rename}.fc_norm.weight"] = torch.ones(weight.shape[0])
    picked[f"{rename}.fc_norm.bias"] = torch.zeros(weight.shape[0])
    return picked


def convmae_encoder(state: dict, rename: str = "backbone") -> dict:
    """The three stages of a `MaskedAutoencoderConvViT` state (`patch_embed1`
    to `patch_embed4`, `blocks1` to `blocks3`; not the stage decodes, the
    pretrain `norm` or the decoder) under `rename`, and the global-pool
    `ConvViT`'s `fc_norm` at a LayerNorm's init (ones, zeros), where the JAX
    check's fresh probe starts it: the sin-cos table is fixed in both models."""
    picked = {f"{rename}.{k}": v for k, v in state.items()
              if k.startswith(("patch_embed", "blocks1.", "blocks2.", "blocks3."))}
    dim = state["patch_embed4.weight"].shape[0]
    picked[f"{rename}.fc_norm.weight"] = torch.ones(dim)
    picked[f"{rename}.fc_norm.bias"] = torch.zeros(dim)
    return picked


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
        require_filled(args.check_config, args.output, args.rename or args.prefix)
    return picked


if __name__ == "__main__":
    main()
