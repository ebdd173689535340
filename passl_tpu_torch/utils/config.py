# Copied from passl_tpu/utils/config.py; the port keeps its own copy and imports nothing of passl_tpu.
"""YAML config loading with dotted-path CLI overrides.

Capability parity with reference `passl/utils/config.py:24-173`: YAML →
recursive AttrDict, `-o key.sub=value` overrides with literal-eval, and
a standard argparse front-end shared by train/eval/export CLIs.
"""
from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Iterable, Optional

import yaml

from .misc import AttrDict, create_attr_dict


def parse_config(cfg_file: str) -> AttrDict:
    with open(cfg_file, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    return create_attr_dict(cfg)


def _literal(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def override(dl: Any, ks: list, v: Any) -> None:
    """Recursively override dl[ks[0]][ks[1]]... = v (creating dicts)."""
    if len(ks) == 1:
        k = ks[0]
        if isinstance(dl, list):
            dl[int(k)] = v
        else:
            dl[k] = v
        return
    k = ks[0]
    if isinstance(dl, list):
        override(dl[int(k)], ks[1:], v)
    else:
        if k not in dl or not isinstance(dl[k], (dict, list)):
            dl[k] = AttrDict()
        override(dl[k], ks[1:], v)


def override_config(config: AttrDict, options: Optional[Iterable[str]] = None) -> AttrDict:
    """Apply `key.sub=value` style overrides (reference config.py:74-135)."""
    if options is None:
        return config
    for opt in options:
        assert isinstance(opt, str), f"option {opt} must be str"
        assert "=" in opt, f"option {opt} must be key=value format"
        key, value = opt.split("=", 1)
        override(config, key.split("."), _literal(value))
    return config


def get_config(fname: str, overrides: Optional[Iterable[str]] = None, show: bool = False) -> AttrDict:
    assert os.path.exists(fname), f"config file({fname}) is not exist"
    config = parse_config(fname)
    override_config(config, overrides)
    if show:
        print_config(config)
    return config


def print_config(config: dict, prefix: str = "") -> None:
    for k, v in sorted(config.items()):
        if isinstance(v, dict):
            print(f"{prefix}{k}:")
            print_config(v, prefix + "  ")
        else:
            print(f"{prefix}{k}: {v}")


def parse_args(description: str = "PASSL-TPU") -> argparse.Namespace:
    parser = argparse.ArgumentParser(description)
    parser.add_argument("-c", "--config", type=str, required=True, help="config file path")
    parser.add_argument(
        "-o",
        "--override",
        action="append",
        default=[],
        help="config options to override, e.g. -o Global.epochs=10",
    )
    parser.add_argument(
        "-p",
        "--profiler_options",
        type=str,
        default=None,
        help='profiler options, e.g. "batch_range=[10,20];state=GPU"',
    )
    return parser.parse_args()


def merge_config(base: AttrDict, extra: dict) -> AttrDict:
    """Deep-merge extra into a copy of base."""
    out = copy.deepcopy(base)

    def _merge(dst, src):
        for k, v in src.items():
            if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
                _merge(dst[k], v)
            else:
                dst[k] = create_attr_dict(v) if isinstance(v, dict) else v

    _merge(out, extra)
    return out
