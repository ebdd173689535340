"""Time the talking-heads backward at CaiT-S24's training shape on the card,
and split the warp-row kernel's time into weight-gradient products and
streaming.

    python tests/perf/talking_heads_kernels_cuda.py                           # this checkout
    python tests/perf/talking_heads_kernels_cuda.py full nowgrad nomem block  # and three edited copies

`nowgrad` is a copy of `passl_tpu_torch/` whose warp-row kernel skips its
two weight-gradient products (the staging of p_mid and ds_mid stays);
`nomem` one whose warps stage s and dp and store ds for their first row
only, and recompute that row. Both write wrong outputs and exist only to be
timed. `block` is a copy whose C entry point sends every shape to the
block-row kernel, the design the warp-row kernel replaced at this shape:
right, and timed beside the checkout's. Each copy builds under
`build/talking_heads_variants/<name>/` (all builds side by side) and is timed
in a process of its own, in the order given and then in reverse. Prints one
JSON line a run: CUDA-event ms a launch (mean of 50 after 5 warm-up) of the
backward (both stages) and, for context, the forward.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SHAPE = (64, 8, 196, 196)  # CaiT-S24 training, bf16
ROW_KERNEL = "talking_heads_bwd_row_kernel"
# variant: [(source, anchor, replacement, the kernels whose code holds the anchor)];
# every occurrence of an anchor is replaced
EDITS = {
    "nowgrad": [("talking_heads_bwd.cu", "    outer_mma<T, LD>(", "    if (false) outer_mma<T, LD>(",
                 (ROW_KERNEL,))],
    "nomem": [("talking_heads_bwd.cu", "    stage_row<T, H, C>(S, DP",
               "    if (row == first) stage_row<T, H, C>(S, DP", (ROW_KERNEL,)),
              ("talking_heads_bwd.cu", "if (col < k_len) ds[base",
               "if (row == first && col < k_len) ds[base", (ROW_KERNEL,))],
    "block": [("talking_heads_bwd.cu",
               "  return dtype != 0 && h <= kRowMaxHeads && k <= kRowMaxK;", "  return false;", ())],
}
BUILD = "from passl_tpu_torch.ops import _build; _build.load()"


def variant_root(name: str) -> Path:
    """The directory whose passl_tpu_torch/ a run imports: the checkout, or an edited copy."""
    if name == "full":
        return REPO
    root = REPO / "build" / "talking_heads_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "passl_tpu_torch", root / "passl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, text, repl, _ in EDITS[name]:
        path = root / "passl_tpu_torch" / "csrc" / src
        code = path.read_text()
        if text not in code:
            raise SystemExit(f"{name}: {src} has no {text!r}")
        path.write_text(code.replace(text, repl))
    return root


def _ms(fn) -> float:
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 50


def time_kernels() -> dict:
    import numpy as np
    import torch
    from passl_tpu_torch.ops import talking_heads as th

    n, h, q, k = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = (torch.randn(SHAPE, generator=gen, device="cuda") * 3.0).to(torch.bfloat16)
    dp = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    rng = np.random.RandomState(0)
    wl, ww = (torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
              for _ in range(2))
    with torch.inference_mode():
        return {"kernel": th.talking_heads_bwd_kernel_for(h, k, s.dtype),
                "bwd_ms": _ms(lambda: th.talking_heads_softmax_bwd(s, dp, wl, ww)),
                "fwd_ms": _ms(lambda: th.talking_heads_softmax(s, wl, ww))}


def main(argv: list[str]) -> None:
    if argv[:1] == ["--run"]:  # one timing run, in the process that imports the copy
        sys.path.insert(0, argv[1])
        print(json.dumps({"variant": argv[2], **time_kernels()}), flush=True)
        return
    names = argv or ["full"]
    roots = {name: variant_root(name) for name in names}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=root) for root in roots.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    for name in names + names[::-1]:
        subprocess.run([sys.executable, __file__, "--run", str(roots[name]), name], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
