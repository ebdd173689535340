"""Time the flash-attention kernels at ViT-B/16's training shape on the card,
and split the time of the forward, dK/dV and dQ into products and streaming.

    python tests/perf/flash_kernels_cuda.py                          # this checkout
    python tests/perf/flash_kernels_cuda.py full nocomp nomem dq64   # and three edited copies

`nocomp` is a copy of `passl_tpu_torch/` whose tensor-core forward, dK/dV
and dQ kernels skip their products (staging, barriers and stores stay);
`nomem` one whose three kernels stage only their first streamed tile and
reuse it. Both write wrong outputs and exist only to be timed. `dq64` is
a copy whose dQ takes 64-row q tiles of 4 warps instead of 128 rows of 8:
the other tile height, right and timed beside the checkout's. Each copy
builds under `build/flash_variants/<name>/` (all builds side by side) and
is timed in a process of its own, in the order given and then in reverse.
Prints one JSON line a run: CUDA-event ms a launch (mean of 50 after 5
warm-up) of the forward, dK/dV and dQ.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SHAPE = (128, 197, 12, 64)  # ViT-B/16 training, bf16
# variant: [(source, anchor, replacement, the kernels whose code holds the anchor)];
# every occurrence of an anchor is replaced
EDITS = {
    "nocomp": [("flash_attention.cu", "    if (!active) continue;", "    continue;",
                ("flash_attention_fwd_mma_kernel",)),
               ("flash_attention_bwd.cu", "    if (active) {\n      const T* Qs",
                "    if (false) {\n      const T* Qs", ("flash_attention_dkv_mma_kernel",)),
               ("flash_attention_bwd.cu", "    if (!active) continue;", "    continue;",
                ("flash_attention_dq_mma_kernel",))],
    "nomem": [("flash_attention.cu", "      stage_rows_async<T, DP, kTile, THREADS>(nxt",
               "      if (false) stage_rows_async<T, DP, kTile, THREADS>(nxt",
               ("flash_attention_fwd_mma_kernel",)),
              ("flash_attention_bwd.cu", "      stage_rows_async<T, DP, kTile, kMmaThreads>(nxt",
               "      if (false) stage_rows_async<T, DP, kTile, kMmaThreads>(nxt",
               ("flash_attention_dkv_mma_kernel",)),
              ("flash_attention_bwd.cu", "      stage_rows_async<T, DP, kTile, THREADS>(nxt",
               "      if (false) stage_rows_async<T, DP, kTile, THREADS>(nxt",
               ("flash_attention_dq_mma_kernel",))],
    "dq64": [("flash_attention_bwd.cu", "constexpr int kDqWarps = 8;", "constexpr int kDqWarps = 4;",
              ())],
}
BUILD = "from passl_tpu_torch.ops import _build; _build.load()"


def variant_root(name: str) -> Path:
    """The directory whose passl_tpu_torch/ a run imports: the checkout, or an edited copy."""
    if name == "full":
        return REPO
    root = REPO / "build" / "flash_variants" / name
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


def time_kernels() -> dict:
    import torch
    from passl_tpu_torch.ops import attention as A
    from passl_tpu_torch.utils.cuda_timing import loop_ms

    n, l, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = torch.randn(n, l, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16).unbind(2)
    do = torch.randn(n, l, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    scale = d ** -0.5
    o, m, lsum = A.flash_attention_fwd(q, k, v, scale)
    di = A.flash_attention_di(o, do)
    fns = {"fwd": lambda: A.flash_attention_fwd(q, k, v, scale),
           "dkv": lambda: A.flash_attention_dkv(q, k, v, do, m, lsum, di, scale),
           "dq": lambda: A.flash_attention_dq(q, k, v, do, m, lsum, di, scale)}
    return {f"{name}_ms": loop_ms(fn) for name, fn in fns.items()}


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
