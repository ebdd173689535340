"""Time the talking-heads kernels at CaiT-S24's training shape on the card,
and split the warp-row kernels' time into their parts.

    python tests/perf/talking_heads_kernels_cuda.py                           # this checkout
    python tests/perf/talking_heads_kernels_cuda.py full nowgrad nomem block  # the backward's copies
    python tests/perf/talking_heads_kernels_cuda.py full fwdblock fwdnomem    # the forward's copies
    python tests/perf/talking_heads_kernels_cuda.py --sass                    # the forward's loop, compiled

Each name but `full` is an edited copy of `passl_tpu_torch/`. The backward's:
`nowgrad` skips the warp-row kernel's two weight-gradient products (the
staging of p_mid and ds_mid stays); `nomem` has its warps stage s and dp and
store ds for their first row only, and recompute that row; `block` sends
every backward shape to the block-row kernel, the design the warp-row kernel
replaced at this shape. The forward's: `fwdnomem` has each warp load and
store its first row only, and recompute that row (every row's arithmetic,
none of its device-memory traffic past the first); `fwdblock` sends every
forward shape to the block-row kernel, its first design. `nowgrad`, `nomem` and
`fwdnomem` write wrong outputs and exist only to be timed; `block` and
`fwdblock` are right, and timed beside the checkout's kernels. Each copy
builds under `build/talking_heads_variants/<name>/` (all builds side by side)
and is timed in a process of its own, in the order given and then in
reverse. Prints one JSON line a run: the kernels each entry point takes and
CUDA-event ms a launch of the backward (both stages; mean of 50 after 5
warm-up) and of the forward (`fwd_ms`: 50 launches captured in a CUDA graph,
mean of 5 replays; `fwd_host_paced_ms`: the plain loop, as the backward).
`--sass` prints the opcode counts of the warp-row forward's row loop as
`cuobjdump` reads it from the checkout's library.
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
FWD_ROW_KERNEL = "talking_heads_fwd_row_kernel"
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
    # the first row's offset, opaque to the compiler, so that every row's loads and stores
    # still run (from and to L1 and L2) and no arithmetic leaves the loop
    "fwdnomem": [("talking_heads.cu",
                  "const int64_t next_base = row_base<H>(next < rows ? next : row, q_len, k_len, hs);",
                  "int64_t next_base = row_base<H>(first, q_len, k_len, hs);\n"
                  "    asm volatile(\"\" : \"+l\"(next_base));", (FWD_ROW_KERNEL,))],
    "fwdblock": [("talking_heads.cu",
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


def time_kernels() -> dict:
    import numpy as np
    import torch
    from passl_tpu_torch.ops import talking_heads as th
    from passl_tpu_torch.utils.cuda_timing import graph_ms, loop_ms

    n, h, q, k = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = (torch.randn(SHAPE, generator=gen, device="cuda") * 3.0).to(torch.bfloat16)
    dp = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    rng = np.random.RandomState(0)
    wl, ww = (torch.tensor(rng.randn(h, h) * 0.2 + np.eye(h), dtype=torch.float32, device="cuda")
              for _ in range(2))
    with torch.inference_mode():
        return {"kernel": th.talking_heads_bwd_kernel_for(h, k, s.dtype),
                "fwd_kernel": th.talking_heads_fwd_kernel_for(h, k, s.dtype),
                "bwd_ms": loop_ms(lambda: th.talking_heads_softmax_bwd(s, dp, wl, ww)),
                "fwd_ms": graph_ms(lambda: th.talking_heads_softmax(s, wl, ww)),
                "fwd_host_paced_ms": loop_ms(lambda: th.talking_heads_softmax(s, wl, ww))}


# CaiT's warp-row forward: bf16, h = 8, two groups of four columns a lane
SASS_KERNEL = "talking_heads_fwd_row_kernelI13__nv_bfloat16Li8ELi2E"


def sass_loop_counts() -> dict:
    """Opcode counts of the warp-row forward's row loop as compiled into this
    checkout's library (`cuobjdump -sass`): the instructions from the target
    of the kernel's longest backward branch to that branch. Both access paths
    (8-byte and 2-byte) are in it; the mixes and the softmax appear once."""
    import collections
    import re

    from passl_tpu_torch.ops import _build

    _build.load()
    lib = _build.build_info["path"]
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    body = sass[sass.index(SASS_KERNEL):]
    body = body[:body.find("Function :") if "Function :" in body else len(body)]
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    edges = [(a, int(m.group(1), 16)) for a, t in ins
             if (m := re.search(r"BRA(?:\.\w+)? (?:UR\d+, )?0x([0-9a-f]+)", t))]
    end, start = max(((a, b) for a, b in edges if b < a), key=lambda e: e[0] - e[1])
    ops = collections.Counter(re.sub(r"^@!?U?P\w+ ", "", t).split()[0].split(".")[0]
                              for a, t in ins if start <= a <= end)
    return {"kernel": SASS_KERNEL, "loop_instructions": sum(ops.values()),
            "ops": dict(ops.most_common())}


def main(argv: list[str]) -> None:
    if argv[:1] == ["--sass"]:  # the checkout's library
        sys.path.insert(0, str(REPO))
        print(json.dumps(sass_loop_counts()), flush=True)
        return
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
