"""Time `fused_augment` at BYOL's two views on the card, and split the fast
kernel's time into its parts.

    python tests/perf/augment_kernels_cuda.py                                # this checkout
    python tests/perf/augment_kernels_cuda.py full nomem novert nohorz first  # and edited copies
    python tests/perf/augment_kernels_cuda.py full b224x2 b224x3               # other block shapes
    python tests/perf/augment_kernels_cuda.py --sass                         # the compiled nests

Each name but `full` is an edited copy of `passl_tpu_torch/`. `nomem` has
every block read and write image 0's band in place of its own image's: the
same work, with its device-memory traffic turned into L2 hits. `novert`
skips the vertical pass's FFMA nest (the staging stays, the tile takes
zeros), `nohorz` the horizontal pass's loads and FFMA nest (the epilogue and
stores stay). These three write wrong outputs and exist only to be timed.
`first` sends every shape to the generic kernel, the first design;
`b224x2` and `b224x3` give the fast kernel blocks of 224 threads with a
launch bound of 2 or 3 blocks an SM (the checkout's: 192 threads, 3
blocks). These three are right, and timed beside the checkout's. Each copy
builds under `build/augment_variants/<name>/` (all builds side by side)
and is timed in a process of its own, in the order given and then in
reverse. Prints one JSON line a run: the resources of the kernel that
takes the shape, and ms a launch at view 1 (every image blurred) and view
2 (blur 0.1, solarize 0.2) of `[128, 224, 224, 3]` uint8, each from 50
launches captured in one CUDA graph, the mean of 5 replays. `--sass`
prints, for the fast kernel at BYOL's (taps 23, C 3), the opcode counts of
the whole kernel and of each loop (a backward branch) as `cuobjdump` reads
them from the checkout's library.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SHAPE = (128, 224, 224, 3)  # one view of BYOL's per-card batch
VIEWS = {"view1": dict(blur_prob=1.0, solarize_prob=0.0),
         "view2": dict(blur_prob=0.1, solarize_prob=0.2)}
FAST = "augment_fast_kernel"
BLOCK = "constexpr int kFastThreads = 192;\nconstexpr int kFastBlocks = 3;"
# variant: [(source, anchor, replacement, the kernels whose code holds the anchor)];
# every occurrence of an anchor is replaced
EDITS = {
    "nomem": [("augment.cu", "  const int64_t image = (int64_t)n * H * wc;",
               "  int64_t image = 0;\n  asm volatile(\"\" : \"+l\"(image));", (FAST,))],
    "novert": [("augment.cu", "    vertical_pass<R>(", "    if (false) vertical_pass<R>(", (FAST,))],
    "nohorz": [("augment.cu", "    horz_taps<R, C>(", "    if (false) horz_taps<R, C>(", (FAST,))],
    "first": [("augment.cu", "  if (fast_takes(W, C, taps)) return 2;", "", ())],
    "b224x2": [("augment.cu", BLOCK, BLOCK.replace("192", "224").replace("= 3", "= 2"), ())],
    "b224x3": [("augment.cu", BLOCK, BLOCK.replace("192", "224"), ())],
}
BUILD = "from passl_tpu_torch.ops import _build; _build.load()"


def variant_root(name: str) -> Path:
    """The directory whose passl_tpu_torch/ a run imports: the checkout, or an edited copy."""
    if name == "full":
        return REPO
    root = REPO / "build" / "augment_variants" / name
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
    from passl_tpu_torch.ops.augment_kernel import (fused_augment_draws, fused_augment_resources,
                                                    fused_augment_with_draws)
    from passl_tpu_torch.utils.cuda_timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randint(0, 256, SHAPE, generator=gen, device="cuda", dtype=torch.uint8)
    u = fused_augment_draws(SHAPE[0], 2, imgs.device)
    out = {"resources": fused_augment_resources(*SHAPE[1:], 23)}
    with torch.inference_mode():
        for view, kw in VIEWS.items():
            out[f"{view}_ms"] = graph_ms(lambda: fused_augment_with_draws(imgs, u, **kw))
    return out


SASS_KERNEL = "augment_fast_kernelILi11ELi3EE"  # the fast kernel at R = 11, C = 3


def sass_counts() -> dict:
    """Opcode counts of the fast kernel at BYOL's (taps 23, C 3) as compiled
    into this checkout's library (`cuobjdump -sass`): the whole kernel, and
    each loop, the instructions from a backward branch's target to the branch."""
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

    def counts(lo: int, hi: int) -> dict:
        ops = collections.Counter(re.sub(r"^@!?U?P\w+ ", "", t).split()[0].split(".")[0]
                                  for a, t in ins if lo <= a <= hi)
        return {"instructions": sum(ops.values()), "ops": dict(ops.most_common(12))}

    loops = sorted({(int(m.group(1), 16), a) for a, t in ins
                    if (m := re.search(r"BRA(?:\.\w+)? (?:UR\d+, )?0x([0-9a-f]+)", t))
                    and int(m.group(1), 16) < a})
    return {"kernel": SASS_KERNEL, "whole": counts(0, ins[-1][0]),
            "loops": [{"from": hex(lo), "to": hex(hi), **counts(lo, hi)} for lo, hi in loops]}


def main(argv: list[str]) -> None:
    if argv[:1] == ["--sass"]:  # the checkout's library
        sys.path.insert(0, str(REPO))
        print(json.dumps(sass_counts()), flush=True)
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
