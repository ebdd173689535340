"""Build the CUDA kernels under `passl_tpu_torch/csrc/` and load them.

`nvcc` compiles every `csrc/*.cu` for `sm_90a` (Hopper), one process per
source, all started together, and links the objects into one shared
library with a plain C interface, at first use, into
`build/passl_tpu_torch_kernels/` at the repo root. The library's name is a
hash of the sources and flags, so an edited source builds anew and an
unchanged one loads at once. `ctypes` binds it; nothing here includes
PyTorch's headers, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "passl_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last `load` did: nvcc commands, seconds, compiler output, library path
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH: "
                           "the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    """Hash of the flags and of every source and header under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, srcs: list[Path], out: Path) -> tuple[list[list[str]], str]:
    """One `nvcc -c` per source, run side by side, then one link into `out`."""
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = ""
    failed = []
    for cmd, proc in zip(cmds, procs):
        out_text, _ = proc.communicate()
        log += out_text
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    if not failed:
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(out),
                *map(str, objs)]
        cmds.append(link)
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(link)}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + log)
    return cmds, log


@functools.cache
def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; bind its functions."""
    srcs = _sources()
    lib_path = BUILD_DIR / f"libpassl_tpu_torch_{_digest()}.so"
    t0 = time.perf_counter()
    cmds: list[list[str]] = []
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmds, log = _compile(_nvcc(), srcs, tmp)
        os.replace(tmp, lib_path)  # atomic: another process sees the whole library or none
    lib = ctypes.CDLL(str(lib_path))
    build_info.update(path=str(lib_path), commands=cmds, log=log,
                      seconds=time.perf_counter() - t0, built=bool(cmds))

    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.passl_talking_heads_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.passl_talking_heads_fwd.restype = i32
    lib.passl_talking_heads_fwd_row_kernel.argtypes = [i32, i32, i32]
    lib.passl_talking_heads_fwd_row_kernel.restype = i32
    # dtype, h, k, device, int[5] out
    lib.passl_talking_heads_fwd_row_resources.argtypes = [i32, i32, i32, i32, vp]
    lib.passl_talking_heads_fwd_row_resources.restype = i32
    lib.passl_talking_heads_max_k.argtypes = []
    lib.passl_talking_heads_max_k.restype = i32
    lib.passl_talking_heads_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                            i32, i32, i32, i32, i32, i32, vp]
    lib.passl_talking_heads_bwd.restype = i32
    lib.passl_talking_heads_bwd_blocks.argtypes = [i32, i32]
    lib.passl_talking_heads_bwd_blocks.restype = i64
    lib.passl_talking_heads_bwd_row_kernel.argtypes = [i32, i32, i32]
    lib.passl_talking_heads_bwd_row_kernel.restype = i32
    # dtype, h, k, device, int[5] out
    lib.passl_talking_heads_bwd_row_resources.argtypes = [i32, i32, i32, i32, vp]
    lib.passl_talking_heads_bwd_row_resources.restype = i32
    lib.passl_window_attention_fwd.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, i32, vp]
    lib.passl_window_attention_fwd.restype = i32
    lib.passl_window_attention_bwd.argtypes = [vp] * 11 + [i32] * 5 + [f32, i32, i32, vp]
    lib.passl_window_attention_bwd.restype = i32
    lib.passl_window_attention_bwd_blocks.argtypes = [i32, i32]
    lib.passl_window_attention_bwd_blocks.restype = i64
    # (q, k, v, outputs...), n, L, h, d, strides s_b, s_l, s_h of q/k/v, scale, dtype, device, stream
    geometry = [i32] * 4 + [i64] * 3 + [f32, i32, i32, vp]
    lib.passl_flash_attention_fwd.argtypes = [vp] * 6 + geometry
    lib.passl_flash_attention_fwd.restype = i32
    lib.passl_flash_attention_dkv.argtypes = [vp] * 9 + geometry
    lib.passl_flash_attention_dkv.restype = i32
    lib.passl_flash_attention_dq.argtypes = [vp] * 8 + geometry
    lib.passl_flash_attention_dq.restype = i32
    # dtype, d, device, int[5] out / which, dtype, d, device, int[5] out
    lib.passl_flash_attention_fwd_resources.argtypes = [i32, i32, i32, vp]
    lib.passl_flash_attention_fwd_resources.restype = i32
    lib.passl_flash_attention_bwd_resources.argtypes = [i32, i32, i32, i32, vp]
    lib.passl_flash_attention_bwd_resources.restype = i32
    # img, draws, chan, out, N, H, W, C, taps, blur_prob, solarize_prob, smin, span, threshold,
    # device, stream
    lib.passl_fused_augment.argtypes = [vp] * 4 + [i32] * 5 + [f32] * 5 + [i32, vp]
    lib.passl_fused_augment.restype = i32
    # H, W, C, taps -> 2 the fast kernel, 1 the generic kernel, 0 none
    lib.passl_fused_augment_path.argtypes = [i32] * 4
    lib.passl_fused_augment_path.restype = i32
    # H, W, C, taps, device, int[5] out
    lib.passl_fused_augment_resources.argtypes = [i32] * 5 + [vp]
    lib.passl_fused_augment_resources.restype = i32
    return lib
