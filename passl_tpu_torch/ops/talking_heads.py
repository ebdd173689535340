"""Talking-heads softmax: the CUDA kernels' wrappers and their plain versions.

CaiT's TalkingHeadAttention wraps the softmax in two head mixes:

    p[g] = sum_i proj_w[i, g] * softmax_k( sum_j proj_l[j, i] * s[j] )

over scores s [n, h, q, k]. `talking_heads_softmax` is differentiable in all
three arguments through one `torch.autograd.Function`, the counterpart of the
custom VJP in `passl_tpu/ops/pallas/talking_heads.py`: on CUDA tensors its
forward is one pass of `csrc/talking_heads.cu` and its backward one pass of
`csrc/talking_heads_bwd.cu`, which recomputes the softmax from s (nothing but
s and the weights is saved). Each C entry point picks one of two kernels by
shape (`talking_heads_fwd_kernel_for`, `talking_heads_bwd_kernel_for`): the
warp-row kernel for bf16 / f16 scores with h <= 8 and k <= 256 (CaiT at
224), the block-row kernel otherwise. On CPU tensors the same Function runs the plain
versions, `talking_heads_softmax_ref` and `talking_heads_softmax_bwd_ref`,
the f32 formulas of the two Pallas kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SUPPORTED_HEADS = (4, 6, 8, 16)


def talking_heads_softmax_ref(s: torch.Tensor, proj_l: torch.Tensor,
                              proj_w: torch.Tensor) -> torch.Tensor:
    """Plain version: mix, softmax, mix in f32; the result at s.dtype."""
    a = torch.einsum("nhqk,hg->ngqk", s.float(), proj_l.float())
    a = torch.softmax(a, dim=-1)
    return torch.einsum("nhqk,hg->ngqk", a, proj_w.float()).to(s.dtype)


def talking_heads_softmax_bwd_ref(s: torch.Tensor, dp: torch.Tensor, proj_l: torch.Tensor,
                                  proj_w: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward, the f32 formula of the Pallas `_bwd_kernel`: returns
    (ds at s.dtype, dproj_l f32, dproj_w f32) for the incoming gradient dp."""
    s32, dp32, wl, ww = s.float(), dp.float(), proj_l.float(), proj_w.float()
    p_mid = torch.softmax(torch.einsum("nhqk,hg->ngqk", s32, wl), dim=-1)
    dp_mid = torch.einsum("ngqk,hg->nhqk", dp32, ww)
    ds_mid = p_mid * (dp_mid - (dp_mid * p_mid).sum(-1, keepdim=True))
    ds = torch.einsum("ngqk,hg->nhqk", ds_mid, wl)
    dwl = torch.einsum("nhqk,ngqk->hg", s32, ds_mid)
    dww = torch.einsum("nhqk,ngqk->hg", p_mid, dp32)
    return ds.to(s.dtype), dwl, dww


def _check(s: torch.Tensor, proj_l: torch.Tensor, proj_w: torch.Tensor) -> None:
    if s.device.type != "cuda":
        raise ValueError(f"talking_heads_softmax: the kernel takes CUDA tensors, got {s.device}")
    if s.dtype not in _DTYPE_CODES:
        raise TypeError(f"talking_heads_softmax: scores must be one of "
                        f"{sorted(map(str, _DTYPE_CODES))}, got {s.dtype}")
    if s.dim() != 4:
        raise ValueError(f"talking_heads_softmax: scores must be [n, h, q, k], got {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("talking_heads_softmax: scores must be contiguous")
    n, h, q, k = s.shape
    if h not in SUPPORTED_HEADS:
        raise ValueError(f"talking_heads_softmax: h={h} not in {SUPPORTED_HEADS}")
    for name, w in (("proj_l", proj_l), ("proj_w", proj_w)):
        if tuple(w.shape) != (h, h) or w.device != s.device:
            raise ValueError(f"talking_heads_softmax: {name} must be [{h}, {h}] on {s.device}, "
                             f"got {tuple(w.shape)} on {w.device}")
    if n * q >= 2**31:
        raise ValueError(f"talking_heads_softmax: n*q={n * q} rows exceed the grid")
    max_k = _build.load().passl_talking_heads_max_k()
    if k > max_k:
        raise ValueError(f"talking_heads_softmax: k={k} exceeds {max_k}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(s: torch.Tensor, proj_l: torch.Tensor, proj_w: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel (CUDA tensors only; no autograd)."""
    _check(s, proj_l, proj_w)
    n, h, q, k = s.shape
    wl = proj_l.detach().to(torch.float32).contiguous()
    ww = proj_w.detach().to(torch.float32).contiguous()
    out = torch.empty_like(s)
    rc = _build.load().passl_talking_heads_fwd(
        s.data_ptr(), wl.data_ptr(), ww.data_ptr(), out.data_ptr(), n, h, q, k,
        _DTYPE_CODES[s.dtype], s.device.index, _stream(s))
    if rc != 0:
        raise RuntimeError(f"talking_heads_softmax: launch failed with cudaError {rc} "
                           f"for s {tuple(s.shape)} {s.dtype}")
    talking_heads_softmax.launches += 1
    return out


def talking_heads_softmax_bwd(s: torch.Tensor, dp: torch.Tensor, proj_l: torch.Tensor,
                              proj_w: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel and its fixed-order weight-gradient
    reduction (CUDA tensors only): (ds at s.dtype, dproj_l f32, dproj_w f32),
    bitwise the same on every launch with the same inputs."""
    _check(s, proj_l, proj_w)
    if dp.shape != s.shape or dp.dtype != s.dtype or dp.device != s.device:
        raise ValueError(f"talking_heads_softmax_bwd: dp must match s {tuple(s.shape)} {s.dtype} "
                         f"on {s.device}, got {tuple(dp.shape)} {dp.dtype} on {dp.device}")
    if not dp.is_contiguous():
        raise ValueError("talking_heads_softmax_bwd: dp must be contiguous")
    lib = _build.load()
    n, h, q, k = s.shape
    wl = proj_l.detach().to(torch.float32).contiguous()
    ww = proj_w.detach().to(torch.float32).contiguous()
    ds = torch.empty_like(s)
    partials = torch.empty((lib.passl_talking_heads_bwd_blocks(n, q), 2 * h * h),
                           dtype=torch.float32, device=s.device)
    dwl = torch.empty((h, h), dtype=torch.float32, device=s.device)
    dww = torch.empty((h, h), dtype=torch.float32, device=s.device)
    rc = lib.passl_talking_heads_bwd(
        s.data_ptr(), dp.data_ptr(), wl.data_ptr(), ww.data_ptr(), ds.data_ptr(),
        partials.data_ptr(), dwl.data_ptr(), dww.data_ptr(), n, h, q, k,
        _DTYPE_CODES[s.dtype], s.device.index, _stream(s))
    if rc != 0:
        raise RuntimeError(f"talking_heads_softmax_bwd: launch failed with cudaError {rc} "
                           f"for s {tuple(s.shape)} {s.dtype}")
    talking_heads_softmax_bwd.launches += 1
    return ds, dwl, dww


talking_heads_softmax_bwd.launches = 0  # backward kernel launches since the last reset


def _kernel_for(which: str, h: int, k: int, dtype: torch.dtype) -> str:
    takes = getattr(_build.load(), f"passl_talking_heads_{which}_row_kernel")
    return "warp-row" if takes(h, k, _DTYPE_CODES[dtype]) else "block-row"


def _resources(which: str, dtype: torch.dtype, h: int, k: int, device: int) -> dict:
    out = (ctypes.c_int * 5)()
    query = getattr(_build.load(), f"passl_talking_heads_{which}_row_resources")
    rc = query(_DTYPE_CODES[dtype], h, k, device, out)
    if rc != 0:
        raise RuntimeError(f"talking_heads_{which}_resources: cudaError {rc} for {dtype} "
                           f"h={h} k={k}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm", "spill_bytes", "warps"), out))


def talking_heads_fwd_kernel_for(h: int, k: int, dtype: torch.dtype) -> str:
    """The forward kernel the C entry point launches for [., h, ., k] at
    `dtype`: "warp-row" or "block-row"."""
    return _kernel_for("fwd", h, k, dtype)


def talking_heads_bwd_kernel_for(h: int, k: int, dtype: torch.dtype) -> str:
    """The backward kernel the C entry point launches for [., h, ., k] at
    `dtype`: "warp-row" or "block-row"."""
    return _kernel_for("bwd", h, k, dtype)


def talking_heads_fwd_resources(dtype: torch.dtype, h: int, k: int, device: int = 0) -> dict:
    """What the warp-row forward kernel takes at `dtype`, h and k on the card:
    registers a thread, shared memory bytes a block, blocks an SM, spilled
    (local) bytes a thread and warps a block."""
    return _resources("fwd", dtype, h, k, device)


def talking_heads_bwd_resources(dtype: torch.dtype, h: int, k: int, device: int = 0) -> dict:
    """What the warp-row backward kernel takes at `dtype`, h and k on the card,
    as `talking_heads_fwd_resources` reads the forward's."""
    return _resources("bwd", dtype, h, k, device)


class TalkingHeadsSoftmax(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, s, proj_l, proj_w):
        ctx.save_for_backward(s, proj_l, proj_w)
        if s.device.type == "cpu":
            return talking_heads_softmax_ref(s, proj_l, proj_w)
        return _launch_fwd(s, proj_l, proj_w)

    @staticmethod
    def backward(ctx, dp):
        s, proj_l, proj_w = ctx.saved_tensors
        dp = dp.to(s.dtype).contiguous()
        if s.device.type == "cpu":
            ds, dwl, dww = talking_heads_softmax_bwd_ref(s, dp, proj_l, proj_w)
        else:
            ds, dwl, dww = talking_heads_softmax_bwd(s, dp, proj_l, proj_w)
        need_s, need_l, need_w = ctx.needs_input_grad
        return (ds if need_s else None, dwl.to(proj_l.dtype) if need_l else None,
                dww.to(proj_w.dtype) if need_w else None)


def talking_heads_softmax(s: torch.Tensor, proj_l: torch.Tensor,
                          proj_w: torch.Tensor) -> torch.Tensor:
    """p = proj_w-mix(softmax_k(proj_l-mix(s))), read once and written once.

    s: [n, h, q, k] scores, f32/bf16/f16, contiguous; proj_l, proj_w: [h, h]
    (out[g] = sum_i w[i, g] in[i]). Returns p at s.dtype, differentiable in
    all three. A CPU tensor takes the plain versions; a CUDA tensor launches
    the kernels or raises.
    """
    return TalkingHeadsSoftmax.apply(s, proj_l, proj_w)


talking_heads_softmax.launches = 0  # forward kernel launches since the last reset
