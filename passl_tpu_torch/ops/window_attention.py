"""Fused window attention: the CUDA kernels' wrappers and their plain versions.

Swin's window attention over B window groups of L tokens (L = pack * ws^2):

    out = softmax(q k^T * scale + bias[h] + mask[b % nWm]) v

`fused_window_attention` is differentiable in q, k, v and bias through one
`torch.autograd.Function`, the counterpart of the custom VJP in
`passl_tpu/ops/pallas/window_attention.py:166-205`: on CUDA tensors its
forward is one launch of `csrc/window_attention.cu` and its backward one
launch of `csrc/window_attention_bwd.cu` (plus its fixed-order dbias
reduction), which recomputes p from q, k, bias and mask; nothing else is
saved. The mask is a constant and gets no gradient. On CPU tensors the same
Function runs the plain versions, `window_attention_ref` and
`window_attention_bwd_ref`, the f32 formulas of the Pallas `_fwd_kernel`
(`:75-101`) and `_bwd_kernel` (`:104-142`):

- s = (q k^T in f32) * scale + (bias + mask): the scale applies after the
  f32 product (the JAX einsum path scales q first);
- p = softmax(s) in f32, cast to q's type before p v;
- dv = pd^T do with pd = p at q's type; dp = do v^T in f32;
  ds = p (dp - sum_k dp p) in f32; dq, dk from dsd = (ds * scale) at q's
  type; dbias = ds summed over all B groups, unscaled, in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_L, MAX_D = 128, 64  # the kernels' limits: every window-7 Swin config has L <= 98, d <= 64


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _check_mask(mask: Optional[torch.Tensor], b: int, lq: int, lk: int) -> None:
    if mask is None:
        return
    if mask.dim() != 3 or tuple(mask.shape[1:]) != (lq, lk):
        raise ValueError(f"window attention: mask must be [nWm, {lq}, {lk}], got {tuple(mask.shape)}")
    if b % mask.shape[0]:
        raise ValueError(f"window attention: nWm={mask.shape[0]} must divide B={b} "
                         "(groups laid out [images, nWm] row-major)")


def _scores(q, k, bias, mask, scale):
    """s = (q k^T in f32) * scale + (bias + mask[b % nWm]), [B, h, Lq, Lk] f32."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    _check_mask(mask, b, lq, lk)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is None:
        return s + bias.float()[None]
    add = bias.float()[None] + mask.float()[:, None]  # [nWm, h, Lq, Lk]
    n = mask.shape[0]
    return (s.view(b // n, n, h, lq, lk) + add[None]).view(b, h, lq, lk)


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain forward: f32 scores and softmax, p at q's type for p v; out at q's type."""
    p = torch.softmax(_scores(q, k, bias, mask, _scale(q, scale)), dim=-1)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def window_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor], do: torch.Tensor, *,
                             scale: Optional[float] = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: (dq, dk, dv at their inputs' types, dbias [h, Lq, Lk] f32)."""
    scale = _scale(q, scale)
    dt = q.dtype
    p = torch.softmax(_scores(q, k, bias, mask, scale), dim=-1)
    dof = do.float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsd = (ds * scale).to(dt).float()
    dq = torch.matmul(dsd, k.float())
    dk = torch.matmul(dsd.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(0)


def _check(q, k, v, bias, mask) -> None:
    name = "fused_window_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q, k, v must be one of {sorted(map(str, _DTYPE_CODES))}, "
                        f"got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, h, L, d], got {tuple(q.shape)}")
    for t, tn in ((k, "k"), (v, "v")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: the kernel takes {tn} of q's shape, type and device "
                             f"{tuple(q.shape)} {q.dtype} {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    b, h, l, d = q.shape
    if l > MAX_L or d > MAX_D:
        raise ValueError(f"{name}: the kernel takes L <= {MAX_L} and d <= {MAX_D}, "
                         f"got L={l}, d={d}")
    if tuple(bias.shape) != (h, l, l) or bias.device != q.device:
        raise ValueError(f"{name}: bias must be [{h}, {l}, {l}] on {q.device}, "
                         f"got {tuple(bias.shape)} on {bias.device}")
    _check_mask(mask, b, l, l)
    if mask is not None and mask.device != q.device:
        raise ValueError(f"{name}: mask must be on {q.device}, got {mask.device}")
    if b * h >= 2**31:
        raise ValueError(f"{name}: B*h={b * h} exceeds the grid")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().to(torch.float32).contiguous()


def _launch_fwd(q, k, v, bias, mask, scale: float) -> torch.Tensor:
    """One launch of the forward kernel (CUDA tensors only; no autograd)."""
    _check(q, k, v, bias, mask)
    b, h, l, d = q.shape
    bias32, mask32 = _f32(bias), _f32(mask)
    out = torch.empty_like(q)
    rc = _build.load().passl_window_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias32.data_ptr(),
        mask32.data_ptr() if mask32 is not None else None, out.data_ptr(),
        b, h, l, d, mask32.shape[0] if mask32 is not None else 0, scale,
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    if rc != 0:
        raise RuntimeError(f"fused_window_attention: launch failed with cudaError {rc} "
                           f"for q {tuple(q.shape)} {q.dtype}")
    fused_window_attention.launches += 1
    return out


def fused_window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, mask: Optional[torch.Tensor], do: torch.Tensor,
                               *, scale: Optional[float] = None
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel and its fixed-order dbias reduction
    (CUDA tensors only): (dq, dk, dv at q's type, dbias [h, L, L] f32), dbias
    bitwise the same on every launch with the same inputs."""
    _check(q, k, v, bias, mask)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"fused_window_attention_bwd: do must match q {tuple(q.shape)} {q.dtype} "
                         f"on {q.device}, got {tuple(do.shape)} {do.dtype} on {do.device}")
    if not do.is_contiguous():
        raise ValueError("fused_window_attention_bwd: do must be contiguous")
    lib = _build.load()
    b, h, l, d = q.shape
    bias32, mask32 = _f32(bias), _f32(mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partials = torch.empty((lib.passl_window_attention_bwd_blocks(b, h), l, l),
                           dtype=torch.float32, device=q.device)
    dbias = torch.empty((h, l, l), dtype=torch.float32, device=q.device)
    rc = lib.passl_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias32.data_ptr(),
        mask32.data_ptr() if mask32 is not None else None, do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partials.data_ptr(), dbias.data_ptr(),
        b, h, l, d, mask32.shape[0] if mask32 is not None else 0, _scale(q, scale),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    if rc != 0:
        raise RuntimeError(f"fused_window_attention_bwd: launch failed with cudaError {rc} "
                           f"for q {tuple(q.shape)} {q.dtype}")
    fused_window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


fused_window_attention_bwd.launches = 0  # backward kernel launches since the last reset


class FusedWindowAttention(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale = scale
        if q.device.type == "cpu":
            return window_attention_ref(q, k, v, bias, mask, scale=scale)
        return _launch_fwd(q, k, v, bias, mask, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv, dbias = window_attention_bwd_ref(q, k, v, bias, mask, do, scale=ctx.scale)
        else:
            dq, dk, dv, dbias = fused_window_attention_bwd(q, k, v, bias, mask, do, scale=ctx.scale)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                dbias.to(bias.dtype) if need[3] else None, None, None)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """out = softmax(q k^T * scale + bias + mask) v, scores never in device memory.

    q, k, v: [B, h, L, d] f32/bf16/f16 (the kernel takes k and v of q's shape,
    contiguous, L <= 128, d <= 64); bias: [h, L, L], differentiable;
    mask: [nWm, L, L] constant or None, nWm dividing B, group b taking mask
    b % nWm; scale defaults to d ** -0.5. Returns [B, h, L, d] at q's type. A
    CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    or raises.
    """
    return FusedWindowAttention.apply(q, k, v, bias, mask, _scale(q, scale))


fused_window_attention.launches = 0  # forward kernel launches since the last reset
