"""Talking-heads softmax: the CUDA kernel's wrapper and its plain version.

CaiT's TalkingHeadAttention wraps the softmax in two head mixes:

    p[g] = sum_i proj_w[i, g] * softmax_k( sum_j proj_l[j, i] * s[j] )

over scores s [n, h, q, k]. `talking_heads_softmax` runs it on the card as
one pass (`csrc/talking_heads.cu`, the counterpart of
`passl_tpu/ops/pallas/talking_heads.py::talking_heads_softmax`);
`talking_heads_softmax_ref` is the three-op chain in f32. Forward only:
the kernel path refuses tensors that need a gradient.
"""
from __future__ import annotations

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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (s, proj_l, proj_w)):
        raise RuntimeError("talking_heads_softmax: the CUDA kernel is forward only; "
                           "call it under torch.no_grad() or torch.inference_mode()")
    if n * q >= 2**31:
        raise ValueError(f"talking_heads_softmax: n*q={n * q} rows exceed the grid")


def talking_heads_softmax(s: torch.Tensor, proj_l: torch.Tensor,
                          proj_w: torch.Tensor) -> torch.Tensor:
    """p = proj_w-mix(softmax_k(proj_l-mix(s))), read once and written once.

    s: [n, h, q, k] scores, f32/bf16/f16, contiguous; proj_l, proj_w: [h, h]
    (out[g] = sum_i w[i, g] in[i]). Returns p at s.dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.
    """
    if s.device.type == "cpu":
        return talking_heads_softmax_ref(s, proj_l, proj_w)
    _check(s, proj_l, proj_w)
    lib = _build.load()
    n, h, q, k = s.shape
    if k > lib.passl_talking_heads_max_k():
        raise ValueError(f"talking_heads_softmax: k={k} exceeds {lib.passl_talking_heads_max_k()}")
    wl = proj_l.to(torch.float32).contiguous()
    ww = proj_w.to(torch.float32).contiguous()
    out = torch.empty_like(s)
    rc = lib.passl_talking_heads_fwd(
        s.data_ptr(), wl.data_ptr(), ww.data_ptr(), out.data_ptr(), n, h, q, k,
        _DTYPE_CODES[s.dtype], s.device.index, torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"talking_heads_softmax: launch failed with cudaError {rc} "
                           f"for s {tuple(s.shape)} {s.dtype}")
    talking_heads_softmax.launches += 1
    return out


talking_heads_softmax.launches = 0  # kernel launches since the last reset

