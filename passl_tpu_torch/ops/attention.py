"""Attention for the ViT family: the einsum path and flash attention.

Counterpart of `passl_tpu/ops/attention.py`. Both paths take q, k, v as
`[n, l, h, d]` (the layout the `Attention` modules produce) and return
`[n, l, h*d]`:

- `einsum_attention`: materialised scores, as JAX `:101-108`: q * scale at
  the compute type before the product, the scores and softmax at
  `softmax_dtype`, p at `out_dtype` for p v.
- `flash_attention`: the online softmax of the JAX library kernel
  (`jax.experimental.pallas.ops.tpu.flash_attention`) that JAX `:111-153`
  calls, through one `torch.autograd.Function`. On CUDA tensors its forward
  is one launch of `csrc/flash_attention.cu` and its backward one launch of
  each kernel of `csrc/flash_attention_bwd.cu` (dK/dV, then dQ), after
  `di = sum_d o * do` in f32; the scores never reach device memory. On CPU
  tensors the same Function runs the plain versions, `flash_attention_fwd_ref`
  and `flash_attention_bwd_ref` (split as the kernels are, into
  `flash_attention_dkv_ref` and `flash_attention_dq_ref`): the library
  kernels' f32 formulas with their rounding points,

  - forward: s = (q k^T in f32) * scale; m = max_k s, l = sum_k exp(s - m);
    o = (exp(s - m) at v's type) v * (1 / l), o at q's type;
  - backward: p = exp(s - m) * (1 / l); dv = (p at do's type)^T do;
    ds = ((do v^T in f32) - di) * p * scale; dk = (ds at do's type)^T q;
    dq = (ds at k's type) k; all sums in f32.

  Saved for the backward: q, k, v, o and the two f32 row statistics m and
  l, `[n, h, l]` each, as the library keeps them: the backward recomputes p
  with the library's own formula, so keeping them costs no rounding (one
  log-sum-exp would round p once more, about 1e-7 relative).

  The kernels need no padding: they mask the ragged last tile themselves,
  which computes the same function as the JAX wrapper's padding to 128
  tokens with segment ids. They read q, k and v as strided views of the
  `qkv` projection `[n, l, 3, h, d]`, so the three are never copied.

`resolve_attn_impl` keeps the JAX rules (`:49-84`), with one deliberate
difference: the JAX package runs einsum wherever the backend is not a TPU,
while the port runs `flash` on any device, through the kernels on CUDA
tensors and through their plain versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import warnings
from typing import Union

import torch

from . import _build

_LANES = 128
# `auto` turns to flash only from this many tokens, as in the JAX package
_FLASH_AUTO_MIN_SEQ = 4096
MAX_D = 128  # the kernels' limits: d <= 128 and d % 8 == 0
_TILE = 64  # the kernels' smallest tile: no grid has more than n * h * ceil(l / 64) blocks
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DtypeLike = Union[str, torch.dtype]


def resolve_attn_impl(impl: str, seq_len: int, attn_drop: float = 0.0,
                      deterministic: bool = True) -> str:
    """Map a config-level impl name to the one this call uses.

    `flash` needs no attention dropout in this call (the kernels have none)
    and at least 65 tokens (the JAX package's rule: below that the padding to
    128 lanes would double the work); otherwise it falls back to einsum with
    the JAX package's warning. `auto` is einsum below 4,096 tokens.
    """
    if impl not in ("einsum", "flash", "auto"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    no_dropout = deterministic or attn_drop == 0.0
    flash_ok = no_dropout and seq_len >= _LANES // 2 + 1
    if impl == "flash":
        if not flash_ok:
            reason = ("attention dropout is active (kernel has no dropout)" if not no_dropout
                      else f"sequence too short ({seq_len})")
            warnings.warn(f"attn_impl=flash falling back to einsum: {reason}", stacklevel=2)
        return "flash" if flash_ok else "einsum"
    if impl == "auto":
        return "flash" if (flash_ok and seq_len >= _FLASH_AUTO_MIN_SEQ) else "einsum"
    return "einsum"


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     softmax_dtype: torch.dtype, out_dtype: torch.dtype) -> torch.Tensor:
    """[n, l, h, d] q, k, v -> [n, l, h*d]; the scores at softmax_dtype."""
    n, l, h, d = q.shape
    ct = torch.promote_types(q.dtype, softmax_dtype)  # an einsum with preferred_element_type
    qs = (q * scale).transpose(1, 2).to(ct)
    attn = torch.matmul(qs, k.transpose(1, 2).to(ct).transpose(-1, -2)).to(softmax_dtype)
    attn = torch.softmax(attn, dim=-1).to(out_dtype)
    out = torch.matmul(attn, v.transpose(1, 2).to(out_dtype))  # [n, h, l, d]
    return out.transpose(1, 2).reshape(n, l, h * d)


# ------------------------------------------------------------ plain versions


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    return t.float().transpose(1, 2)  # [n, l, h, d] -> [n, h, l, d] f32


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """s = (q k^T in f32) * scale, [n, h, l, l]."""
    return torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2)) * scale


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain forward: (o [n, l, h, d] contiguous at q's type, m, l [n, h, l] f32)."""
    s = _scores(q, k, scale)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    lsum = e.sum(dim=-1)
    o = torch.matmul(e.to(v.dtype).float(), _heads_first(v)) * (1.0 / lsum)[..., None]
    return o.transpose(1, 2).to(q.dtype).contiguous(), m, lsum


def _probs(q: torch.Tensor, k: torch.Tensor, m: torch.Tensor, lsum: torch.Tensor,
           scale: float) -> torch.Tensor:
    """p = exp(s - m) * (1 / l) from the forward's row statistics, [n, h, l, l] f32."""
    return torch.exp(_scores(q, k, scale) - m[..., None]) * (1.0 / lsum)[..., None]


def _dscores(p: torch.Tensor, v: torch.Tensor, do: torch.Tensor, di: torch.Tensor,
             scale: float) -> torch.Tensor:
    """ds = ((do v^T in f32) - di) * p * scale, [n, h, l, l] f32."""
    dp = torch.matmul(_heads_first(do), _heads_first(v).transpose(-1, -2))
    return (dp - di[..., None]) * p * scale


def flash_attention_dkv_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                            m: torch.Tensor, lsum: torch.Tensor, di: torch.Tensor, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dK/dV: (dk, dv) [n, l, h, d] at their inputs' types."""
    p = _probs(q, k, m, lsum, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), _heads_first(do))
    ds = _dscores(p, v, do, di, scale)
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), _heads_first(q))
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def flash_attention_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                           m: torch.Tensor, lsum: torch.Tensor, di: torch.Tensor, scale: float
                           ) -> torch.Tensor:
    """Plain dQ: dq [n, l, h, d] at q's type."""
    ds = _dscores(_probs(q, k, m, lsum, scale), v, do, di, scale)
    return torch.matmul(ds.to(k.dtype).float(), _heads_first(k)).transpose(1, 2).to(q.dtype)


def flash_attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = sum_d o * do in f32, [n, h, l] (plain torch, as the JAX VJP computes it)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            m: torch.Tensor, lsum: torch.Tensor, do: torch.Tensor, scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward from the forward's o, m and l, split as the kernels are:
    (dq, dk, dv) [n, l, h, d] at their inputs' types."""
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, m, lsum, di, scale)
    return flash_attention_dq_ref(q, k, v, do, m, lsum, di, scale), dk, dv


# ------------------------------------------------------------------ kernels


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q, k, v must be one of {sorted(map(str, _DTYPE_CODES))}, "
                        f"got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [n, l, h, d], got {tuple(q.shape)}")
    for t, tn in ((k, "k"), (v, "v")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: the kernel takes {tn} of q's shape, type and device "
                             f"{tuple(q.shape)} {q.dtype} {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")
        if t.stride() != q.stride():
            raise ValueError(f"{name}: q, k and v must share their strides (views of one qkv "
                             f"tensor, or contiguous), got {q.stride()} and {tn} {t.stride()}")
    n, l, h, d = q.shape
    if d > MAX_D or d % 8:
        raise ValueError(f"{name}: the kernel takes d <= {MAX_D} with d % 8 == 0, got d={d}")
    if q.stride(-1) != 1 or any(s % 8 for s in q.stride()[:3]):
        raise ValueError(f"{name}: q, k, v need a contiguous last dim and row strides that are "
                         f"multiples of 8, got strides {q.stride()}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on 16-byte boundaries")
    blocks = n * h * -(-l // _TILE)
    if blocks >= 2**31:
        raise ValueError(f"{name}: n*h*ceil(l/{_TILE})={blocks} exceeds the grid")


def _check_device(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {q.device}")


def _check_rows(name: str, q: torch.Tensor, **rows: torch.Tensor) -> None:
    """do [n, l, h, d] at q's type and contiguous; m, l [n, h, l] f32 contiguous."""
    n, l, h, d = q.shape
    for tn, t in rows.items():
        want = ((n, l, h, d), q.dtype) if tn == "do" else ((n, h, l), torch.float32)
        if (tuple(t.shape), t.dtype) != want or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {tn} must be {want[0]} {want[1]} contiguous on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _geometry(q: torch.Tensor) -> tuple:
    n, l, h, d = q.shape
    return (n, l, h, d, *q.stride()[:3])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel (CUDA tensors only; no autograd):
    (o [n, l, h, d] contiguous at q's type, m, l [n, h, l] f32)."""
    _check("flash_attention", q, k, v)
    _check_device("flash_attention", q)
    n, l, h, d = q.shape
    o = torch.empty((n, l, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((n, h, l), dtype=torch.float32, device=q.device)
    lsum = torch.empty_like(m)
    rc = _build.load().passl_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(), lsum.data_ptr(),
        *_geometry(q), float(scale), _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed with cudaError {rc} "
                           f"for q {tuple(q.shape)} {q.dtype}")
    flash_attention.launches += 1
    return o, m, lsum


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                        m: torch.Tensor, lsum: torch.Tensor, di: torch.Tensor, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dK/dV kernel (CUDA tensors only): (dk, dv) [n, l, h, d]
    contiguous at q's type, the same bits on every launch with the same inputs."""
    name = "flash_attention_dkv"
    _check(name, q, k, v)
    _check_rows(name, q, do=do, m=m, l=lsum, di=di)
    _check_device(name, q)
    dk, dv = torch.empty_like(do), torch.empty_like(do)
    rc = _build.load().passl_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), lsum.data_ptr(),
        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_geometry(q), float(scale),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {rc} for q {tuple(q.shape)} {q.dtype}")
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       m: torch.Tensor, lsum: torch.Tensor, di: torch.Tensor, scale: float
                       ) -> torch.Tensor:
    """One launch of the dQ kernel (CUDA tensors only): dq [n, l, h, d]
    contiguous at q's type, the same bits on every launch with the same inputs."""
    name = "flash_attention_dq"
    _check(name, q, k, v)
    _check_rows(name, q, do=do, m=m, l=lsum, di=di)
    _check_device(name, q)
    dq = torch.empty_like(do)
    rc = _build.load().passl_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), lsum.data_ptr(),
        di.data_ptr(), dq.data_ptr(), *_geometry(q), float(scale),
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {rc} for q {tuple(q.shape)} {q.dtype}")
    flash_attention_dq.launches += 1
    return dq


def flash_kernel_resources(kernel: str, dtype: torch.dtype, d: int, device: int = 0) -> dict:
    """What the tensor-core kernel `kernel` ("fwd", "dkv" or "dq") takes at
    `dtype` (bf16 or f16) and head dim d on the card: registers a thread, shared
    memory bytes a block, blocks an SM, spilled (local) bytes a thread and warps
    a block."""
    if kernel not in ("fwd", "dkv", "dq") or dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_kernel_resources: no tensor-core kernel {kernel!r} at {dtype}")
    out = (ctypes.c_int * 5)()
    lib = _build.load()
    code = _DTYPE_CODES[dtype]
    if kernel == "fwd":
        rc = lib.passl_flash_attention_fwd_resources(code, d, device, out)
    else:
        rc = lib.passl_flash_attention_bwd_resources(int(kernel == "dq"), code, d, device, out)
    if rc != 0:
        raise RuntimeError(f"flash_kernel_resources: cudaError {rc} for {kernel} {dtype} d={d}")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm", "spill_bytes", "warps"), out))


flash_attention_dkv.launches = 0  # dK/dV kernel launches since the last reset
flash_attention_dq.launches = 0  # dQ kernel launches since the last reset


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        m: torch.Tensor, lsum: torch.Tensor, do: torch.Tensor, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on CUDA tensors: di in plain torch, then one launch of
    the dK/dV kernel and one of the dQ kernel. Returns (dq, dk, dv)."""
    di = flash_attention_di(o, do)
    dk, dv = flash_attention_dkv(q, k, v, do, m, lsum, di, scale)
    return flash_attention_dq(q, k, v, do, m, lsum, di, scale), dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, m, lsum = flash_attention_fwd_ref(q, k, v, scale)
        else:
            o, m, lsum = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, m, lsum)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, lsum = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            return (*flash_attention_bwd_ref(q, k, v, o, m, lsum, do, ctx.scale), None)
        return (*flash_attention_bwd(q, k, v, o, m, lsum, do, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    out_dtype: DtypeLike = None) -> torch.Tensor:
    """Flash attention over [n, l, h, d] q, k, v -> [n, l, h*d] at out_dtype
    (default q's type), differentiable in q, k and v.

    A CUDA tensor launches the kernels (f32, bf16 or f16; k and v of q's
    shape, type and strides; d <= 128, d % 8 == 0) or raises; a CPU tensor
    takes the plain versions.
    """
    n, l, h, d = q.shape
    out = FlashAttention.apply(q, k, v, float(scale)).reshape(n, l, h * d)
    return out if out_dtype is None else out.to(out_dtype)


flash_attention.launches = 0  # forward kernel launches since the last reset


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *,
                         impl: str = "einsum", softmax_dtype: torch.dtype = torch.float32,
                         out_dtype: DtypeLike = None) -> torch.Tensor:
    """Dispatch to a resolved impl ("einsum" | "flash"); [n, l, h*d] at
    out_dtype (default q's type)."""
    out_dtype = out_dtype or q.dtype
    if impl == "flash":
        return flash_attention(q, k, v, scale, out_dtype)
    return einsum_attention(q, k, v, scale, softmax_dtype, out_dtype)
