"""Mixture-of-experts MLP (counterpart of `passl_tpu/nn/moe.py:49-221`).

GShard-style capacity-bounded top-k routing with static shapes: the router
gives each token a softmax over E experts in float32 (whatever the compute
dtype), `topk_dispatch` turns the gates into one-hot dispatch and combine
tensors `[T, E, C]` (a token's place in an expert's C slots taken in token
order, tokens past the capacity dropped, the kept choices' gates
renormalised), the experts run as one batched product over the stacked
weights `[E, C, d] x [E, d, h]`, and the combine weights sum their outputs
back. The dispatch and combine einsums and the expert products are plain
`torch.einsum`s: the JAX package leaves them to XLA outside any Pallas
kernel.

`MoEMlp` keeps flax's parameter names and layouts (`router [d, E]`,
`w1 [E, d, h]`, `b1 [E, h]`, `w2 [E, h, d]`, `b2 [E, d]`), so
`utils.convert.flax_to_torch` carries them over verbatim, and routes over
groups of whole images (`group_size` tokens at most) as JAX does. Its
auxiliary outputs are `moe_aux_loss` (aux_weight times the Switch
load-balance loss), `moe_balance` (that loss unweighted: 1 at perfect
balance) and, with `z_weight > 0`, the ST-MoE router z-loss `moe_z_loss`.

Not ported yet: the explicit expert parallelism of the JAX file
(`expert_parallel_ffn`, `make_expert_parallel_mlp`: a mesh and all_to_all),
and dropout (`drop > 0` raises).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.amp import at_least_f32
from . import init as tinit
from .layers import gelu


def moe_capacity(num_tokens: int, num_experts: int, k: int, capacity_factor: float) -> int:
    """Per-expert token capacity, ceil(k T / E cf) rounded up to a multiple of
    8 (at least 8), as the JAX package rounds it."""
    c = int(math.ceil(k * num_tokens / num_experts * capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def topk_dispatch(gates: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bounded top-k routing of gates `[..., T, E]` (rows sum to 1)
    -> (combine `[..., T, E, C]` at the gates' dtype, dispatch `[..., T, E, C]`
    bool, first_choice `[..., T, E]` one-hot), each leading index a group of
    its own. Choice j of every token is the largest gate not taken yet (the
    first expert on a tie); its place in the expert is the count of earlier
    tokens' choices there (earlier rounds first), counted in int32; a place
    at or past `capacity` is dropped. The kept gates are renormalised over a
    token's kept choices (a token that keeps none has a zero combine row).
    Gradients reach the gates through the kept gate values and their sum
    alone."""
    e = gates.shape[-1]
    remaining = gates
    count = torch.zeros(gates.shape[:-2] + (e,), dtype=torch.int32, device=gates.device)
    slots = torch.arange(capacity, device=gates.device)
    chosen = []
    first_choice = None
    for _ in range(k):
        ioh = F.one_hot(remaining.argmax(-1), e).to(torch.int32)  # [..., T, E]
        onehot = ioh.to(gates.dtype)
        if first_choice is None:
            first_choice = onehot
        pos = torch.cumsum(ioh, dim=-2, dtype=torch.int32) - 1 + count[..., None, :]
        count = count + ioh.sum(-2, dtype=torch.int32)
        loc = (pos * ioh).sum(-1, dtype=torch.int32)  # [..., T]
        keep = (loc < capacity).to(gates.dtype)
        gval = (gates * onehot).sum(-1) * keep
        chosen.append((onehot, loc, gval))
        remaining = remaining * (1.0 - onehot)
    denom = sum(g for _, _, g in chosen)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    combine = None
    for onehot, loc, gval in chosen:
        loc_oh = (loc[..., None] == slots).to(gates.dtype)  # zeros where loc >= capacity
        term = (gval / denom)[..., None, None] * (onehot[..., :, None] * loc_oh[..., None, :])
        combine = term if combine is None else combine + term
    return combine, combine > 0.0, first_choice


def load_balance_loss(gates: torch.Tensor, first_choice: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer load balance E sum_e f_e P_e over gates `[T, E]`:
    f_e the share of tokens whose first choice is e, P_e the mean gate of e;
    1 at perfect balance."""
    e = gates.shape[-1]
    return e * (first_choice.mean(0) * gates.mean(0)).sum()


def expert_ffn(xe: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor) -> torch.Tensor:
    """Each expert's two-layer FFN (tanh GELU between) over its slots: xe
    `[E, C, d]`, w1 `[E, d, h]`, w2 `[E, h, d]`, computed at xe's dtype."""
    dt = xe.dtype
    h = gelu(torch.einsum("ecd,edh->ech", xe, w1.to(dt)) + b1[:, None, :].to(dt))
    return torch.einsum("ech,ehd->ecd", h, w2.to(dt)) + b2[:, None, :].to(dt)


def group_tokens(n: int, s: int, group_size: int) -> int:
    """Tokens a routing group holds for n images of s tokens: the most whole
    images whose tokens fit `group_size` and whose count divides n (one image
    at least); every token at once when `group_size` is 0 or covers them all."""
    t = n * s
    if group_size and group_size < t:
        m = max(mm for mm in range(1, max(group_size // s, 1) + 1) if n % mm == 0)
        return m * s
    return t


class MoEMlp(nn.Module):
    """x `[n, s, d]` -> (y `[n, s, d]` at x's dtype, aux dict of f32 scalars):
    the drop-in mixture-of-experts replacement of `layers.Mlp` (V-MoE). As in
    JAX the experts compute at the input's dtype (the block's LayerNorm gives
    the model's), the router at f32 or wider."""

    def __init__(self, dim: int, num_experts: int = 8, k: int = 2,
                 capacity_factor: float = 1.25, hidden_features: Optional[int] = None,
                 drop: float = 0.0, aux_weight: float = 0.01, z_weight: float = 0.0,
                 group_size: int = 256):
        super().__init__()
        if drop:
            raise NotImplementedError("MoEMlp: dropout (drop > 0) is not ported yet")
        hidden = hidden_features or dim
        self.num_experts, self.k, self.capacity_factor = num_experts, k, capacity_factor
        self.aux_weight, self.z_weight, self.group_size = aux_weight, z_weight, group_size
        self.router = nn.Parameter(torch.empty(dim, num_experts))
        self.w1 = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.empty(num_experts, hidden))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.b2 = nn.Parameter(torch.empty(num_experts, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        tinit.normal_(self.router, std=0.02, generator=generator)
        for w in (self.w1, self.w2):  # xavier-uniform over [d, h], the expert axis a batch axis
            bound = math.sqrt(6.0 / (w.shape[1] + w.shape[2]))
            tinit.uniform_(w, -bound, bound, generator=generator)
        tinit.zeros_(self.b1)
        tinit.zeros_(self.b2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        n, s, d = x.shape
        e = self.num_experts
        tg = group_tokens(n, s, self.group_size)
        g = n * s // tg
        cap = moe_capacity(tg, e, self.k, self.capacity_factor)
        xt = x.reshape(g, tg, d)
        # the router in f32 (f64 for a model run in f64) whatever the compute dtype
        xr = at_least_f32(xt)
        logits = torch.einsum("gtd,de->gte", xr, self.router.to(xr.dtype))
        gates = torch.softmax(logits, dim=-1)
        combine, dispatch, first = topk_dispatch(gates, self.k, cap)
        xe = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xt)
        ye = expert_ffn(xe.reshape(e, g * cap, d), self.w1, self.b1, self.w2, self.b2)
        y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), ye.reshape(e, g, cap, d))
        balance = load_balance_loss(gates.reshape(-1, e), first.reshape(-1, e))
        aux = {"moe_aux_loss": self.aux_weight * balance, "moe_balance": balance}
        if self.z_weight > 0.0:
            aux["moe_z_loss"] = self.z_weight * torch.logsumexp(logits, dim=-1).square().mean()
        return y.reshape(n, s, d), aux
