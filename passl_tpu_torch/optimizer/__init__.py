"""Param-group optimizer and its factory.

Counterpart of `passl_tpu/optimizer/{__init__,base,transforms}.py`. Group
membership is decided once for each parameter by the JAX package's rules:
`param_group` regexes (first match wins, with `lr_scale`, `weight_decay`,
`lr_func` and `freeze_steps`), `no_weight_decay_name` regexes,
`one_dim_param_no_weight_decay` by `ndim`, `layerwise_decay` through
`layer_id_from_path`, and the frozen group. The JAX builder matches a
config's regexes against flax paths (`prototypes/kernel`), so here a
config's regex (`param_group`, `no_weight_decay_name`, the `Optimizer`
block's `frozen_patterns`) selects a parameter when it matches either its
dotted name (`prototypes.weight`) or its flax path (`utils.convert.flax_path`);
the patterns a model hands over (`frozen_patterns=`, and the
`optimizer_overrides` the engine appends to `param_group`) are dotted.
Before every step each group's lr is set to its schedule's value at the
global step times its `lr_scale` (zero while `step < freeze_steps`), as
`ParamGroupOptimizer.apply` computes it; a frozen-for-now group still runs
its rule at lr 0, so its momentum accumulates over the freeze as in JAX.

Rules: `AdamW` (decoupled weight decay, the JAX rule's
`p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`) runs as
`torch.optim.AdamW` over the groups; `Momentum` (L2 weight decay
`g + wd * p`, `buf = m * buf + g`, optional Nesterov) and `MomentumLARS`
(`passl_tpu/optimizer/transforms.py:84-135`; its v110 name
`LarsMomentumOptimizer` too) run as `MomentumLARS` below; `MomentumLARC`,
`Adan` and `Adafactor` (`transforms.py:139-246`) run as the optimizers of
those names below, each parameter's update the JAX rule's at the global
step, with its state under the JAX rule's names and an f32 `master` copy of
a bf16 or f16 parameter, read and written as `Rule._read` / `_write` do;
`Frozen` gets no state and no update. Their hyperparameters are taken as
the JAX rule factory takes them (`passl_tpu/optimizer/__init__.py:23-42`).
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..utils.convert import flax_path

LrFn = Callable[[int], float]
RULES = ("AdamW", "Momentum", "MomentumLARS", "LarsMomentumOptimizer", "MomentumLARC", "Adan",
         "Adafactor", "Frozen")


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    rule: str
    weight_decay: float = 0.0
    lr_scale: float = 1.0
    lr_fn: Optional[LrFn] = None  # the group's own schedule (param_group lr_func)
    freeze_steps: int = 0  # lr forced to 0 while step < freeze_steps


def match_any(path: str, patterns: Sequence[str]) -> bool:
    return any(re.search(pat, path) for pat in patterns)


def _match_either(names: Sequence[str], patterns: Sequence[str]) -> bool:
    return any(match_any(n, patterns) for n in names)


def layer_id_from_path(path: str, num_layers: int) -> int:
    """Layer index for layer-wise lr decay: embeddings and cls -> 0, block i
    -> i + 1, head and norm -> num_layers + 1."""
    if re.search(r"(cls_token|pos_embed|patch_embed|mask_token)", path):
        return 0
    m = re.search(r"blocks?[_./](\d+)", path)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def _adamw_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The AdamW hyperparameters from the config's torch/paddle spellings;
    other keys are left alone, as the JAX package's rule factory leaves them."""
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    if "betas" in cfg:
        beta1, beta2 = float(cfg["betas"][0]), float(cfg["betas"][1])
    beta1 = float(cfg.get("beta1", beta1))
    beta2 = float(cfg.get("beta2", beta2))
    eps = float(cfg.get("epsilon", cfg.get("eps", eps)))
    return {"betas": (beta1, beta2), "eps": eps}


def _momentum_kwargs(name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The Momentum / MomentumLARS hyperparameters under the JAX rule
    factory's aliases (`lars_coeff`, `trust_coeff`, `use_nesterov`, `eps`)."""
    alias = {"momentum": "momentum", "use_nesterov": "nesterov", "nesterov": "nesterov",
             "lars_coeff": "trust_coefficient", "trust_coefficient": "trust_coefficient",
             "trust_coeff": "trust_coefficient", "eps": "epsilon", "epsilon": "epsilon",
             "always_adapt": "always_adapt"}
    accepted = ({"momentum", "nesterov"} if name == "Momentum" else
                {"momentum", "trust_coefficient", "epsilon", "always_adapt"})
    out = {alias[k]: v for k, v in cfg.items() if alias.get(k) in accepted}
    return {"lars": name != "Momentum", **out}


class MomentumLARS(torch.optim.Optimizer):
    """SGD with momentum and L2 weight decay, with LARS's layer-wise trust
    ratio when `lars` is set: per tensor of ndim > 1 (every tensor with
    `always_adapt`), q = tc |p| / (|g| + wd |p| + eps), or 1 when |p| or the
    denominator is 0; then g <- (g + wd p) q, buf <- m buf + g, p <- p - lr buf
    (Nesterov: p <- p - lr (g + m buf)), the momentum buffer in f32. Each
    group's `lr` and `weight_decay` are its own."""

    def __init__(self, params, momentum: float = 0.9, trust_coefficient: float = 0.001,
                 epsilon: float = 0.0, always_adapt: bool = False, nesterov: bool = False,
                 lars: bool = True):
        defaults = dict(lr=0.0, weight_decay=0.0, momentum=float(momentum),
                        trust_coefficient=float(trust_coefficient), epsilon=float(epsilon),
                        always_adapt=bool(always_adapt), nesterov=bool(nesterov), lars=lars)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, wd, m = group["lr"], group["weight_decay"], group["momentum"]
            grads = [p.grad.float() for p in params]
            if wd:
                grads = list(torch._foreach_add(grads, params, alpha=wd))
            if group["lars"]:
                adapt = [i for i, p in enumerate(params) if p.dim() > 1 or group["always_adapt"]]
                if adapt:
                    p_norm = torch.stack(torch._foreach_norm([params[i] for i in adapt]))
                    g_norm = torch.stack(torch._foreach_norm([p.grad.float() for p in
                                                              (params[i] for i in adapt)]))
                    denom = g_norm + wd * p_norm + group["epsilon"]
                    ok = (p_norm > 0) & (denom > 0)
                    q = torch.where(ok, group["trust_coefficient"] * p_norm
                                    / torch.where(ok, denom, torch.ones_like(denom)),
                                    torch.ones_like(denom))
                    scaled = torch._foreach_mul([grads[i] for i in adapt], list(q.unbind()))
                    for i, g in zip(adapt, scaled):
                        grads[i] = g
            bufs = []
            for p, g in zip(params, grads):
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
                bufs.append(state["momentum_buffer"])
            torch._foreach_mul_(bufs, m)
            torch._foreach_add_(bufs, grads)
            if group["nesterov"]:
                torch._foreach_add_(params, torch._foreach_add(grads, bufs, alpha=m), alpha=-lr)
            else:
                torch._foreach_add_(params, bufs, alpha=-lr)
        return None


# the JAX rules' fields and defaults (`passl_tpu/optimizer/transforms.py:139-246`)
_RULE_FIELDS = {
    "MomentumLARC": dict(momentum=0.9, trust_coefficient=0.02, epsilon=1e-8, clip=True),
    "Adan": dict(beta1=0.98, beta2=0.92, beta3=0.99, epsilon=1e-8),
    "Adafactor": dict(epsilon1=1e-30, epsilon2=1e-3, clip_threshold=1.0, decay_rate=0.8,
                      beta1=None),
}
_RULE_ALIAS = {"eps": "epsilon", "lars_coeff": "trust_coefficient",
               "trust_coeff": "trust_coefficient"}


def _rule_kwargs(name: str, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A rule's hyperparameters from the config as the JAX `_make_rule` takes
    them: `betas` gives beta1 and beta2 (its third entry is not read), the
    torch/paddle spellings are aliased, and keys the rule lacks are dropped."""
    kwargs: Dict[str, Any] = {}
    for k, v in cfg.items():
        if k == "betas":
            kwargs["beta1"], kwargs["beta2"] = float(v[0]), float(v[1])
        else:
            kwargs[_RULE_ALIAS.get(k, k)] = v
    return {k: v for k, v in kwargs.items() if k in _RULE_FIELDS[name]}


class _MasterRule(torch.optim.Optimizer):
    """A JAX `Rule` as a torch optimizer: each group's `lr`, `weight_decay` and
    `global_step` (set before every step), and `update(p, g32, p32, state,
    group)` returning the new f32 parameter. A bf16 or f16 parameter keeps an
    f32 `master` copy in its state, which the rule reads and writes, the
    parameter its rounding (`Rule._read` / `_write`)."""

    def __init__(self, params, **hyper):
        super().__init__(params, dict(lr=0.0, weight_decay=0.0, global_step=0, **hyper))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            names = group.get("names") or [None] * len(group["params"])
            for p, name in zip(group["params"], names):
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self.init_state(p, name, state)
                    if p.dtype in (torch.bfloat16, torch.float16):
                        state["master"] = p.detach().float()
                p32 = state["master"] if "master" in state else p.detach().float()
                new = self.update(name, p.grad.float(), p32, state, group)
                if "master" in state:
                    state["master"] = new
                p.copy_(new)
        return None

    def load_state_dict(self, state_dict: dict) -> None:
        """As torch's, but each state tensor keeps its saved dtype (torch casts
        floating state to its parameter's, which would round a bf16
        parameter's f32 master and moments)."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        for idx, saved in state_dict["state"].items():
            p = params[idx]
            for k, v in saved.items():
                if torch.is_tensor(v):
                    self.state[p][k] = v.to(device=p.device)

    def init_state(self, p: torch.Tensor, name: Optional[str], state: dict) -> None:
        raise NotImplementedError

    def update(self, name: Optional[str], g: torch.Tensor, p32: torch.Tensor, state: dict,
               group: dict) -> torch.Tensor:
        raise NotImplementedError


class MomentumLARC(_MasterRule):
    """LARC (`transforms.py:139-164`): over every tensor, q = tc |p| / (|g| +
    wd |p| + eps), with `clip` min(q / max(lr, 1e-12), 1); 1 where |p| or |g|
    is 0; g <- (g + wd p) q, buf <- m buf + g, p <- p - lr buf."""

    def __init__(self, params, momentum: float = 0.9, trust_coefficient: float = 0.02,
                 epsilon: float = 1e-8, clip: bool = True):
        super().__init__(params, momentum=float(momentum),
                         trust_coefficient=float(trust_coefficient), epsilon=float(epsilon),
                         clip=bool(clip))

    def init_state(self, p, name, state):
        state["buf"] = torch.zeros_like(p, dtype=torch.float32)

    def update(self, name, g, p32, state, group):
        lr, wd = group["lr"], group["weight_decay"]
        p_norm, g_norm = torch.linalg.vector_norm(p32), torch.linalg.vector_norm(g)
        adaptive = group["trust_coefficient"] * p_norm / (g_norm + wd * p_norm + group["epsilon"])
        if group["clip"]:
            adaptive = torch.clamp(adaptive / max(lr, 1e-12), max=1.0)
        q = torch.where((p_norm > 0) & (g_norm > 0), adaptive, torch.ones_like(adaptive))
        buf = state["buf"].mul_(group["momentum"]).add_((g + wd * p32) * q)
        return p32 - lr * buf


class Adan(_MasterRule):
    """Adan (`transforms.py:167-197`): the previous gradient is g itself at
    step 0; m, v (of the gradient's difference) and n (of (g + b2 diff)^2)
    with their bias corrections at t = step + 1; p <- (p - lr / (sqrt(n_hat) +
    eps) (m_hat + b2 v_hat)) / (1 + lr wd), the decay decoupled."""

    def __init__(self, params, beta1: float = 0.98, beta2: float = 0.92, beta3: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__(params, beta1=float(beta1), beta2=float(beta2), beta3=float(beta3),
                         epsilon=float(epsilon))

    def init_state(self, p, name, state):
        for k in ("m", "v", "n", "prev_g"):
            state[k] = torch.zeros_like(p, dtype=torch.float32)

    def update(self, name, g, p32, state, group):
        lr, wd, step = group["lr"], group["weight_decay"], group["global_step"]
        b1, b2, b3 = group["beta1"], group["beta2"], group["beta3"]
        diff = g - (g if step == 0 else state["prev_g"])
        m = state["m"].mul_(b1).add_(g, alpha=1 - b1)
        v = state["v"].mul_(b2).add_(diff, alpha=1 - b2)
        n = state["n"].mul_(b3).add_((g + b2 * diff).square(), alpha=1 - b3)
        state["prev_g"] = g.clone()  # g may be the gradient itself, which a caller reuses
        t = step + 1
        eta = lr / ((n / (1 - b3 ** t)).sqrt() + group["epsilon"])
        return (p32 - eta * (m / (1 - b1 ** t) + b2 * (v / (1 - b2 ** t)))) / (1 + lr * wd)


def flax_layout(name: Optional[str], ndim: int) -> Optional[tuple]:
    """The permutation that takes a parameter to its flax layout, where the two
    differ: a Dense kernel [out, in] -> [in, out], a Conv kernel OIHW -> HWIO
    (a transposed conv's IOHW comes out HWOI, its two channel axes swapped,
    which Adafactor's factoring treats alike); None otherwise."""
    if name is None or flax_path(name, ndim).rsplit("/", 1)[-1] != "kernel":
        return None
    return (1, 0) if ndim == 2 else (2, 3, 1, 0)


class Adafactor(_MasterRule):
    """Adafactor (`transforms.py:200-246`): at t = step + 1, beta2t = 1 -
    t^-decay_rate; for a tensor of rank 2 or more the second moment factored
    over its last two axes in the flax layout (row and column means of g^2 +
    eps1, `vr` and `vc`, kept in that layout), else a full `v`; the update
    g / sqrt(v) clipped to RMS `clip_threshold`, then with `beta1` its moving
    average; p <- p - lr u - lr wd p. (`epsilon2` is read by neither rule.)"""

    def __init__(self, params, epsilon1: float = 1e-30, epsilon2: float = 1e-3,
                 clip_threshold: float = 1.0, decay_rate: float = 0.8,
                 beta1: Optional[float] = None):
        super().__init__(params, epsilon1=float(epsilon1), epsilon2=float(epsilon2),
                         clip_threshold=float(clip_threshold), decay_rate=float(decay_rate),
                         beta1=None if beta1 is None else float(beta1))

    def init_state(self, p, name, state):
        perm = flax_layout(name, p.dim())
        shape = tuple(p.shape[i] for i in perm) if perm else tuple(p.shape)
        if len(shape) >= 2:
            state["vr"] = p.new_zeros(shape[:-1], dtype=torch.float32)
            state["vc"] = p.new_zeros(shape[:-2] + shape[-1:], dtype=torch.float32)
        else:
            state["v"] = p.new_zeros(shape, dtype=torch.float32)
        if self.defaults["beta1"] is not None:
            state["m"] = torch.zeros_like(p, dtype=torch.float32)

    def update(self, name, g, p32, state, group):
        lr, wd = group["lr"], group["weight_decay"]
        t = np.float32(group["global_step"] + 1)  # in f32, as the JAX rule takes it
        beta2t = float(np.float32(1.0) - np.power(t, np.float32(-group["decay_rate"])))
        perm = flax_layout(name, g.dim())
        gf = g.permute(perm) if perm else g
        g2 = gf.square() + group["epsilon1"]
        if "vr" in state:
            vr = state["vr"].mul_(beta2t).add_(g2.mean(-1), alpha=1 - beta2t)
            vc = state["vc"].mul_(beta2t).add_(g2.mean(-2), alpha=1 - beta2t)
            r = vr / vr.mean(-1, keepdim=True)
            u = gf / (r.sqrt()[..., :, None] * vc.sqrt()[..., None, :])
        else:
            u = gf / state["v"].mul_(beta2t).add_(g2, alpha=1 - beta2t).sqrt()
        if perm:
            u = u.permute(tuple(np.argsort(perm)))
        rms_u = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp(rms_u / group["clip_threshold"], min=1.0)
        if group["beta1"] is not None:
            u = state["m"].mul_(group["beta1"]).add_(u, alpha=1 - group["beta1"])
        return p32 - lr * u - lr * wd * p32


_TORCH_RULES = {"MomentumLARC": MomentumLARC, "Adan": Adan, "Adafactor": Adafactor}


class ParamGroupOptimizer:
    """Static groups over named parameters; `step(lr, step)` updates them."""

    def __init__(self, groups: Sequence[Group], assignment: Dict[str, int],
                 named_params: Mapping[str, torch.nn.Parameter], rule_kwargs: Dict[str, Any],
                 rule: str = "AdamW"):
        self.groups = list(groups)
        self.assignment = dict(assignment)
        torch_groups = []
        self._stepped: List[Group] = []
        for gid, g in enumerate(self.groups):
            params = [p for name, p in named_params.items() if self.assignment[name] == gid]
            if g.rule == "Frozen" or not params:
                continue
            group = {"params": params, "weight_decay": g.weight_decay, "lr": 0.0}
            if rule in _TORCH_RULES:  # Adafactor factors each tensor in its flax layout
                group["names"] = [name for name in named_params if self.assignment[name] == gid]
            torch_groups.append(group)
            self._stepped.append(g)
        self.torch_optimizer = None
        if torch_groups:
            if rule == "AdamW":
                self.torch_optimizer = torch.optim.AdamW(torch_groups, lr=0.0, **rule_kwargs)
            elif rule in _TORCH_RULES:
                self.torch_optimizer = _TORCH_RULES[rule](torch_groups, **rule_kwargs)
            else:
                self.torch_optimizer = MomentumLARS(torch_groups, **rule_kwargs)

    def group_lr(self, g: Group, lr: float, step: int) -> float:
        glr = (g.lr_fn(step) if g.lr_fn is not None else lr) * g.lr_scale
        return 0.0 if g.freeze_steps and step < g.freeze_steps else glr

    def step(self, lr: float, step: int) -> None:
        """One update with the global scheduled `lr` of global step `step`;
        the gradients are the parameters' `.grad`."""
        if self.torch_optimizer is None:
            return
        for pg, g in zip(self.torch_optimizer.param_groups, self._stepped):
            pg["lr"] = self.group_lr(g, lr, step)
            pg["global_step"] = step
        self.torch_optimizer.step()

    def state_dict(self) -> dict:
        return self.torch_optimizer.state_dict() if self.torch_optimizer is not None else {}

    def load_state_dict(self, state: dict) -> None:
        if self.torch_optimizer is not None:
            self.torch_optimizer.load_state_dict(state)

    def group_of(self, name: str) -> Group:
        return self.groups[self.assignment[name]]

    def describe(self) -> str:
        counts: Dict[str, int] = {}
        for gid in self.assignment.values():
            counts[self.groups[gid].name] = counts.get(self.groups[gid].name, 0) + 1
        return ", ".join(f"{k}:{v}" for k, v in sorted(counts.items()))


def build_optimizer(config: Dict[str, Any], named_params: Mapping[str, torch.nn.Parameter],
                    frozen_patterns: Optional[List[str]] = None, num_layers: int = 0,
                    lr_args: Optional[tuple] = None) -> ParamGroupOptimizer:
    """config: the `Optimizer` block (name, weight_decay, no_weight_decay_name,
    one_dim_param_no_weight_decay, layerwise_decay, param_group, rule
    hyperparameters); named_params: e.g. `dict(model.named_parameters())`.
    `lr_args = (epochs, steps_per_epoch[, batch_size])` builds the groups'
    own `lr_func` schedules."""
    cfg = copy.deepcopy(dict(config))
    cfg.pop("tensor_fusion", None)  # buffer layout is PyTorch's, as it was XLA's
    cfg.pop("grad_clip", None)  # handled by core.grad_clip in the step
    name = cfg.pop("name", "Momentum")
    if name not in RULES:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; the port has {RULES}")
    base_wd = float(cfg.pop("weight_decay", 0.0))
    no_wd_names = list(cfg.pop("no_weight_decay_name", []) or [])
    one_dim_no_wd = bool(cfg.pop("one_dim_param_no_weight_decay", False))
    layerwise_decay = cfg.pop("layerwise_decay", None)
    custom_groups = list(cfg.pop("param_group", []) or [])
    frozen_patterns = list(frozen_patterns or [])
    config_frozen = list(cfg.pop("frozen_patterns", []) or [])

    group_lr_fns: Dict[str, Any] = {}
    for cg in custom_groups:
        lf = cg.pop("lr_func", None) or cg.pop("lr_scheduler", None)
        if lf is not None:
            if callable(lf):
                group_lr_fns[cg["name"]] = lf
            else:
                from ..scheduler import build_lr_scheduler

                group_lr_fns[cg["name"]] = build_lr_scheduler(dict(lf), *(lr_args or (1, 1)))

    groups: List[Group] = []
    group_index: Dict[tuple, int] = {}

    def get_group(gname: str, wd: float, lr_scale: float, freeze_steps: int = 0,
                  lr_fn=None) -> int:
        key = (gname, wd, lr_scale, freeze_steps)
        if key not in group_index:
            group_index[key] = len(groups)
            groups.append(Group(name=gname, rule="Frozen" if gname == "frozen" else name,
                                weight_decay=wd, lr_scale=lr_scale, freeze_steps=freeze_steps,
                                lr_fn=lr_fn))
        return group_index[key]

    assignment: Dict[str, int] = {}
    for path, param in named_params.items():
        names = (path, flax_path(path, param.dim()))  # a config regex matches either
        if match_any(path, frozen_patterns) or _match_either(names, config_frozen):
            assignment[path] = get_group("frozen", 0.0, 1.0)
            continue
        wd, lr_scale, freeze_steps, lr_fn, gname = base_wd, 1.0, 0, None, "default"
        for cg in custom_groups:  # custom regex groups take precedence
            if _match_either(names, [cg["name"]]):
                wd = float(cg.get("weight_decay", base_wd))
                lr_scale = float(cg.get("lr_scale", 1.0))
                freeze_steps = int(cg.get("freeze_steps", 0))
                lr_fn = group_lr_fns.get(cg["name"])
                gname = cg["name"]
                break
        if no_wd_names and _match_either(names, no_wd_names):
            wd = 0.0
            gname += "|no_wd"
        if one_dim_no_wd and param.dim() <= 1:
            wd = 0.0
            gname += "|1d_no_wd"
        if layerwise_decay is not None and num_layers > 0:
            lid = layer_id_from_path(path, num_layers)
            lr_scale *= float(layerwise_decay) ** (num_layers + 1 - lid)
            gname += f"|layer{lid}"
        assignment[path] = get_group(gname, wd, lr_scale, freeze_steps, lr_fn)

    if name == "AdamW":
        kwargs = _adamw_kwargs(cfg)
    elif name in _TORCH_RULES:
        kwargs = _rule_kwargs(name, cfg)
    else:
        kwargs = _momentum_kwargs(name, cfg)
    return ParamGroupOptimizer(groups, assignment, named_params, kwargs, rule=name)
