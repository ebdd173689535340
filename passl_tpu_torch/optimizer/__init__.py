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
`LarsMomentumOptimizer` too) run as `MomentumLARS` below; `Frozen` gets no
state and no update. The JAX package's other rules (MomentumLARC, Adan,
Adafactor) are not ported yet and raise.
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

from ..utils.convert import flax_path

LrFn = Callable[[int], float]
RULES = ("AdamW", "Momentum", "MomentumLARS", "LarsMomentumOptimizer", "Frozen")


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
            torch_groups.append({"params": params, "weight_decay": g.weight_decay, "lr": 0.0})
            self._stepped.append(g)
        self.torch_optimizer = None
        if torch_groups:
            self.torch_optimizer = (torch.optim.AdamW(torch_groups, lr=0.0, **rule_kwargs)
                                    if rule == "AdamW" else MomentumLARS(torch_groups,
                                                                         **rule_kwargs))

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

    kwargs = _adamw_kwargs(cfg) if name == "AdamW" else _momentum_kwargs(name, cfg)
    return ParamGroupOptimizer(groups, assignment, named_params, kwargs, rule=name)
