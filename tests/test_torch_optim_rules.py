"""The optimizer rules MomentumLARC, Adan and Adafactor of the PyTorch port
(passl_tpu_torch/optimizer/__init__.py) against the JAX package's
`passl_tpu/optimizer/transforms.py`.

On the CPU, on seed-made numpy parameters and gradients: each rule over 4
steps against the JAX `Rule.update` with f32 parameters and with bf16 ones
(whose f32 master copy both carry): LARC with and without `clip` (a zero
tensor taking the trust ratio 1), Adan (its step-0 previous gradient), and
Adafactor factored (rank 2 and 3), unfactored (rank 1) and with `beta1`; the
hyperparameters the config spellings give, against the JAX rule factory's;
the param-group optimizer with Adafactor over the tiny V-MoE's parameters
against the JAX builder's, the factored moments in the flax layout (a Conv
kernel's channel axes, a Dense kernel's [in, out]); a checkpoint taken mid
run and resumed; and the Adan recipe of
configs/classification/vit_base_patch16_224_adan_in1k.yaml at tiny widths,
3 steps through the JAX engine and the port's from JAX's state.

Tolerances: parameters and states within 1e-5 relative (1e-6 absolute), the
engine's steps as tests/test_torch_deit.py's `assert_step_tracks` holds
AdamW's (every change within a tenth of the lr and 2e-3 of its norm) with
Adan's four moments within 1e-4 of their norms.
"""
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch import optimizer as port_opt
from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import vit_moe as port_vmoe
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)
from test_torch_moe import TINY, randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAN_CFG = os.path.join(REPO, "configs", "classification", "vit_base_patch16_224_adan_in1k.yaml")
SHAPES = {"a": (6, 5), "b": (5,), "c": (2, 3, 4), "z": (3, 4)}

RULES = {
    "larc_clip": ("MomentumLARC", dict(clip=True)),
    "larc_no_clip": ("MomentumLARC", dict(clip=False, trust_coefficient=0.01)),
    "adan": ("Adan", dict(beta3=0.95)),
    "adafactor": ("Adafactor", {}),
    "adafactor_beta1": ("Adafactor", dict(beta1=0.9, clip_threshold=0.5)),
}


def _run_both(name, kw, dtype, shapes, steps=4, seed=0):
    """The JAX rule and the port's optimizer over `steps` steps of the same
    gradients from the same parameters (`z` starts at zero)."""
    import jax.numpy as jnp

    from passl_tpu.optimizer.transforms import RULES as JAX_RULES

    rng = np.random.RandomState(seed)
    p0 = {k: (np.zeros(s) if k == "z" else rng.randn(*s)).astype(np.float32)
          for k, s in shapes.items()}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rule = JAX_RULES[name](**kw)
    jp = {k: jnp.asarray(v.copy(), jdt) for k, v in p0.items()}
    js = {k: rule.init(v) for k, v in jp.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype)) for k, v in p0.items()}
    opt = port_opt._TORCH_RULES[name]([{"params": list(tp.values()), "weight_decay": 0.05}], **kw)
    for step, lr in enumerate([0.1, 0.05, 0.02, 0.01][:steps]):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy()).to(dtype)
        opt.param_groups[0].update(lr=lr, global_step=step)
        opt.step()
        for k in jp:
            jp[k], js[k] = rule.update(jnp.asarray(grads[k].copy(), jdt), js[k], jp[k], lr, 0.05,
                                       step)
    return tp, opt, jp, js


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(RULES))
def test_rule_matches_the_jax_rule(case, dtype):
    name, kw = RULES[case]
    tp, opt, jp, js = _run_both(name, kw, dtype, SHAPES)
    for k, p in tp.items():
        assert p.dtype == dtype
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{case} {k}")
        state = opt.state[p]
        assert set(state) == set(js[k]), (set(state), set(js[k]))
        assert ("master" in state) == (dtype == torch.bfloat16)
        for sk, v in js[k].items():
            np.testing.assert_allclose(state[sk].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} {k} {sk}")
    if name == "Adafactor":  # factored over the last two axes, rank 1 in full
        assert set(opt.state[tp["a"]]) >= {"vr", "vc"} and "v" in opt.state[tp["b"]]
        assert tuple(opt.state[tp["c"]]["vr"].shape) == (2, 3)
        assert tuple(opt.state[tp["c"]]["vc"].shape) == (2, 4)
    if name == "MomentumLARC":  # the zero tensor takes the trust ratio 1: it moves by lr g
        assert tp["z"].detach().abs().max() > 0


def test_rule_hyperparameters_are_the_jax_factorys():
    """The config spellings (`betas`, whose third entry neither reads, `eps`,
    `trust_coeff`, `lars_coeff`) and the rule's own field names, as the JAX
    `_make_rule` takes them; keys a rule lacks are dropped."""
    from passl_tpu.optimizer import _make_rule

    cfgs = {
        "MomentumLARC": [{}, {"momentum": 0.8, "trust_coeff": 0.05, "eps": 1e-6, "clip": False},
                         {"lars_coeff": 0.1, "epsilon": 1e-7, "betas": [0.9, 0.99]}],
        "Adan": [{}, {"betas": [0.98, 0.92, 0.99], "eps": 1e-6},
                 {"beta1": 0.9, "beta3": 0.9, "momentum": 0.5}],
        "Adafactor": [{}, {"beta1": 0.9, "decay_rate": 0.7, "clip_threshold": 2.0},
                      {"betas": [0.8, 0.9], "epsilon1": 1e-20, "eps": 1e-3}],
    }
    for name, items in cfgs.items():
        for cfg in items:
            want = _make_rule(name, dict(cfg))
            got = port_opt._TORCH_RULES[name]([torch.nn.Parameter(torch.zeros(2))],
                                              **port_opt._rule_kwargs(name, dict(cfg))).defaults
            for field in port_opt._RULE_FIELDS[name]:
                assert got[field] == getattr(want, field), (name, cfg, field)


def _vmoe_tree(seed=0):
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.vit_moe import VisionTransformerMoE as JaxVMoE

    jm = JaxVMoE(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    model = port_vmoe.VisionTransformerMoE(**TINY)
    model.load_state_dict(flax_to_torch(params, model))
    return jm, params, model


OPT_CFG = {"name": "Adafactor", "beta1": 0.9, "weight_decay": 0.01,
           "one_dim_param_no_weight_decay": True,
           "param_group": [{"name": "head", "lr_scale": 2.0}]}


def _engine_steps(popt, named, names, grads_of, steps, start=0):
    for step in range(start, start + steps):
        for path, name in names.items():
            g = torch.from_numpy(_torch_name(path, grads_of(step, path))[1].copy())
            named[name].grad = g.to(named[name].dtype)
        popt.step([1e-2, 5e-3, 2e-3, 1e-3][step], step)


def test_param_group_adafactor_matches_the_jax_builder_in_flax_layouts():
    """Adafactor through the param-group optimizer over the tiny V-MoE's
    parameters, 4 steps: every parameter in the port's layout equals JAX's in
    flax's, and each factored moment has JAX's shape and values (the patch
    embedding's Conv kernel factored over its channel axes, the Dense kernels
    over [in, out], the stacked expert kernels as they are)."""
    import jax.numpy as jnp
    from flax import traverse_util

    import passl_tpu.optimizer as jax_opt

    jm, params, model = _vmoe_tree()
    named = dict(model.named_parameters())
    flat = traverse_util.flatten_dict(params, sep="/")
    names = {path: _torch_name(path, np.asarray(v))[0] for path, v in flat.items()}
    jopt = jax_opt.build_optimizer(dict(OPT_CFG), params)
    popt = port_opt.build_optimizer(dict(OPT_CFG), named)
    rs = np.random.RandomState(3)
    grads = [{p: rs.randn(*np.shape(v)).astype(np.float32) for p, v in flat.items()}
             for _ in range(4)]
    jparams, jstate = params, jopt.init(params)
    for step in range(4):
        jparams, jstate = jopt.apply(jparams, traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in grads[step].items()}, sep="/"), jstate,
            jnp.float32([1e-2, 5e-3, 2e-3, 1e-3][step]), jnp.asarray(step))
    _engine_steps(popt, named, names, lambda s, p: grads[s][p], 4)
    state = popt.torch_optimizer.state
    for path, v in traverse_util.flatten_dict(jparams, sep="/").items():
        name = names[path]
        np.testing.assert_allclose(named[name].detach().numpy(), _torch_name(path, np.asarray(v))[1],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        for sk, sv in jstate[path].items():
            got = state[named[name]][sk].numpy()
            want = np.asarray(sv)
            if sk == "m":  # parameter-shaped
                want = _torch_name(path, want)[1]
            assert got.shape == want.shape, (name, sk)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{name} {sk}")
    assert tuple(state[named["patch_embed.proj.weight"]]["vr"].shape) == (8, 8, 3)
    assert tuple(state[named["head.weight"]]["vc"].shape) == (10,)


@pytest.mark.parametrize("name", ["MomentumLARC", "Adan", "Adafactor"])
def test_a_resumed_run_steps_as_the_uninterrupted_one(name, tmp_path):
    """2 steps, the optimizer's state dict through a file into a fresh
    optimizer over fresh parameters, then 2 more: bitwise the 4 steps of one
    run (bf16 parameters: the f32 master copies travel too)."""
    _, params, model = _vmoe_tree(1)
    flat = _flatten(params)
    names = {path: _torch_name(path, np.asarray(v))[0] for path, v in flat.items()}
    rs = np.random.RandomState(4)
    grads = [{p: rs.randn(*np.shape(v)).astype(np.float32) for p, v in flat.items()}
             for _ in range(4)]
    init = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    cfg = {"name": name, "weight_decay": 0.05}

    def fresh():
        m = port_vmoe.VisionTransformerMoE(**TINY, dtype="bfloat16").to(torch.bfloat16)
        m.load_state_dict(init)
        named = dict(m.named_parameters())
        return named, port_opt.build_optimizer(dict(cfg), named)

    named, popt = fresh()
    _engine_steps(popt, named, names, lambda s, p: grads[s][p], 4)
    named2, popt2 = fresh()
    _engine_steps(popt2, named2, names, lambda s, p: grads[s][p], 2)
    torch.save({"opt": popt2.state_dict(), "model": {k: p.detach() for k, p in named2.items()}},
               tmp_path / "ckpt.pt")
    saved = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    named3, popt3 = fresh()
    with torch.no_grad():
        for k, p in named3.items():
            p.copy_(saved["model"][k])
    popt3.load_state_dict(saved["opt"])
    _engine_steps(popt3, named3, names, lambda s, p: grads[s][p], 2, start=2)
    for k, p in named.items():
        assert torch.equal(p, named3[k]), k
        assert "master" in popt3.torch_optimizer.state[named3[k]]


# ---------------------------------------------------- the Adan recipe, tiny

ADAN_TINY = [
    "FP16.enable=False", "Model.img_size=32", "Model.patch_size=8", "Model.embed_dim=64",
    "Model.depth=2", "Model.num_heads=2", "Model.num_classes=10", "Model.drop_path_rate=0.0",
    "DataLoader.Train.dataset={'name': 'SyntheticDataset', 'size': 24, 'image_size': 32, "
    "'num_classes': 10, 'transform': [{'RandFlipImage': {'prob': 0.5}}, "
    "{'NormalizeImage': {'scale': 0.00392157}}]}",
    "DataLoader.Train.sampler.batch_size=8", "DataLoader.Train.loader={'num_workers': 0}",
    "DataLoader.Train.batch_transform=[{'TransformOpSampler': {"
    "'Mixup': {'alpha': 0.8, 'num_classes': 10, 'label_smoothing': 0.1, 'prob': 0.5}, "
    "'Cutmix': {'alpha': 1.0, 'num_classes': 10, 'label_smoothing': 0.1, 'prob': 0.5}}}]",
    "DataLoader.Eval.dataset={'name': 'SyntheticDataset', 'size': 8, 'image_size': 32, "
    "'num_classes': 10, 'transform': [{'NormalizeImage': {'scale': 0.00392157}}]}",
    "DataLoader.Eval.loader={'num_workers': 0}", "LRScheduler.warmup_epoch=0",
]
STEPS = 3


def _adan_state(opt_state, names) -> dict:
    """The JAX Adan state {path: {m, v, n, prev_g}} in the port's names and layouts."""
    out = {}
    for path, leaf in _flatten(opt_state).items():
        head, kind = path.rsplit("/", 1)
        name, arr = _torch_name(head, leaf, names=names)
        out.setdefault(name, {})[kind] = torch.from_numpy(np.array(arr, np.float32))
    return out


@pytest.fixture(scope="module")
def adan_run(tmp_path_factory):
    """The JAX engine's first 3 batches of the tiny Adan recipe, its metrics and
    its state before each step and after the last."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.engine import Engine as JaxEngine
    from passl_tpu_torch.models import build_model

    tmp = tmp_path_factory.mktemp("jax")
    config = cfg_util.get_config(ADAN_CFG, overrides=[f"Global.output_dir={tmp}", *ADAN_TINY])
    port = build_model(dict(config["Model"]))
    je = JaxEngine(config, mode="train")
    # the JAX Adan rule's init hands one zero array to all four moments, which
    # the engine's step, donating its state, refuses ("Attempt to donate the
    # same buffer twice", ROADMAP.md Queue 3): each leaf gets its own copy here
    je.state = je.state.replace(opt_state=jax.tree_util.tree_map(jnp.copy, je.state.opt_state))
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == STEPS:
            break

    def convert(state):
        state = jax.device_get(state)
        return (flax_to_torch(state.params, port),
                _adan_state(state.opt_state, port.state_dict()))

    states, metrics = [convert(je.state)], []
    for b in batches:
        je.state, m = je.train_step(je.state, je.shard_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(convert(je.state))
    je.train_dataloader.close()
    return batches, metrics, states


def test_tiny_adan_recipe_steps_along_the_jax_engine(tmp_path, adan_run):
    """The Adan recipe (betas 0.98 / 0.92, the third beta the rule's default,
    decoupled decay 0.02 but on 1-D parameters and the class and position
    embeddings, the global-norm clip 1, CE with smoothing 0.1 on Mixup /
    Cutmix labels) at tiny widths: each of the JAX engine's 3 steps from JAX's
    state (step 0's previous gradient the gradient itself), the loss, lr and
    grad_norm, every parameter's change and Adan's four moments."""
    batches, jax_metrics, states = adan_run
    e = Engine(cfg_util.get_config(ADAN_CFG, overrides=[f"Global.output_dir={tmp_path}",
                                                        *ADAN_TINY]), mode="train", device="cpu")
    opt = e.optimizer.torch_optimizer
    assert type(opt).__name__ == "Adan" and e.grad_clip is not None
    assert (opt.defaults["beta1"], opt.defaults["beta2"], opt.defaults["beta3"]) == (0.98, 0.92,
                                                                                     0.99)
    named = dict(e.model.named_parameters())
    assert e.optimizer.group_of("pos_embed").weight_decay == 0.0
    assert e.optimizer.group_of("blocks.0.attn.qkv.weight").weight_decay == 0.02
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        (s0, adan0), (s1, adan1) = states[t], states[t + 1]
        e.model.load_state_dict(s0)
        opt.state.clear()
        for name, st in adan0.items():
            opt.state[named[name]] = {k: v.clone() for k, v in st.items()}
        e.state.step = t
        got = {k: float(v) for k, v in
               e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
        for k in ("loss", "CELoss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=(t, k))
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        lr = want["lr"]
        for name, p in e.model.state_dict().items():
            d_port, d_jax = p - s0[name], s1[name] - s0[name]
            if name.endswith("attn.qkv.bias"):  # the key third: rounding, as in assert_step_tracks
                third = p.shape[0] // 3
                d_port, d_jax = (torch.cat([x[:third], x[2 * third:]]) for x in (d_port, d_jax))
            assert (d_port - d_jax).abs().max().item() <= 0.1 * lr + 1e-7, (t, name)
            assert (d_port - d_jax).norm() <= 2e-3 * d_jax.norm() + 0.1 * lr, (t, name)
        for name, st in adan1.items():
            if name.endswith("attn.qkv.bias"):
                continue
            for k, v in st.items():
                got_t = opt.state[named[name]][k]
                assert (got_t - v).norm() <= 1e-4 * v.norm() + 1e-12, (t, name, k)
    e.close()
