"""MoCo v3 over a V-MoE encoder (passl_tpu_torch/models/mocov3.py with
`num_experts > 0`) against the JAX package.

On the CPU, at tiny sizes (a ViT of 2 blocks over 32 x 32 images in 4 x 4
patches, 65 tokens, block 1 routing over 4 experts at capacity factor 1.25,
so experts overflow): the encoder's train-mode features, router aux and
gradients, and its eval features, on the einsum and the flash path (every
block, dense and MoE, takes the encoder's `attn_impl`); two train-mode
forwards and backwards of MoCo v3 from a converted init: the loss (the
contrastive loss plus 0.5 of the two base forwards' aux losses), `acc1`,
`moe_balance`, the base tower's gradients (its routers' included), no
gradient into the momentum tower, every BatchNorm statistic; the linear
probe over the MoE encoder; the optimizer groups of the two MoCo v3 MoE
configs against the JAX builder's; and 3 steps of the tiny MoCo v3 config
with a MoE encoder through the JAX engine and the port's from JAX's state,
the momentum tower's routers and experts moving by the EMA alone. A test
marked `cuda` trains it on the card on the flash kernels.

Tolerances: losses within 1e-5 relative, gradients within 1e-4 of their
tensor's largest entry, routing decisions equal (the routed outputs agree
only where they are).
"""
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import mocov3 as port_mocov3
from passl_tpu_torch.models.vit_moe import BlockMoE
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_path, flax_to_torch
from test_torch_deit import _adamw_moments, assert_step_tracks, jax_flash, jax_states  # noqa: F401
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)
from test_torch_moco import _randomize as randomize_stats
from test_torch_moe import GRAD_TOL, TOL, assert_grads, randomize
from test_torch_mocov3 import _rounding_alone, _views

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "mocov3", "mocov3_tiny_synthetic.yaml")
ENC = dict(img_size=32, patch_size=4, embed_dim=64, depth=2, num_heads=1, stop_grad_conv1=True,
           num_experts=4, moe_interval=2, moe_k=2, capacity_factor=1.25, moe_aux_weight=0.01)
KW = dict(encoder=ENC, dim=16, mlp_dim=32, T=0.2, base_momentum=0.99)


def _variables(jm, seed, *args, **kw):
    """The flax model's variables drawn with numpy from their shapes: the
    parameters as tests/test_torch_moe.py draws them, the BatchNorm statistics
    as tests/test_torch_moco.py does."""
    import jax

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    out = {"params": randomize(zeros["params"], seed)}
    if "batch_stats" in zeros:
        out["batch_stats"] = randomize_stats(zeros["batch_stats"], seed + 1)
    return out


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_moe_encoder_matches_jax(impl, request):
    """Train mode: {"features", "moe_aux_loss", "moe_balance"} and the gradients
    of a weighted sum of the features plus the aux loss (the patch embedding
    takes none: stop_grad_conv1); eval mode: the features alone."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mocov3 import MoCoV3ViT as JaxViT

    if impl == "flash":
        request.getfixturevalue("jax_flash")
    jm = JaxViT(**ENC, attn_impl=impl)
    x, w = _views(4, 0)[0], np.random.RandomState(1).randn(4, 64).astype(np.float32)
    params = _variables(jm, 2, jnp.asarray(x))["params"]
    pm = port_mocov3.MoCoV3ViT(**ENC, attn_impl=impl)
    pm.load_state_dict(flax_to_torch(params, pm))
    assert [type(b).__name__ for b in pm.blocks] == ["Block", "BlockMoE"]
    assert all(b.attn.attn_impl == impl for b in pm.blocks)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out["features"] * w) + out["moe_aux_loss"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = pm.train()(torch.from_numpy(x))
    assert set(out) == {"features", "moe_aux_loss", "moe_balance"}
    np.testing.assert_allclose(out["features"].detach().numpy(), np.asarray(want["features"]),
                               rtol=1e-4, atol=1e-4)
    for k in ("moe_aux_loss", "moe_balance"):
        np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=TOL, err_msg=k)
    ((out["features"] * torch.from_numpy(w)).sum() + out["moe_aux_loss"]).backward()
    assert pm.patch_embed.proj.weight.grad is None
    assert_grads(pm, jax.device_get(grads), held=lambda n: not n.startswith("patch_embed."))
    want_eval = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want_eval, rtol=1e-4, atol=1e-4)


def _jax_steps(steps=2):
    """JAX MoCo v3 MoE's train-mode steps of 8 pairs from one randomized init:
    per step the views, metrics, gradients and the variables after it."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mocov3 import MoCoV3Pretrain as JaxMoCoV3

    jm = JaxMoCoV3(**KW)
    x = jnp.zeros((4, 32, 32, 3))
    variables = _variables(jm, 3, (x, x))
    params, state = variables["params"], {"batch_stats": variables["batch_stats"]}

    @jax.jit
    def step(params, state, x1, x2):
        def loss(p):
            out, mut = jm.apply({"params": p, **state}, (x1, x2), train=True,
                                mutable=["batch_stats"])
            return out["loss"], (out, mut)

        return jax.value_and_grad(loss, has_aux=True)(params)

    out = []
    for t in range(steps):
        x1, x2 = _views(8, 20 + t)
        (_, (metrics, mut)), grads = step(params, state, x1, x2)
        state = jax.device_get(dict(mut))
        out.append(dict(x=(x1, x2), metrics=jax.device_get(metrics), grads=jax.device_get(grads),
                        after={"params": params, **state}))
    return variables, out


def test_mocov3_moe_steps_match_jax():
    """Two train-mode forwards and backwards of 8 pairs: loss (with the base
    tower's router losses), acc1 and moe_balance; the base tower's gradients,
    routers and experts included; none into the momentum tower; every
    BatchNorm statistic after each step but the momentum predictor's."""
    variables, steps = _jax_steps()
    pm = port_mocov3.MoCoV3Pretrain(**KW)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    pm.train()
    for s in steps:
        for p in pm.parameters():
            p.grad = None
        got = pm(tuple(torch.from_numpy(v) for v in s["x"]))
        assert set(got) == set(s["metrics"]) == {"loss", "acc1", "moe_balance"}
        for k in ("loss", "moe_balance"):
            np.testing.assert_allclose(got[k].item(), float(s["metrics"][k]), rtol=TOL,
                                       err_msg=k)
        assert got["acc1"].item() == float(s["metrics"]["acc1"])
        assert 1.0 <= got["moe_balance"].item() <= 4.0
        got["loss"].backward()
        assert all(p.grad is None for p in pm.momentum.parameters())
        grads = {k: v for k, v in s["grads"].items() if k == "base"}
        # the encoder's last LayerNorm bias: rounding alone (test_torch_mocov3.py)
        assert_grads(pm.base, grads["base"],
                     held=lambda n: not n.startswith("encoder.patch_embed.")
                     and not _rounding_alone(f"base.{n}"))
        assert pm.base.encoder.blocks[1].moe.router.grad.abs().max() > 0
        want_state = flax_to_torch(s["after"]["params"], pm, s["after"]["batch_stats"])
        for key in (k for k in want_state if "running" in k):
            if key.startswith("momentum.predictor."):
                continue  # JAX has none: the converter fills them from the base tower's
            np.testing.assert_allclose(pm.state_dict()[key].numpy(), want_state[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_linear_probe_over_a_moe_encoder_matches_jax():
    """The probe runs its MoE encoder in eval (plain features, no aux) whatever
    its own mode; the head's gradients match and the encoder takes none."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mocov3 import MoCoV3LinearProbe as JaxProbe

    enc = {**ENC, "patch_size": 8}
    jm = JaxProbe(encoder=enc, num_classes=5)
    x = _views(3, 4)[0]
    params = _variables(jm, 5, jnp.asarray(x))["params"]
    pm = port_mocov3.MoCoV3LinearProbe(encoder=enc, num_classes=5).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    w = np.random.RandomState(6).randn(3, 5).astype(np.float32)
    want, grads = jax.value_and_grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=True) * w))(params)
    got = (pm(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    assert all(p.grad is None for p in pm.encoder.parameters())
    np.testing.assert_allclose(pm.head.weight.grad.numpy(),
                               np.asarray(grads["head"]["kernel"]).T, rtol=0,
                               atol=GRAD_TOL * np.abs(np.asarray(grads["head"]["kernel"])).max())


@pytest.mark.parametrize("path", [
    os.path.join(REPO, "configs", "mocov3", "mocov3_vmoe_base_in1k.yaml"),
    os.path.join(REPO, "tests", "e2e", "mocov3_moe_structured.yaml")],
    ids=["mocov3_vmoe_base_in1k", "mocov3_moe_structured"])
def test_optimizer_groups_are_the_jax_builders(path):
    """Each parameter's group (name, weight decay, lr scale, frozen) against
    the JAX builder's over the engine's tree (the momentum tower a copy of
    the base tower): the base tower's expert biases without decay, the
    momentum tower frozen."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.optimizer import build_optimizer as jax_build_optimizer

    config = cfg_util.get_config(path, show=False)
    model_cfg, opt_cfg = dict(config["Model"]), dict(config["Optimizer"])
    jm = jax_build_model(dict(model_cfg))
    size = model_cfg["encoder"]["img_size"]
    x = jnp.zeros((2, size, size, 3))
    params = dict(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (x, x)))["params"])
    params["momentum"] = params["base"]  # the JAX engine's init-sync copy
    jopt = jax_build_optimizer(dict(opt_cfg, param_group=list(jm.optimizer_overrides())), params,
                               frozen_patterns=list(jm.frozen_patterns()))
    with torch.device("meta"):
        pm = build_model(dict(model_cfg))
    popt = model_optimizer(pm, opt_cfg, model_cfg)
    for name, p in pm.named_parameters():
        jg, pg = jopt.group_of(flax_path(name, p.dim())), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale) == (jg.name, jg.weight_decay,
                                                          jg.lr_scale), name
        assert (pg.rule == "Frozen") == (type(jg.rule).__name__ == "Frozen") == \
            name.startswith("momentum."), name
    assert popt.group_of("base.encoder.blocks.1.moe.b2").weight_decay == 0.0
    assert popt.group_of("base.encoder.blocks.1.moe.w2").weight_decay == 0.1


# ----------------------------------------------------- the slice as a whole

MOE = ["FP16.enable=False", "DataLoader.Train.sampler.batch_size=16",
       "Model.encoder.num_experts=4", "Model.encoder.moe_k=2", "Model.encoder.moe_interval=2",
       "Model.encoder.capacity_factor=1.25", "Model.encoder.moe_aux_weight=0.01"]
STEPS = 3


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 3 loader batches (16 pairs each), its metrics,
    and its state before each step and after the last."""
    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    config = cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp}", *MOE])
    port = build_model(dict(config["Model"]))
    je = JaxEngine(cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp}", *MOE]),
                   mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == STEPS:
            break

    def convert(model, state):
        return (flax_to_torch(state.params, model, state.model_state["batch_stats"]),
                _adamw_moments(state.opt_state))

    metrics, states = jax_states(je, batches, port, convert)
    je.train_dataloader.close()
    return batches, metrics, states


def assert_moe_step_tracks(e: Engine, batch, want: dict, before: tuple, after: tuple,
                           t: int) -> None:
    """`assert_step_tracks`, but for the entries whose gradients f32 does not
    resolve: where the root of JAX's bias-corrected second moment after the
    step is under 1e-5 of its tensor's largest, the gradient is rounding on
    both sides (at the first step a `blocks.0.mlp.fc2.weight` entry of 4.5e-8
    in JAX, 2.3e-8 in the port, where the tensor's largest is 0.2 and the two
    gradients part by up to 6e-7), which AdamW's first steps scale up to the
    lr. Such entries are held by neither the change nor the moments; every
    other entry of those tensors is, as `assert_step_tracks` holds it."""
    (s0, _), (s1, m1) = before, after
    beta2 = e.optimizer.torch_optimizer.param_groups[0]["betas"][1]
    resolved = {n: (mv["v"] / (1 - beta2 ** (t + 1))).sqrt() for n, mv in m1.items()}
    resolved = {n: r >= 1e-5 * r.max() for n, r in resolved.items()}
    partial = {n for n, r in resolved.items() if not r.all() and not _rounding_alone(n)}
    assert_step_tracks(e, batch, want, before, after, t,
                       skip=lambda n: _rounding_alone(n) or n in partial)
    lr, final = want["lr"], e.model.state_dict()
    state, named = e.optimizer.torch_optimizer.state, dict(e.model.named_parameters())
    for name in sorted(partial):
        keep = resolved[name]
        assert keep.float().mean() >= 0.6, (t, name)  # a key bias's third at most
        diff = (final[name] - s0[name] - (s1[name] - s0[name]))[keep]
        assert diff.abs().max().item() <= 0.1 * lr + 1e-7, (t, name)
        assert diff.norm() <= 2e-3 * (s1[name] - s0[name])[keep].norm() + 0.1 * lr, (t, name)
        for kind, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            got_t, want_t = state[named[name]][key][keep], m1[name][kind][keep]
            assert (got_t - want_t).norm() <= 1e-4 * want_t.norm() + 1e-12, (t, name, kind)


def test_tiny_mocov3_moe_steps_along_the_jax_engine(tmp_path, jax_run):
    """Each of the JAX engine's 3 steps from JAX's state: loss (router losses
    included), acc1, lr, every parameter's change and the AdamW moments; the
    momentum tower's routers and experts follow the base tower's by the EMA."""
    batches, jax_metrics, states = jax_run
    e = Engine(cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *MOE]),
               mode="train", device="cpu")
    assert isinstance(e.model.base.encoder.blocks[1], BlockMoE)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "acc1", "moe_balance"} <= set(want)
        assert_moe_step_tracks(e, b, want, states[t], states[t + 1], t)
        m = e.train_step.ema_pairs[0][2](t)
        before, after = states[t][0], states[t + 1][0]
        for name, p in e.model.momentum.encoder.blocks[1].moe.named_parameters():
            want_p = (m * before[f"momentum.encoder.blocks.1.moe.{name}"]
                      + (1 - m) * after[f"base.encoder.blocks.1.moe.{name}"])
            torch.testing.assert_close(p.detach(), want_p, rtol=1e-5, atol=1e-7)
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert not any(id(p) in stateful for p in e.model.momentum.parameters())
    e.close()


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_mocov3_moe_trains_on_the_card_on_flash(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from passl_tpu_torch.ops.attention import flash_attention

    e = Engine(cfg_util.get_config(TINY_CFG, overrides=[
        f"Global.output_dir={tmp_path}", *MOE[1:], "Global.max_train_step=2",
        "Global.print_batch_step=1", "Model.encoder.patch_size=4",
        "Model.encoder.attn_impl=flash"]), mode="train", device="cuda")
    flash_attention.launches = 0
    e.train()
    hist = e.train_loop.history
    assert [np.isfinite(h["loss"]) and 1.0 <= h["moe_balance"] <= 4.0 for h in hist] == [True] * 2
    assert flash_attention.launches == 2 * 4 * 2  # 2 steps, 4 encoder passes, 2 blocks
