"""V-MoE of the PyTorch port (passl_tpu_torch/nn/moe.py, models/vit_moe.py,
the train step's auxiliary losses) against the JAX package.

On the CPU, at tiny sizes, on the same seed-made numpy inputs: `moe_capacity`
over a grid; `topk_dispatch` for k = 1 and 2 with and without capacity drops
(the dispatch and first-choice masks equal, the renormalised combine weights
and their gradients) and on exact ties (the first expert takes them, as
`argmax` does in both libraries); `load_balance_loss`; `MoEMlp`'s output,
auxiliary losses and gradients with grouped and global routing, with
`z_weight > 0`, and over batch sizes whose groups differ; the tiny
`VisionTransformerMoE` of configs/classification/vmoe_tiny_synthetic.yaml in
train (logits, aux, every gradient) and eval; the five factories; the flax
paths and the converter; the optimizer groups of the two V-MoE configs
against the JAX builder's; 3 steps of the tiny config (and one with 2
micro-batches) through the JAX engine and the port's from JAX's state; the
logged loss under a loss scaler; the census of the three V-MoE configs. A
test marked `cuda` trains the tiny config on the card.

Tolerances: outputs and losses within 1e-5 relative, gradients within 1e-4
of their tensor's largest entry, routing decisions equal.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.core.amp import GradScaler
from passl_tpu_torch.engine.engine import Engine, _refuse_unported, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import vit_moe as port_vmoe
from passl_tpu_torch.nn import moe as port_moe
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, flax_path, flax_to_torch
from test_torch_beit import _grads_of, jax_engine_run
from test_torch_deit import assert_step_tracks
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "vmoe_tiny_synthetic.yaml")
BASE_CFG = os.path.join(REPO, "configs", "classification", "vmoe_base_patch16_224_e8_in1k.yaml")
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=10,
            num_experts=4, moe_k=2, moe_interval=2, capacity_factor=2.0)
TOL = 1e-5  # outputs and losses, relative
GRAD_TOL = 1e-4  # of a gradient tensor's largest entry


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gates(shape, seed, scale=2.0):
    z = scale * _rand(shape, seed)
    z = np.exp(z - z.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def randomize(params, seed):
    """Every flax leaf drawn with numpy at a scale where each part shows: the
    stacked expert kernels over their fan in, the router wide enough that the
    tokens spread over the experts."""
    import jax

    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name or "'w1'" in name or "'w2'" in name:
            return rng.randn(*shape) / np.sqrt(shape[-2] if "'w" in name else np.prod(shape[:-1]))
        if "router" in name:
            return rng.randn(*shape) / np.sqrt(shape[0])
        if "pos_embed" in name or "cls_token" in name:
            return 0.5 * rng.randn(*shape)
        return 0.2 * rng.randn(*shape)

    return jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(draw(p, x), np.float32),
                                            params)


def _jax_params(jm, seed, *args, **kw):
    import jax

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    return randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def assert_grads(model, jax_grads, held=lambda name: True):
    """Every gradient within GRAD_TOL of its JAX tensor's largest entry; the
    key bias of each attention (one constant added to a softmax row, which
    cancels) as rounding under 1e-6 of the model's largest entry."""
    want = _grads_of(jax_grads, model)
    top = max(np.abs(w).max() for w in want.values())
    for name, p in model.named_parameters():
        if not held(name):
            continue
        w, g = want[name], p.grad.numpy()
        if name.endswith("attn.qkv.bias"):
            third = w.shape[0] // 3
            assert max(np.abs(w[third:2 * third]).max(), np.abs(g[third:2 * third]).max()) \
                <= 1e-6 * top, name
            w, g = np.delete(w, np.s_[third:2 * third]), np.delete(g, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=name)


# ------------------------------------------------------------------ routing


def test_moe_capacity_is_jaxs():
    from passl_tpu.nn.moe import moe_capacity as jax_capacity

    for t in (1, 7, 64, 197, 256, 394, 1000):
        for e in (1, 4, 8, 16):
            for k in (1, 2):
                for cf in (0.5, 1.0, 1.25, 2.0):
                    assert port_moe.moe_capacity(t, e, k, cf) == jax_capacity(t, e, k, cf)
    assert port_moe.moe_capacity(197, 8, 2, 1.25) == 64  # V-MoE-B/16's groups
    assert port_moe.moe_capacity(10, 8, 1, 1.0) == 8  # at least 8


def _jax_dispatch(gates, k, cap):
    import jax

    from passl_tpu.nn.moe import topk_dispatch

    return [np.asarray(a) for a in jax.vmap(lambda g: topk_dispatch(g, k, cap))(gates)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cap", [8, 32], ids=["drops", "no_drops"])
def test_topk_dispatch_matches_jax(k, cap):
    """3 groups of 40 tokens over 4 experts: the dispatch and first-choice
    masks equal, the combine weights within 1e-5; with capacity 8 the later
    tokens of a busy expert drop (k = 2: 80 choices for 32 slots), without
    drops every token keeps its k choices and their weights sum to 1."""
    gates = _gates((3, 40, 4), k)
    want = _jax_dispatch(gates, k, cap)
    got = [a.numpy() for a in port_moe.topk_dispatch(torch.from_numpy(gates), k, cap)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _close(got[0], want[0])
    kept = got[1].sum((2, 3))
    if cap == 8:
        assert kept.sum() < 3 * 40 * k and (kept == 0).any()
        assert got[1].sum((1, 3)).max() == cap  # a full expert
        # drops go in token order: an expert's kept tokens are its first choosers
        slots = got[1][0].any(-1)  # [T, E]
        first = got[2][0]
        for e in range(4):
            chosen = np.flatnonzero(first[:, e])
            assert slots[chosen[:cap], e].all() and not slots[chosen[cap:], e].any()
    else:
        assert (kept == k).all()
        np.testing.assert_allclose(got[0].sum((2, 3)), 1.0, rtol=1e-6)


def test_topk_dispatch_on_exact_ties_takes_the_first_expert():
    """Tied gates: every token's first choice is the first of the tied experts
    and its second the next, in both libraries; with k = 2 and two tied
    experts each keeps half the token's weight."""
    gates = np.array([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.4, 0.4, 0.1, 0.1],
                       [0.3, 0.1, 0.3, 0.3]]], np.float32)
    want = _jax_dispatch(gates, 2, 8)
    got = [a.numpy() for a in port_moe.topk_dispatch(torch.from_numpy(gates), 2, 8)]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    _close(got[0], want[0])
    assert got[2][0].argmax(-1).tolist() == [0, 1, 0, 0]
    experts = got[1][0].any(-1)  # [T, E]: the two experts each token went to
    assert [np.flatnonzero(r).tolist() for r in experts] == [[0, 1], [1, 3], [0, 1], [0, 2]]
    np.testing.assert_allclose(got[0][0, 2].sum(-1), [0.5, 0.5, 0, 0])


@pytest.mark.parametrize("k", [1, 2])
def test_topk_dispatch_gradients_match_jax(k):
    """The gradient of a weighted sum of the combine tensor with respect to the
    gates, with drops: it reaches the gates through the kept gate values and
    their sum only. At k = 1 a kept weight is its gate over itself, 1, whose
    gradient is 0 but for rounding on both sides (under 1e-6 of the weights)."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.nn.moe import topk_dispatch

    gates = _gates((2, 24, 4), 5)
    w = _rand((2, 24, 4, 8), 6)
    want = jax.grad(lambda g: jnp.sum(jax.vmap(lambda x: topk_dispatch(x, k, 8))(g)[0] * w))(
        jnp.asarray(gates))
    g = torch.from_numpy(gates).requires_grad_()
    (port_moe.topk_dispatch(g, k, 8)[0] * torch.from_numpy(w)).sum().backward()
    want = np.asarray(want)
    if k == 1:
        assert max(np.abs(want).max(), g.grad.abs().max().item()) <= 1e-6 * np.abs(w).max()
        return
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=0, atol=GRAD_TOL * np.abs(want).max())


def test_load_balance_loss_matches_jax():
    from passl_tpu.nn.moe import load_balance_loss as jax_balance

    gates = _gates((50, 8), 7).reshape(50, 8)
    first = np.eye(8, dtype=np.float32)[gates.argmax(-1)]
    got = port_moe.load_balance_loss(torch.from_numpy(gates), torch.from_numpy(first)).item()
    np.testing.assert_allclose(got, float(jax_balance(gates, first)), rtol=TOL)
    collapsed = np.zeros((10, 8), np.float32)
    collapsed[:, 3] = 1.0
    assert port_moe.load_balance_loss(torch.from_numpy(collapsed),
                                      torch.from_numpy(collapsed)).item() == 8.0
    flat = np.full((16, 8), 1 / 8, np.float32)
    flat_first = np.eye(8, dtype=np.float32)[np.arange(16) % 8]
    assert abs(port_moe.load_balance_loss(torch.from_numpy(flat),
                                          torch.from_numpy(flat_first)).item() - 1.0) < 1e-6


# ------------------------------------------------------------------ MoEMlp


MLP_CASES = {
    "grouped": dict(group_size=12, n=6),  # 2 images of 5 tokens a group
    "grouped_odd_batch": dict(group_size=12, n=5),  # 2 does not divide 5: one image a group
    "one_image_groups": dict(group_size=4, n=3),  # under one image: one image a group
    "global": dict(group_size=0, n=4),
    "z_loss": dict(group_size=12, n=4, z_weight=0.05),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_moe_mlp_matches_jax(case):
    """MoEMlp of 4 experts (k = 2, capacity factor 1, so experts overflow) on
    [n, 5, 16]: the output, every auxiliary entry and the gradients of the
    parameters and the input, with the groups JAX forms for the batch."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.nn.moe import MoEMlp as JaxMoEMlp

    cfg = dict(MLP_CASES[case])
    n = cfg.pop("n")
    kw = dict(num_experts=4, k=2, capacity_factor=1.0, hidden_features=24, **cfg)
    jm = JaxMoEMlp(**kw)
    x = _rand((n, 5, 16), 8)
    params = _jax_params(jm, 9, jnp.asarray(x))
    pm = port_moe.MoEMlp(16, kw["num_experts"], kw["k"], kw["capacity_factor"], 24,
                         group_size=kw["group_size"], z_weight=kw.get("z_weight", 0.0))
    pm.load_state_dict(flax_to_torch(params, pm))
    w = _rand((n, 5, 16), 10)

    def loss(p, x):
        y, aux = jm.apply({"params": p}, x)
        return jnp.sum(y * w) + sum(v for k, v in aux.items() if "loss" in k), (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = pm(xt)
    assert set(auxt) == set(aux) == ({"moe_aux_loss", "moe_balance"}
                                     | ({"moe_z_loss"} if case == "z_loss" else set()))
    _close(yt.detach().numpy(), np.asarray(y))
    for k in aux:
        np.testing.assert_allclose(auxt[k].item(), float(aux[k]), rtol=TOL, err_msg=k)
    ((yt * torch.from_numpy(w)).sum() + sum(v for k, v in auxt.items() if "loss" in k)).backward()
    assert_grads(pm, jax.device_get(gp))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=GRAD_TOL * np.abs(np.asarray(gx)).max())


def test_group_sizing_is_the_jax_rule():
    """Whole images, the most that fit group_size and divide the batch: V-MoE-B
    at 224 px takes one image (197 tokens) a group at any batch, a micro-batch
    and a padded eval batch alike."""
    assert port_moe.group_tokens(128, 197, 256) == 197
    assert port_moe.group_tokens(3, 197, 256) == 197
    assert port_moe.group_tokens(64, 17, 256) == 8 * 17  # 15 fit; 8 is the most dividing 64
    assert port_moe.group_tokens(6, 17, 256) == 6 * 17  # every token fits one group
    assert port_moe.group_tokens(30, 17, 256) == 15 * 17
    assert port_moe.group_tokens(7, 17, 256) == 7 * 17
    assert port_moe.group_tokens(17, 17, 256) == 17  # no count of images up to 15 divides 17
    assert port_moe.group_tokens(4, 17, 0) == 68
    assert port_moe.group_tokens(4, 17, 8) == 17


def test_moe_mlp_init_follows_flax():
    """router normal(0.02); w1 and w2 xavier-uniform over their last two axes
    (the expert axis a batch axis); zero biases; flax's shapes."""
    m = init_module(port_moe.MoEMlp(384, 8, hidden_features=1536),
                    torch.Generator().manual_seed(0))
    assert tuple(m.router.shape) == (384, 8) and tuple(m.w1.shape) == (8, 384, 1536)
    assert tuple(m.b1.shape) == (8, 1536) and tuple(m.w2.shape) == (8, 1536, 384)
    assert tuple(m.b2.shape) == (8, 384)
    assert abs(m.router.std().item() - 0.02) < 0.001
    bound = (6.0 / (384 + 1536)) ** 0.5
    for w in (m.w1, m.w2):
        assert w.abs().max().item() <= bound and w.abs().max().item() > 0.99 * bound
    assert not m.b1.any() and not m.b2.any()
    with pytest.raises(NotImplementedError, match="dropout"):
        port_moe.MoEMlp(16, 4, drop=0.1)


# --------------------------------------------------------------- the model


def _tiny_pair(seed=11):
    import jax.numpy as jnp

    from passl_tpu.models.vit_moe import VisionTransformerMoE as JaxVMoE

    jm = JaxVMoE(**TINY)
    params = _jax_params(jm, seed, jnp.zeros((2, 32, 32, 3)), train=False)
    pm = port_vmoe.VisionTransformerMoE(**TINY)
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def test_tiny_vmoe_train_and_eval_match_jax():
    """Train mode: {"logits", "moe_aux_loss", "moe_balance"} and the gradients
    of a weighted sum of the logits plus the aux loss; eval mode: plain logits."""
    import jax
    import jax.numpy as jnp

    jm, params, pm = _tiny_pair()
    x, w = _rand((6, 32, 32, 3), 12), _rand((6, 10), 13)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out["logits"] * w) + out["moe_aux_loss"], out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = pm.train()(torch.from_numpy(x))
    assert set(out) == {"logits", "moe_aux_loss", "moe_balance"}
    _close(out["logits"].detach().numpy(), np.asarray(want["logits"]))
    for k in ("moe_aux_loss", "moe_balance"):
        np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=TOL, err_msg=k)
    assert 1.0 <= out["moe_balance"].item() <= 4.0
    ((out["logits"] * torch.from_numpy(w)).sum() + out["moe_aux_loss"]).backward()
    assert_grads(pm, jax.device_get(grads))
    assert pm.blocks[1].moe.router.grad.abs().max() > 0
    want_eval = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), want_eval)
    with torch.inference_mode():  # backbone mode: the features
        feats = pm(torch.from_numpy(x), return_features=True)
    assert tuple(feats.shape) == (6, 64)


def test_vmoe_blocks_and_factories_are_jaxs():
    from passl_tpu.models import MODELS as JAX_MODELS

    assert len(port_vmoe._VARIANTS) == 5
    for name, cfg in port_vmoe._VARIANTS.items():
        jm = JAX_MODELS.get(name)()
        assert {k: getattr(jm, k) for k in cfg} == cfg, name
        with torch.device("meta"):
            model = build_model({"name": name})
        moe = [i for i, b in enumerate(model.blocks) if isinstance(b, port_vmoe.BlockMoE)]
        assert moe == list(range(1, cfg["depth"], 2)), name
        assert tuple(model.blocks[1].moe.w1.shape) == (cfg["num_experts"], cfg["embed_dim"],
                                                       4 * cfg["embed_dim"])
    with pytest.raises(NotImplementedError, match="drop_rate"):
        port_vmoe.VisionTransformerMoE(**TINY, drop_rate=0.1)
    # attention stays einsum, as the JAX model's BlockMoE takes no attn_impl from it
    assert all(b.attn.attn_impl == "einsum" for b in port_vmoe.VisionTransformerMoE(**TINY).blocks)


def test_flax_paths_and_the_converter_carry_the_tree():
    """Every port parameter's flax path is a leaf of the JAX tree, and the
    converter carries each leaf over: the stacked expert tensors and the router
    verbatim in flax's layout, the Dense kernels transposed."""
    _, params, pm = _tiny_pair()
    flat = _flatten(params)
    named = dict(pm.named_parameters())
    assert {flax_path(n, p.dim()) for n, p in named.items()} == set(flat)
    for n, p in named.items():
        leaf = flat[flax_path(n, p.dim())]
        want = leaf.T if (n.endswith("weight") and p.dim() == 2) else leaf
        if p.dim() == 4:
            want = leaf.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=n)
    assert flax_path("blocks.1.moe.w1", 3) == "blocks_1/moe/w1"
    assert flax_path("blocks.1.moe.router", 2) == "blocks_1/moe/router"


@pytest.mark.parametrize("path", [TINY_CFG, BASE_CFG], ids=["tiny", "base"])
def test_optimizer_groups_are_the_jax_builders(path):
    """Each parameter's group (name, weight decay, lr scale) against the JAX
    builder's: the stacked expert biases without decay, the router and expert
    kernels with it."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.optimizer import build_optimizer as jax_build_optimizer

    config = cfg_util.get_config(path, show=False)
    model_cfg, opt_cfg = dict(config["Model"]), dict(config["Optimizer"])
    opt_cfg.pop("grad_clip", None)
    jm = jax_build_model(dict(model_cfg))
    size = jm.img_size
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, size, size, 3)), train=False))["params"]
    overrides = list(jm.optimizer_overrides())
    jopt = jax_build_optimizer(dict(opt_cfg, param_group=overrides), params,
                               num_layers=int(jm.depth))
    with torch.device("meta"):
        pm = build_model(dict(model_cfg))
    popt = model_optimizer(pm, opt_cfg, model_cfg)
    named = dict(pm.named_parameters())
    for name, p in named.items():
        jg, pg = jopt.group_of(flax_path(name, p.dim())), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale) == (jg.name, jg.weight_decay,
                                                          jg.lr_scale), name
    assert popt.group_of("blocks.1.moe.b1").weight_decay == 0.0
    assert popt.group_of("blocks.1.moe.w1").weight_decay > 0.0
    assert popt.group_of("blocks.1.moe.router").weight_decay > 0.0


# ----------------------------------------------------- the slice as a whole

SMALL = ["DataLoader.Train.dataset.size=24", "DataLoader.Train.sampler.batch_size=8"]


@pytest.mark.parametrize("accum", [1, 2])
def test_tiny_vmoe_steps_along_the_jax_engine(accum, tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, CE with smoothing 0.1,
    the router's aux loss in the objective; with 2 micro-batches of 4 images,
    each routed in its own groups) from JAX's state: the loss (CE plus the aux
    loss), CELoss and moe_aux_loss, lr, every parameter's change and the AdamW
    moments."""
    overrides = SMALL + [f"Global.accum_steps={accum}"]
    batches, jax_metrics, states, _ = jax_engine_run(TINY_CFG, overrides, tmp_path / "jax")
    e = Engine(cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}",
                                                        *overrides]), mode="train", device="cpu")
    assert isinstance(e.model, port_vmoe.VisionTransformerMoE) and e.accum_steps == accum
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "CELoss", "moe_aux_loss", "moe_balance"} <= set(want)
        assert abs(want["loss"] - want["CELoss"] - want["moe_aux_loss"]) <= 1e-6 * want["loss"]
        assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    e.close()


def test_logged_loss_is_the_objective_under_a_loss_scaler(tmp_path):
    """With a loss scaler and 2 micro-batches, the logged loss is CELoss plus
    moe_aux_loss (each the micro-batches' mean) and the gradients are those of
    the unscaled run."""
    config = cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *SMALL,
                                                      "Global.accum_steps=2"])
    e = Engine(config, mode="train", device="cpu")
    batch = next(iter(e.train_dataloader))
    from passl_tpu_torch.data import to_device

    batch = to_device(batch, e.device)
    init = {k: v.clone() for k, v in e.model.state_dict().items()}
    plain = e.train_step.forward_backward(e.state, batch)
    grads = {n: p.grad.clone() for n, p in e.model.named_parameters()}
    e.train_step.scaler = GradScaler(init_loss_scaling=1024.0)
    e.state.scaler_state = e.train_step.scaler.init()
    e.model.load_state_dict(init)
    scaled = e.train_step.forward_backward(e.state, batch)
    for k in plain:
        np.testing.assert_allclose(scaled[k].item(), plain[k].item(), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(scaled["loss"].item(),
                               scaled["CELoss"].item() + scaled["moe_aux_loss"].item(), rtol=1e-6)
    for n, p in e.model.named_parameters():
        torch.testing.assert_close(p.grad / 1024.0, grads[n], rtol=1e-5, atol=1e-8)
    e.close()


def test_tiny_vmoe_evaluates_its_plain_logits(tmp_path):
    """The eval loop's top-1 over the 128 synthetic images equals the eval
    logits' argmax accuracy (eval returns plain logits)."""
    e = Engine(cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}"]),
               mode="eval", device="cpu")
    top1 = e.eval()
    images, labels = zip(*(e.eval_dataloader.dataset[i] for i in range(128)))
    with torch.inference_mode():
        logits = e.model.eval()(torch.from_numpy(np.stack(images)))
    assert top1 == pytest.approx(float(np.mean(logits.argmax(-1).numpy() == np.asarray(labels))),
                                 abs=1e-7)


# ------------------------------------------------------------------ census

CONFIGS = sorted(p for p in glob.glob(os.path.join(REPO, "configs", "*", "*.yaml"))
                 if "vmoe" in os.path.basename(p))


def test_the_census_holds_3_vmoe_configs():
    assert [os.path.relpath(p, REPO) for p in CONFIGS] == [
        "configs/classification/vmoe_base_patch16_224_e8_in1k.yaml",
        "configs/classification/vmoe_tiny_synthetic.yaml",
        "configs/mocov3/mocov3_vmoe_base_in1k.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_vmoe_config_builds_at_one_device(path):
    """The tiny config builds as it is; the two full-width recipes are refused
    at their sharding degree (expert parallelism is not ported) and build at
    degree 1: V-MoE-B/16-E8's 12 blocks of 768, 6 of them 8 experts of
    768 -> 3072."""
    config = cfg_util.get_config(path, show=False)
    degree = (config.get("DistributedStrategy") or {}).get("sharding", {}).get("degree", 1)
    if degree > 1:
        with pytest.raises(NotImplementedError, match="sharding"):
            _refuse_unported(config)
        config["DistributedStrategy"]["sharding"]["degree"] = 1
    _refuse_unported(config)
    with torch.device("meta"):
        model = build_model(dict(config["Model"]))
    encoder = model.base.encoder if hasattr(model, "base") else model
    moe = [b for b in encoder.blocks if isinstance(b, port_vmoe.BlockMoE)]
    if "tiny" in path:
        assert len(encoder.blocks) == 2 and len(moe) == 1 and moe[0].moe.num_experts == 4
    else:
        assert len(encoder.blocks) == 12 and len(moe) == 6
        assert tuple(moe[0].moe.w1.shape) == (8, 768, 3072)


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_vmoe_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(cfg_util.get_config(TINY_CFG, overrides=[
        f"Global.output_dir={tmp_path}", "Global.max_train_step=2", "Global.print_batch_step=1",
        "Global.eval_during_train=False"]), mode="train", device="cuda")
    e.train()
    hist = e.train_loop.history
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(abs(h["loss"] - h["CELoss"] - h["moe_aux_loss"]) <= 1e-5 * h["loss"] for h in hist)
