"""T2T-ViT of the PyTorch port (passl_tpu_torch/models/t2t_vit.py) against the
JAX package.

On the CPU, at the sizes of configs/t2t_vit/t2t_tiny_synthetic.yaml, from
the JAX parameters converted, on the same numpy inputs: `soft_split` bitwise
against JAX's `conv_general_dilated_patches`; `TokenAttention`'s output and
every gradient; `TokenPerformer`'s output and every gradient in both
regimes, with the denominator under the 1e-8 epsilon (as at a random init,
where the stage passes `v + proj.bias` on) and over it (`w` scaled down);
the tiny T2T-ViT with each `tokens_type`, its train-mode logits on the
port's stochastic-depth draws handed to JAX, every gradient and the eval
logits; every factory's fields against JAX's; 3 steps of the tiny config
with each `tokens_type` through the JAX engine and the port's from JAX's
state. Then the census: the 7 configs under configs/t2t_vit/ build, and the
sin-cos code is no parameter, so `no_weight_decay_name`'s `pos_embed`
matches nothing. A test marked `cuda` trains the tiny config on the card and
skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine, _refuse_unported
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import t2t_vit as port_t2t
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_path, flax_to_torch
from test_torch_beit import (SMALL, STEPS, assert_grads_match, engine_config, handed_bernoulli,
                             jax_engine_run, recorded_drop_path_draws)
from test_torch_deit import assert_step_tracks
from test_torch_moco import _one_openmp_thread, _randomize  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "t2t_vit", "t2t_tiny_synthetic.yaml")
TINY = dict(img_size=32, token_dim=16, embed_dim=64, depth=2, num_heads=2, num_classes=10)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _variables(jm, seed, *args, **kw):
    import jax

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes)),
                      seed)


def _load(pm, variables):
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))
    return pm


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=msg)


def _step_of(jm, variables, x, w):
    """JAX's output, its gradients for the parameters and for x, under jit."""
    import jax

    def loss(params, x):
        out = jm.apply({"params": params}, x)
        return (out * w).sum(), out

    (_, out), (grads, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    return np.asarray(out), jax.device_get(grads), np.asarray(gx)


# -------------------------------------------------------------- soft_split


@pytest.mark.parametrize("shape, kernel, stride, pad", [
    ((2, 32, 32, 3), 7, 4, 2), ((2, 9, 9, 5), 3, 2, 1), ((3, 8, 8, 16), 3, 2, 1)])
def test_soft_split_is_jaxs_bitwise(shape, kernel, stride, pad):
    from passl_tpu.models.t2t_vit import soft_split as jax_soft_split

    x = _rand(shape, 1)
    want, oh, ow = jax_soft_split(x, kernel, stride, pad)
    got, goh, gow = port_t2t.soft_split(torch.from_numpy(x), kernel, stride, pad)
    assert (goh, gow) == (oh, ow) and tuple(got.shape) == want.shape
    assert want.shape[-1] == shape[-1] * kernel * kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- token stages


def test_token_attention_output_and_gradients_match_jax():
    """One head from 147 features (a 7 x 7 split of 3 channels) to 16 over 64
    tokens, with its MLP and no skip from the input."""
    import jax.numpy as jnp

    from passl_tpu.models.t2t_vit import TokenAttention as JaxTokenAttention

    jm = JaxTokenAttention(dim=16)
    variables = _variables(jm, 2, jnp.zeros((2, 64, 147)))
    pm = _load(port_t2t.TokenAttention(147, 16), variables)
    x, w = _rand((3, 64, 147), 3), _rand((3, 64, 16), 4)
    want, grads, gx = _step_of(jm, variables, x, w)
    xt = torch.from_numpy(x).requires_grad_()
    got = pm(xt)
    _close(got.detach().numpy(), want)
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, grads)
    _close(xt.grad.numpy(), gx, 1e-4)


@pytest.mark.parametrize("regime", ["under_epsilon", "over_epsilon"])
def test_token_performer_output_and_gradients_match_jax(regime):
    """`kqv` in the order k, q, v, the f32 features and the trainable `w`
    (m = 8, 16). Under the epsilon: inputs at twice the unit scale put
    |k|² / 2 near 30, as a random init does at full width, the denominator
    under 1e-8 and the output at `v + proj(~0)`; over it: inputs at a quarter
    and `w` at a tenth, the denominator of order one."""
    import jax.numpy as jnp

    from passl_tpu.models.t2t_vit import TokenPerformer as JaxTokenPerformer

    jm = JaxTokenPerformer(dim=16)
    variables = _variables(jm, 5, jnp.zeros((2, 49, 144)))
    assert variables["params"]["w"].shape == (8, 16)
    if regime == "over_epsilon":
        variables["params"]["w"] = variables["params"]["w"] * np.float32(0.1)
    pm = _load(port_t2t.TokenPerformer(144, 16), variables)
    assert pm.w.shape == (8, 16) and flax_path("w", 2) == "w"
    torch.testing.assert_close(pm.w.detach(), torch.from_numpy(variables["params"]["w"]),
                               rtol=0, atol=0)  # untransposed
    x = _rand((3, 49, 144), 6, 2.0 if regime == "under_epsilon" else 0.25)
    w = _rand((3, 49, 16), 7)
    with torch.no_grad():
        k, q, _ = pm.kqv(torch.from_numpy(x)).reshape(3, 49, 3, 16).unbind(2)
        kp, qp = pm.prm_exp(k), pm.prm_exp(q)
        denom = torch.einsum("nlm,nm->nl", qp, kp.sum(dim=1))
    if regime == "under_epsilon":
        assert denom.max() < 1e-8
    else:
        assert denom.min() > 1e-2
    want, grads, gx = _step_of(jm, variables, x, w)
    xt = torch.from_numpy(x).requires_grad_()
    got = pm(xt)
    _close(got.detach().numpy(), want)
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, grads)
    _close(xt.grad.numpy(), gx, 1e-4)


# --------------------------------------------------------------- the model


@pytest.mark.parametrize("tokens_type", ["performer", "transformer"])
def test_tiny_t2t_matches_jax_with_drop_path(tokens_type):
    """Train-mode logits on the port's stochastic-depth draws (linspace(0,
    0.5, 2): block 1 draws twice) handed to JAX, every gradient, and the eval
    logits; the sin-cos code is no parameter."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.t2t_vit import T2TViT as JaxT2T

    kw = dict(TINY, tokens_type=tokens_type, drop_path_rate=0.5)
    jm = JaxT2T(**kw)
    variables = _variables(jm, 8, jnp.zeros((1, 32, 32, 3)), train=False)
    pm = _load(port_t2t.T2TViT(**kw), variables)
    stage = port_t2t.TokenPerformer if tokens_type == "performer" else port_t2t.TokenAttention
    assert isinstance(pm.t2t_attn1, stage) and isinstance(pm.t2t_attn2, stage)
    assert not any("pos" in n for n in pm.state_dict())
    x, w = _rand((4, 32, 32, 3), 9), _rand((4, 10), 10)
    pm.train()
    with recorded_drop_path_draws() as draws:
        got = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    assert len(draws) == 2
    masks = [(u < 1.0 - rate).numpy() for u, rate in draws]

    def loss(params):
        out = jm.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * w).sum(), out

    with handed_bernoulli(masks) as calls:
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    assert len(calls) == 2
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, jax.device_get(grads))
    want = jm.apply(variables, x, train=False)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)).numpy(), np.asarray(want))


def test_every_t2t_factory_is_the_jax_one():
    from passl_tpu.models import MODELS as JAX_MODELS

    assert len(port_t2t._T2T) == 6
    for name, cfg in port_t2t._T2T.items():
        jm, pm = JAX_MODELS.get(name)(), port_t2t.MODELS.get(name)
        assert {k: getattr(jm, k) for k in cfg} == cfg, name
        with torch.device("meta"):
            model = pm()
        assert (len(model.blocks), model.embed_dim, model.tokens_type) == (
            cfg["depth"], cfg["embed_dim"], jm.tokens_type), name
        assert model.blocks[0].attn.num_heads == cfg["num_heads"], name
        assert model.t2t_attn1.mlp_fc1.weight.shape == (64, 64)
        in1 = model.t2t_attn1.kqv if jm.tokens_type == "performer" else model.t2t_attn1.qkv
        assert in1.weight.shape == (192, 147) and model.t2t_project.weight.shape == (
            cfg["embed_dim"], 576), name


# ----------------------------------------------------- the slice as a whole


@pytest.mark.parametrize("tokens_type", ["performer", "transformer"])
def test_tiny_t2t_steps_along_the_jax_engine(tokens_type, tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, clip 1, CE with
    smoothing 0.1) from JAX's state: the loss, every parameter's change and
    the AdamW moments (but the token attention's `qkv` biases, whose key
    third's gradient is rounding, which the softmax cancels)."""
    overrides = [*SMALL, f"Model.tokens_type={tokens_type}"]
    batches, jax_metrics, states, _ = jax_engine_run(TINY_CFG, overrides, tmp_path / "jax")
    e = Engine(engine_config(TINY_CFG, tmp_path, *overrides), mode="train", device="cpu")
    assert isinstance(e.model, port_t2t.T2TViT) and e.model.tokens_type == tokens_type
    key_thirds = [n for n, _ in e.model.named_parameters() if n.endswith("qkv.bias")
                  and n.startswith("t2t_")]
    assert len(key_thirds) == (2 if tokens_type == "transformer" else 0)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "CELoss"} <= set(want)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t,
                           skip=lambda name: name in key_thirds)
    assert e.state.step == STEPS
    e.close()


# ------------------------------------------------------------------ census

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "t2t_vit", "*.yaml")))


def test_the_census_holds_7_t2t_configs():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_t2t_config_builds(path):
    config = cfg_util.get_config(path, show=False)
    _refuse_unported(config)
    with torch.device("meta"):
        model = build_model(dict(config["Model"]))
    assert isinstance(model, port_t2t.T2TViT)
    names = [flax_path(n, p.ndim) for n, p in model.named_parameters()]
    assert "cls_token" in names and not any("pos_embed" in n for n in names)
    if "drop_path_rate" in config["Model"]:
        assert model.blocks[-1].drop_path1.rate == config["Model"]["drop_path_rate"]


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
@pytest.mark.parametrize("tokens_type", ["performer", "transformer"])
def test_tiny_t2t_trains_on_the_card(tokens_type, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(TINY_CFG, tmp_path, *SMALL, f"Model.tokens_type={tokens_type}",
                             "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    head = e.model.head.weight.detach().clone()
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert not torch.equal(e.model.head.weight, head)
