"""CvT and MLP-Mixer of the PyTorch port (passl_tpu_torch/models/cvt.py,
mlp_mixer.py) against the JAX package.

On the CPU, at the sizes of configs/cvt/cvt_tiny_synthetic.yaml and
configs/mlp_mixer/mixer_tiny_synthetic.yaml, from the JAX parameters
converted, on the same numpy inputs: `ConvAttention` with and without the
cls token (its depthwise 3x3 kernels `[3, 3, 1, c]` -> `[c, 1, 3, 3]`, the
strided k and v), its output and every gradient in f32 and its output in
bf16; the tiny CvT's train-mode logits on the port's stochastic-depth draws
handed to JAX, every gradient and the eval logits; the tiny Mixer's logits
and gradients; every factory's fields against JAX's; 3 steps of each tiny
config through the JAX engine and the port's from JAX's state. Then the
census of the 9 configs under configs/cvt/ and configs/mlp_mixer/, which all
build (CvT-W24 at 384, 277M parameters, on the meta device). A test marked
`cuda` trains both tiny configs on the card and skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine, _refuse_unported
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import cvt as port_cvt
from passl_tpu_torch.models import mlp_mixer as port_mixer
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_to_torch
from test_torch_beit import (SMALL, STEPS, _grads_of, assert_grads_match, engine_config,
                             handed_bernoulli, jax_engine_run, recorded_drop_path_draws)
from test_torch_deit import assert_step_tracks
from test_torch_moco import _one_openmp_thread, _randomize  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CVT_CFG = os.path.join(REPO, "configs", "cvt", "cvt_tiny_synthetic.yaml")
MIXER_CFG = os.path.join(REPO, "configs", "mlp_mixer", "mixer_tiny_synthetic.yaml")
TINY_CVT = dict(depths=(1, 1, 2), embed_dims=(32, 64, 128), num_heads=(1, 2, 4), num_classes=10)
TINY_MIXER = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, tokens_mlp_dim=32,
                  channels_mlp_dim=128, num_classes=10)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _variables(jm, seed, *args, **kw):
    import jax

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes)),
                      seed)


def _load(pm, variables):
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))
    return pm


def _cancelled(model):
    """The parameters whose gradient is 0 but for rounding: each `proj_k` bias
    and, where no cls token joins the keys, each `k_ln` bias add one vector to
    every key of a softmax row, which the softmax cancels; the token MLP's
    `fc2` bias adds one value to every channel of a token, which each
    LayerNorm that reads the residual stream cancels."""
    out = []
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, port_cvt.ConvAttention):
            out += [f"{prefix}proj_k.bias"] + ([] if m.with_cls else [f"{prefix}k_ln.bias"])
        elif isinstance(m, port_mixer.MixerBlock):
            out.append(f"{prefix}token_mlp.fc2.bias")
    return sorted(out)


def assert_grads_match_but_cancelled(model, jax_grads):
    """`assert_grads_match`, with the gradients of `_cancelled` held as
    rounding on both sides: under 1e-6 of the model's largest gradient entry."""
    want = _grads_of(jax_grads, model)
    top = max(np.abs(w).max() for w in want.values())
    cancelled = _cancelled(model)
    for name, p in model.named_parameters():
        if name in cancelled:
            assert max(np.abs(want[name]).max(), p.grad.abs().max().item()) <= 1e-6 * top, name
            p.grad = None
    assert_grads_match(model, jax_grads, skip=tuple(cancelled))


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=msg)


# ------------------------------------------------------------ ConvAttention


@pytest.mark.parametrize("with_cls", [False, True], ids=["no_cls", "cls"])
def test_conv_attention_output_and_gradients_match_jax_in_f32(with_cls):
    """A 4 x 4 grid of width 32 in 2 heads: 16 queries (17 with the cls
    token) against the 4 keys of the stride-2 convs (5)."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.cvt import ConvAttention as JaxConvAttention

    jm = JaxConvAttention(num_heads=2, grid=(4, 4), with_cls=with_cls)
    l = 16 + int(with_cls)
    variables = _variables(jm, 1, jnp.zeros((2, l, 32)))
    assert variables["params"]["k_dw"]["kernel"].shape == (3, 3, 1, 32)
    pm = _load(port_cvt.ConvAttention(32, 2, with_cls=with_cls), variables)
    assert pm.k_dw.weight.shape == (32, 1, 3, 3) and pm.k_dw.groups == 32
    assert (pm.q_dw.stride, pm.k_dw.stride, pm.v_dw.stride) == (1, 2, 2)
    x, w = _rand((3, l, 32), 2), _rand((3, l, 32), 3)

    def loss(params, x):
        out = jm.apply({"params": params}, x)
        return (out * w).sum(), out

    (_, want), (grads, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    xt = torch.from_numpy(x).requires_grad_()
    got = pm(xt, (4, 4))
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert _cancelled(pm) == (["proj_k.bias"] if with_cls else ["k_ln.bias", "proj_k.bias"])
    assert_grads_match_but_cancelled(pm, jax.device_get(grads))
    _close(xt.grad.numpy(), np.asarray(gx), 1e-4)


@pytest.mark.parametrize("with_cls", [False, True], ids=["no_cls", "cls"])
def test_conv_attention_output_matches_jax_in_bf16(with_cls):
    """bf16 convs and products, f32 scores and softmax on both sides: the two
    round in other places (cosine and a bf16 step of the largest entry)."""
    import jax.numpy as jnp

    from passl_tpu.models.cvt import ConvAttention as JaxConvAttention

    jm = JaxConvAttention(num_heads=2, grid=(4, 4), with_cls=with_cls, dtype=jnp.bfloat16)
    l = 16 + int(with_cls)
    variables = _variables(jm, 4, jnp.zeros((2, l, 32)))
    pm = _load(port_cvt.ConvAttention(32, 2, with_cls=with_cls, dtype=torch.bfloat16), variables)
    x = _rand((3, l, 32), 5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).bfloat16(), (4, 4))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.9999 and np.abs(got - want).max() <= 2**-6 * np.abs(want).max()


# ------------------------------------------------------------- the models


def test_tiny_cvt_matches_jax_with_drop_path():
    """Train-mode logits on the port's stochastic-depth draws (linspace(0,
    0.5, 4) over the 4 blocks: blocks 1-3 draw twice each) handed to JAX, every
    gradient, and the eval logits."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.cvt import CvT as JaxCvT

    kw = dict(TINY_CVT, drop_path_rate=0.5)
    jm = JaxCvT(**kw)
    variables = _variables(jm, 6, jnp.zeros((1, 32, 32, 3)), train=False)
    pm = _load(port_cvt.CvT(**kw), variables)
    assert [n for n, _ in pm.named_children()][:4] == ["stage0_embed", "stage0_ln",
                                                       "stage0_block0", "stage1_embed"]
    x, w = _rand((4, 32, 32, 3), 7), _rand((4, 10), 8)
    pm.train()
    with recorded_drop_path_draws() as draws:
        got = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    assert len(draws) == 6
    masks = [(u < 1.0 - rate).numpy() for u, rate in draws]

    def loss(params):
        out = jm.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * w).sum(), out

    with handed_bernoulli(masks) as calls:
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    assert len(calls) == 6
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert len(_cancelled(pm)) == 4 + 2  # 4 blocks, 2 of them without the cls token
    assert_grads_match_but_cancelled(pm, jax.device_get(grads))
    want = jm.apply(variables, x, train=False)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)).numpy(), np.asarray(want))


def test_tiny_mixer_logits_and_gradients_match_jax():
    """The token MLP over the 16 patches, every gradient (the zero-init head
    drawn at random here, so that the rest receives a gradient)."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mlp_mixer import MlpMixer as JaxMixer

    jm = JaxMixer(**TINY_MIXER)
    variables = _variables(jm, 9, jnp.zeros((1, 32, 32, 3)), train=False)
    assert variables["params"]["blocks_0"]["token_mlp"]["fc1"]["kernel"].shape == (16, 32)
    pm = _load(port_mixer.MlpMixer(**TINY_MIXER), variables)
    x, w = _rand((3, 32, 32, 3), 10), _rand((3, 10), 11)

    def loss(params):
        out = jm.apply({"params": params}, x, train=True)
        return (out * w).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    got = pm.train()(torch.from_numpy(x))
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert _cancelled(pm) == ["blocks.0.token_mlp.fc2.bias", "blocks.1.token_mlp.fc2.bias"]
    assert_grads_match_but_cancelled(pm, jax.device_get(grads))
    fresh = build_model(dict(TINY_MIXER, name="MlpMixer"))
    init_module(fresh, torch.Generator().manual_seed(0))
    assert not fresh.head.weight.any() and not fresh.head.bias.any()  # flax's zeros


@pytest.mark.parametrize("family", ["cvt", "mixer"])
def test_every_factory_is_the_jax_one(family):
    from passl_tpu.models import MODELS as JAX_MODELS

    table = port_cvt._CVT if family == "cvt" else port_mixer._MIXER
    assert len(table) == (5 if family == "cvt" else 3)
    for name, cfg in table.items():
        jm, pm = JAX_MODELS.get(name)(), port_cvt.MODELS.get(name)
        assert {k: getattr(jm, k) for k in cfg} == cfg, name
        with torch.device("meta"):
            model = pm()
        if family == "cvt":
            assert (model.depths, model.embed_dims, model.num_heads) == (
                cfg["depths"], cfg["embed_dims"], cfg["num_heads"]), name
            assert sum(1 for n, _ in model.named_children() if "_block" in n) == sum(cfg["depths"])
        else:
            assert (len(model.blocks), model.embed_dim, model.num_patches) == (
                cfg["depth"], cfg["embed_dim"], 196), name
            assert model.blocks[0].token_mlp.fc1.weight.shape == (cfg["tokens_mlp_dim"], 196)
            assert model.blocks[0].channel_mlp.fc1.weight.shape == (
                cfg["channels_mlp_dim"], cfg["embed_dim"])


# ----------------------------------------------------- the slice as a whole


@pytest.mark.parametrize("path, cls", [(CVT_CFG, port_cvt.CvT), (MIXER_CFG, port_mixer.MlpMixer)],
                         ids=["cvt", "mixer"])
def test_tiny_config_steps_along_the_jax_engine(path, cls, tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, clip 1, CE with
    smoothing 0.1) from JAX's state: the loss, every parameter's change and
    the AdamW moments (but `_cancelled`'s: their gradients are rounding,
    which AdamW scales up to the lr)."""
    batches, jax_metrics, states, _ = jax_engine_run(path, SMALL, tmp_path / "jax")
    e = Engine(engine_config(path, tmp_path, *SMALL), mode="train", device="cpu")
    assert isinstance(e.model, cls) and e.criterion is not None and e.grad_clip is not None
    cancelled = _cancelled(e.model)
    assert len(cancelled) == (6 if cls is port_cvt.CvT else 2)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "CELoss"} <= set(want)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t,
                           skip=lambda name: name in cancelled)
    assert e.state.step == STEPS
    e.close()


# ------------------------------------------------------------------ census

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "cvt", "*.yaml"))
                 + glob.glob(os.path.join(REPO, "configs", "mlp_mixer", "*.yaml")))


def test_the_census_holds_6_cvt_and_3_mixer_configs():
    assert len(CONFIGS) == 9
    assert sum("/cvt/" in p for p in CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_cvt_and_mixer_config_builds(path):
    config = cfg_util.get_config(path, show=False)
    _refuse_unported(config)
    with torch.device("meta"):
        model = build_model(dict(config["Model"]))
    assert isinstance(model, port_cvt.CvT if "/cvt/" in path else port_mixer.MlpMixer)
    n = sum(p.numel() for p in model.parameters())
    if path.endswith("cvt_w24_384_in1k.yaml"):
        assert round(n / 1e6, 2) == 277.20
    assert n > 0


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
@pytest.mark.parametrize("path", [CVT_CFG, MIXER_CFG], ids=["cvt", "mixer"])
def test_tiny_config_trains_on_the_card(path, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(path, tmp_path, *SMALL, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    head = e.model.head.weight.detach().clone()
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert not torch.equal(e.model.head.weight, head)
