"""XCiT of the PyTorch port (passl_tpu_torch/models/xcit.py) against the JAX
package.

On the CPU, at tiny sizes, from the JAX parameters converted, on the same
numpy inputs: XCA's output and every gradient in f32 (q and k normalized
over the tokens, the per-head temperature of shape (h, 1, 1)) and its
output in bf16; LPI's output, gradients and BatchNorm statistics in
training and its eval output; the whole model with the /8 stem (3 stride-2
convs) and the /16 stem (4) and the class-attention stage, its train-mode
logits on the port's stochastic-depth draws handed to JAX, every gradient,
LPI's statistics and the eval logits; 3 steps of
configs/xcit/xcit_tiny_synthetic.yaml through the JAX engine and the port's
from JAX's state. Then the census of the 22 configs under configs/xcit/: the
15 without a teacher build, and the 7 `*_dist_in1k` configs are refused,
naming the JAX engine's failure on them. A test marked `cuda` trains the
tiny config on the card and skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine, _refuse_unported
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import xcit as port_xcit
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_beit import (SMALL, STEPS, assert_grads_match, engine_config,
                             handed_bernoulli, jax_engine_run, recorded_drop_path_draws)
from test_torch_deit import assert_step_tracks
from test_torch_moco import _one_openmp_thread, _randomize  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "xcit", "xcit_tiny_synthetic.yaml")
TINY = dict(img_size=32, embed_dim=64, depth=2, num_heads=2, num_classes=10)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _variables(jm, seed, *args, **kw):
    """Every flax leaf of `jm` drawn with numpy; the temperatures positive."""
    import jax

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                  dict(shapes)), seed)
    rng = np.random.RandomState(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape)).astype(a.dtype)
        if "temperature" in jax.tree_util.keystr(p) else a, variables)


def _load(pm, variables):
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))
    return pm


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=msg)


def _assert_stats(pm, stats):
    state = pm.state_dict()
    for path, arr in _flatten(stats).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(state[key].numpy(), arr, rtol=1e-5, atol=1e-6, err_msg=key)


# --------------------------------------------------------------- XCA, LPI


def test_xca_output_and_gradients_match_jax_in_f32():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.xcit import XCA as JaxXCA

    jm = JaxXCA(num_heads=4)
    variables = _variables(jm, 1, jnp.zeros((2, 16, 64)))
    assert variables["params"]["temperature"].shape == (4, 1, 1)
    pm = _load(port_xcit.XCA(64, 4), variables)
    assert pm.temperature.shape == (4, 1, 1)
    x, w = _rand((3, 16, 64), 2), _rand((3, 16, 64), 3)

    def loss(params, x):
        out = jm.apply({"params": params}, x)
        return (out * w).sum(), out

    (_, want), (grads, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    xt = torch.from_numpy(x).requires_grad_()
    got = pm(xt)
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, jax.device_get(grads))
    _close(xt.grad.numpy(), np.asarray(gx), 1e-4)


def test_xca_output_matches_jax_in_bf16():
    """bf16 products and the cast softmax, f32 normalization and scores on
    both sides: the two round in other places (cosine and a bf16 step of the
    largest entry)."""
    import jax.numpy as jnp

    from passl_tpu.models.xcit import XCA as JaxXCA

    jm = JaxXCA(num_heads=4, dtype=jnp.bfloat16)
    variables = _variables(jm, 4, jnp.zeros((2, 16, 64)))
    pm = _load(port_xcit.XCA(64, 4, dtype=torch.bfloat16), variables)
    x = _rand((3, 16, 64), 5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.9999 and np.abs(got - want).max() <= 2**-7 * np.abs(want).max()


def test_lpi_output_gradients_and_statistics_match_jax():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.xcit import LPI as JaxLPI

    jm = JaxLPI(grid=4)
    variables = _variables(jm, 6, jnp.zeros((2, 16, 32)), train=False)
    pm = _load(port_xcit.LPI(32, 4), variables)
    x, w = _rand((3, 16, 32), 7), _rand((3, 16, 32), 8)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return (out * w).sum(), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got = pm.train()(torch.from_numpy(x))
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, jax.device_get(grads))
    assert pm.conv1.groups == pm.conv2.groups == 32 and pm.conv1.weight.shape == (32, 1, 3, 3)
    _assert_stats(pm, jax.device_get(stats))
    want = jm.apply({"params": variables["params"], "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)).numpy(), np.asarray(want))


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("patch_size, convs", [(8, 3), (16, 4)], ids=["p8", "p16"])
def test_xcit_matches_jax_with_both_stems_and_the_class_attention(patch_size, convs):
    """Train-mode logits on the port's stochastic-depth draws (linspace(0,
    0.5, 2): block 1 draws for XCA, LPI and the MLP, in that order) handed to
    JAX, every gradient, LPI's statistics, and the eval logits."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.xcit import XCiT as JaxXCiT

    kw = dict(TINY, patch_size=patch_size, drop_path_rate=0.5)
    jm = JaxXCiT(**kw)
    variables = _variables(jm, 9, jnp.zeros((1, 32, 32, 3)), train=False)
    pm = _load(port_xcit.XCiT(**kw), variables)
    assert [hasattr(pm, f"patch_proj{i}") for i in range(5)] == [i < convs for i in range(5)]
    assert pm.patch_proj0.weight.shape[0] == 64 // 2 ** (convs - 1)
    assert len(pm.cls_attn) == 2 and not any("cls_attn" in n and ("mlp" in n or "gamma" in n)
                                             for n, _ in pm.named_parameters())
    x, w = _rand((4, 32, 32, 3), 10), _rand((4, 10), 11)
    pm.train()
    with recorded_drop_path_draws() as draws:
        got = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    assert len(draws) == 3
    masks = [(u < 1.0 - rate).numpy() for u, rate in draws]

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * w).sum(), (out, mut["batch_stats"])

    with handed_bernoulli(masks) as calls:
        (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    assert len(calls) == 3
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, jax.device_get(grads))
    _assert_stats(pm, jax.device_get(stats))
    want = jm.apply({"params": variables["params"], "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)).numpy(), np.asarray(want))


def test_every_xcit_factory_is_the_jax_one():
    from passl_tpu.models import MODELS as JAX_MODELS

    assert len(port_xcit._XCIT) == 14
    for name, cfg in port_xcit._XCIT.items():
        jm, pm = JAX_MODELS.get(name)(), port_xcit.MODELS.get(name)
        assert {k: getattr(jm, k) for k in cfg} == cfg, name
        with torch.device("meta"):
            model = pm()
        assert (len(model.blocks), model.embed_dim, model.steps) == (
            cfg["depth"], cfg["embed_dim"], int(np.log2(cfg["patch_size"]))), name
        assert model.blocks[0].init_values == cfg["init_values"], name


# ----------------------------------------------------- the slice as a whole


def test_tiny_xcit_steps_along_the_jax_engine(tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, clip 1, CE with
    smoothing 0.1) from JAX's state: the loss, every parameter's change and
    AdamW moments but the key biases', and LPI's statistics (1e-5 relative)."""
    batches, jax_metrics, states, _ = jax_engine_run(TINY_CFG, SMALL, tmp_path / "jax")
    e = Engine(engine_config(TINY_CFG, tmp_path, *SMALL), mode="train", device="cpu")
    assert isinstance(e.model, port_xcit.XCiT)
    stats = [k for k in e.model.state_dict() if ".running_" in k]
    assert len(stats) == 4  # LPI's BatchNorm in each of the 2 blocks
    # the class attention's key bias adds one constant to every score of the
    # cls token's row, which the softmax cancels: its gradient is rounding on
    # both sides (held under 1e-6 of the largest first moment), AdamW's
    # update of it a sign of noise
    key_bias = [n for n, _ in e.model.named_parameters() if n.endswith(".k.bias")]
    assert key_bias == ["cls_attn.0.k.bias", "cls_attn.1.k.bias"]
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "CELoss"} <= set(want)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t,
                           skip=lambda name: ".running_" in name or name in key_bias)
        got, jax_after = e.model.state_dict(), states[t + 1][0]
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), jax_after[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=(t, k))
        m = {n: e.optimizer.torch_optimizer.state[p]["exp_avg"].abs().max().item()
             for n, p in e.model.named_parameters()}
        assert max(m[n] for n in key_bias) <= 1e-6 * max(m.values()), (t, m)
    assert e.state.step == STEPS
    e.close()


# ------------------------------------------------------------------ census

XCIT_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "xcit", "*.yaml")))
DIST = [p for p in XCIT_CONFIGS if p.endswith("_dist_in1k.yaml")]


def test_the_census_holds_22_configs_7_with_a_teacher():
    assert len(XCIT_CONFIGS) == 22 and len(DIST) == 7


@pytest.mark.parametrize("path", XCIT_CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_xcit_config_builds_or_is_refused_as_jax_fails(path):
    """The 15 configs without a teacher build on the meta device; the 7
    `*_dist_in1k` configs name DistillationWrapper beside `Loss.Train`, on
    which the JAX engine fails at its init
    (tests/test_torch_distillation.py holds that failure), and the port's
    engine refuses them, naming it."""
    config = cfg_util.get_config(path, show=False)
    if path in DIST:
        assert config["Model"]["name"] == "DistillationWrapper" and config["Loss"]["Train"]
        with pytest.raises(NotImplementedError, match=r"fails at its init.*distillation\.py:36"):
            _refuse_unported(config)
        return
    _refuse_unported(config)
    with torch.device("meta"):
        model = build_model(dict(config["Model"]))
    assert isinstance(model, port_xcit.XCiT)
    assert sum(p.numel() for p in model.parameters()) > 0


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_xcit_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(TINY_CFG, tmp_path, *SMALL, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if ".running_" in k}
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    after = e.model.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in stats0.items())
