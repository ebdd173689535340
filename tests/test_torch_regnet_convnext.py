"""RegNet and ConvNeXt of the PyTorch port (passl_tpu_torch/models/regnet.py,
convnext.py) against the JAX package.

On the CPU: the stage widths, depths and group widths of all seven RegNet
factories equal JAX's, and so do the names and shapes of every parameter and
statistic their models hold (the grouped 3x3 kernels `[3, 3, w / g, w]` ->
`[w, w / g, 3, 3]`, the SE widths of the blocks' inputs); at tiny sizes, from
the JAX parameters converted, on the same numpy inputs: the RegNetX and
RegNetY logits in training and eval, every gradient (1e-4 of its largest
entry) and the BatchNorm statistics after the step; the ConvNeXt logits with
the port's stochastic-depth draws handed to JAX, and its SAME-padded stem at a
size the stride does not divide; 3 steps of each tiny config through the JAX
engine and the port's from JAX's state. Then the census: the RegNet config
and both ConvNeXt configs build. A test marked `cuda` trains both tiny
configs on the card and skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import convnext as port_convnext
from passl_tpu_torch.models import regnet as port_regnet
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_beit import (SMALL, STEPS, assert_grads_match, engine_config,
                             finetune_logits_match, jax_engine_run)
from test_torch_deit import assert_step_tracks
from test_torch_moco import _one_openmp_thread, _randomize  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS = os.path.join(REPO, "configs", "classification")
REGNET_FACTORIES = ["RegNetX_200MF", "RegNetX_400MF", "RegNetX_1600MF", "RegNetX_4GF",
                    "RegNetY_400MF", "RegNetY_4GF", "RegNetY_160"]
TINY_REGNET = dict(w_a=24.48, w_0=24, w_m=2.54, depth=6, group_width=8, num_classes=10)
TINY_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=10)


def _images(n, seed, size=32):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _jax_variables(jm, seed, size=32):
    """Every flax leaf of `jm` (params and batch_stats) drawn with numpy."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                                            train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return _randomize(zeros, seed)


def _port_model(cls, kw, variables):
    pm = cls(**kw)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))
    return pm


# ------------------------------------------------------------------ RegNet


@pytest.mark.parametrize("name", REGNET_FACTORIES)
def test_regnet_factory_widths_depths_groups_and_shapes_are_jaxs(name):
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.models import regnet as jax_regnet

    jm = jax_build_model({"name": name})
    widths, depths = jax_regnet.generate_regnet(jm.w_a, jm.w_0, jm.w_m, jm.depth)
    widths, groups = jax_regnet.adjust_widths_groups(widths, jm.group_width)
    with torch.device("meta"):
        pm = build_model({"name": name})
    assert (pm.widths, pm.depths, pm.group_widths) == (widths, depths, groups)
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                               train=False))
    want = {}
    for coll, stats in (("params", False), ("batch_stats", True)):
        for path, leaf in _flatten(jax.tree_util.tree_map(
                lambda s: np.empty(s.shape, np.float32), dict(variables[coll]))).items():
            key, arr = _torch_name(path, leaf, stats)
            want[key] = tuple(arr.shape)
    assert want == {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    for bname in pm.block_names:  # groups = max(1, w // group width)
        blk = getattr(pm, bname)
        w = blk.conv3.weight.shape[0]
        assert blk.conv2.groups == max(1, w // jm.group_width)


@pytest.mark.parametrize("se_ratio", [0.0, 0.25], ids=["RegNetX", "RegNetY"])
def test_tiny_regnet_logits_gradients_and_statistics_match_jax(se_ratio):
    """Against the JAX model run in f64 (`jax.enable_x64`): flax's BatchNorm
    takes its variance as E[x^2] - E[x]^2, which in f32 loses the digits of
    RegNetY's last stage (its inputs, relu'd and squeezed by the SE, sit far
    from 0 against their spread, 24 values a channel): JAX's own f32
    gradients lie up to 16% of their largest entry from its f64 ones there,
    where the port's two-pass statistics keep f32 within 1e-4 (ROADMAP.md,
    Queue 3, deliberate differences)."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.regnet import RegNet as JaxRegNet

    kw = dict(TINY_REGNET, se_ratio=se_ratio)
    variables = _jax_variables(JaxRegNet(**kw), 1 + int(se_ratio > 0))
    pm = _port_model(port_regnet.RegNet, kw, variables)
    assert all((getattr(pm, b).se is not None) == (se_ratio > 0) for b in pm.block_names)
    x = _images(6, 2)
    w = np.random.RandomState(3).randn(6, 10)
    with jax.enable_x64(True):
        jm = JaxRegNet(**kw, dtype=jnp.float64)
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss(params):
            out, mut = jm.apply({"params": params, "batch_stats": f64["batch_stats"]},
                                x.astype(np.float64), train=True, mutable=["batch_stats"])
            return (out * w).sum(), (out, mut["batch_stats"])

        (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(f64["params"])
        want, stats, grads = jax.device_get((want, stats, grads))
        want_eval = np.asarray(jm.apply({"params": f64["params"], "batch_stats": stats},
                                        x.astype(np.float64), train=False))
    got = pm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    (got * torch.from_numpy(w).float()).sum().backward()
    assert_grads_match(pm, grads)
    state = pm.state_dict()
    for path, arr in _flatten(stats).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(state[key].numpy(), arr, rtol=1e-5, atol=1e-6, err_msg=key)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_eval, rtol=1e-5, atol=1e-5 * np.abs(want_eval).max())


# ---------------------------------------------------------------- ConvNeXt


def test_convnext_logits_match_jax_with_drop_path():
    from passl_tpu.models.convnext import ConvNeXt as JaxConvNeXt

    kw = dict(TINY_CONVNEXT, drop_path_rate=0.5, layer_scale_init_value=0.5)
    jm = JaxConvNeXt(**kw)
    variables = _jax_variables(jm, 4)
    assert set(variables) == {"params"}
    pm = _port_model(port_convnext.ConvNeXt, kw, variables)
    # linspace(0, 0.5, 4): the first block draws nothing, the other three once
    finetune_logits_match(jm, variables["params"], pm, _images(6, 5), 3)


def test_convnext_same_padding_and_head_init_scale():
    """At 36 x 36 the stride-4 stem pads one row and column each side (flax's
    SAME) and the downsamples pad after; `head_init_scale` scales only the
    head's trunc-normal std."""
    from passl_tpu.models.convnext import ConvNeXt as JaxConvNeXt

    jm = JaxConvNeXt(**TINY_CONVNEXT)
    variables = _jax_variables(jm, 6, size=36)
    pm = _port_model(port_convnext.ConvNeXt, TINY_CONVNEXT, variables)
    x = _images(2, 7, size=36)
    want = np.asarray(jm.apply(variables, x, train=False))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    from passl_tpu_torch.nn.init import init_module

    stds = []
    for scale in (1.0, 0.1):
        m = init_module(port_convnext.ConvNeXt(**dict(TINY_CONVNEXT, dims=(16, 32, 64, 512)),
                                               head_init_scale=scale),
                        torch.Generator().manual_seed(0))
        stds.append((m.head.weight.std().item(), m.stem_conv.weight.std().item()))
    assert stds[1][0] == pytest.approx(0.1 * stds[0][0], rel=1e-5)
    assert stds[1][1] == stds[0][1]


# ----------------------------------------------------- the slice as a whole

@pytest.mark.parametrize("config, cls", [
    ("regnet_tiny_synthetic.yaml", port_regnet.RegNet),
    ("convnext_tiny_synthetic.yaml", port_convnext.ConvNeXt),
])
def test_tiny_config_steps_along_the_jax_engine(config, cls, tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, CE with smoothing 0.1)
    from JAX's state: the loss, every parameter's change, the AdamW moments
    and RegNet's BatchNorm statistics (1e-5 relative)."""
    path = os.path.join(CLS, config)
    batches, jax_metrics, states, _ = jax_engine_run(path, SMALL, tmp_path / "jax")
    e = Engine(engine_config(path, tmp_path, *SMALL), mode="train", device="cpu")
    assert isinstance(e.model, cls)
    stats = [k for k in e.model.state_dict() if ".running_" in k]
    assert bool(stats) == (cls is port_regnet.RegNet)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "CELoss"} <= set(want)
        # the statistics move by the batch's, not by the lr: held below
        assert_step_tracks(e, b, want, states[t], states[t + 1], t,
                           skip=lambda name: ".running_" in name)
        got, jax_after = e.model.state_dict(), states[t + 1][0]
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), jax_after[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=(t, k))
    assert e.state.step == STEPS
    e.close()


# ------------------------------------------------------------------ census

CENSUS = {"RegNet": [os.path.join(CLS, "regnet_tiny_synthetic.yaml")],
          "ConvNeXt": sorted(glob.glob(os.path.join(CLS, "convnext_*.yaml")))}


def test_the_census_holds_one_regnet_and_two_convnext_configs():
    assert [len(v) for v in CENSUS.values()] == [1, 2]


@pytest.mark.parametrize("path", [p for v in CENSUS.values() for p in v],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_every_regnet_and_convnext_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ in ("RegNet", "ConvNeXt")
    assert sum(p.numel() for p in model.parameters()) > 0


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["regnet_tiny_synthetic.yaml", "convnext_tiny_synthetic.yaml"])
def test_tiny_config_trains_on_the_card(config, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(os.path.join(CLS, config), tmp_path, *SMALL,
                             "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
