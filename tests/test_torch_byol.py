"""BYOL ResNet of the PyTorch port against the JAX package.

On the CPU, at tiny sizes: `nn.norm.BatchNorm` against flax's `nn.BatchNorm`
(output and running statistics after two train calls, f32 and bf16, biased
variance); tiny ResNets (basic and bottleneck blocks, `layers=[1, 1, 1, 1]`,
CIFAR and conv7 stems) and `NonLinearNeckV2` from converted weights
(forward, gradients, `batch_stats`); `l2_normalize`, the regression loss and
the EMA momentum schedule; `MomentumLARS` against the JAX rule on 2-D, 1-D
and all-zero tensors; the frozen group against the JAX optimizer's; the
refusals; and the slice as a whole: the tiny BYOL of
configs/byol/byol_r18_synthetic.yaml (16 x 16 images, batch 8, necks of 64)
tracks the JAX engine for 4 steps from the converted init on the JAX
loader's batches. A test marked `cuda` runs the tiny BYOL's train step on
the card and skips elsewhere.
"""
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.steps import apply_ema_pairs, ema_momentum_schedule, ema_pairs_of
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.byol import BYOL, byol_regression_loss
from passl_tpu_torch.models.necks import NonLinearNeckV2, NonLinearNeckV3
from passl_tpu_torch.models.resnet import ResNet
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.nn.norm import BatchNorm, l2_normalize
from passl_tpu_torch.optimizer import MomentumLARS, build_optimizer
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "byol", "byol_r18_synthetic.yaml")
# f32 forward and backward against XLA's: the same f32 math summed in another order
F32_TOL = 1e-5


def _randomize(tree, seed):
    """Every flax leaf redrawn with numpy at a scale where each part shows."""
    import jax

    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if "'var'" in name:
            return 0.5 + rng.rand(*shape)
        return 0.2 * rng.randn(*shape)  # biases and running means

    return jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(draw(p, x), np.float32), tree)


def _port_grads(grads) -> dict:
    """flax gradients by the port's parameter names and layouts."""
    return dict(_torch_name(path, arr) for path, arr in _flatten(grads).items())


# --------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spatial", [True, False])
def test_batchnorm_matches_flax(dtype, spatial):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    shape = (6, 5, 4, 8) if spatial else (12, 8)
    xs = [(rng.randn(*shape) * 2 + 1.5).astype(np.float32) for _ in range(2)]
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.dtype(dtype))
    variables = _randomize(jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))), 1)
    pm = BatchNorm(8, dtype=getattr(torch, dtype))
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    stats = variables["batch_stats"]

    def to_port(x):  # flax NHWC -> the port's NCHW
        t = torch.from_numpy(x).to(getattr(torch, dtype))
        return t.permute(0, 3, 1, 2) if spatial else t

    for x in xs:  # two train calls: the running statistics compound
        want, mut = fm.apply({"params": variables["params"], "batch_stats": stats},
                             jnp.asarray(x).astype(dtype), mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = pm(to_port(x))
        got = got.permute(0, 2, 3, 1) if spatial else got
        assert got.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32_TOL,
                                       atol=F32_TOL)
        else:  # both normalize in f32 from the same bf16 input and round once
            np.testing.assert_allclose(got.detach().float().numpy(),
                                       np.asarray(want.astype(jnp.float32)), rtol=0, atol=2e-2)
        # statistics in f32 either way: E[x^2] - E[x]^2 (flax) or Welford (torch)
        np.testing.assert_allclose(pm.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(pm.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5,
                                   atol=1e-6)
    # eval: the running statistics (flax use_running_average)
    fe = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    want = fe.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(xs[0]))
    got = pm.eval()(to_port(xs[0]).float())
    got = got.permute(0, 2, 3, 1) if spatial else got
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=2e-2 if dtype == "bfloat16" else F32_TOL,
                               atol=2e-2 if dtype == "bfloat16" else F32_TOL)


def test_batchnorm_variance_keeps_the_digits_flax_fast_variance_loses():
    """Inputs far from zero: flax takes var = E[x^2] - E[x]^2 in f32, which
    cancels; the port's (PyTorch's) two-pass variance stays at the float64
    value. Raw 0-255 pixels into the stem are such inputs."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x = (1000.0 + 0.1 * np.random.RandomState(3).randn(64, 4)).astype(np.float32)
    truth = x.astype(np.float64).var(axis=0)
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.0, epsilon=1e-5)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, mut = fm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(4, momentum=0.0)
    bn.reset_parameters()
    bn(torch.from_numpy(x))
    np.testing.assert_allclose(bn.running_var.numpy(), truth, rtol=1e-3)
    assert np.abs(np.asarray(mut["batch_stats"]["var"]) / truth - 1).max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8), (1, 1, 1, 8)], ids=["features", "spatial"])
def test_batchnorm_on_one_value_per_channel_matches_flax(dtype, shape):
    """Training on a [1, C] batch (or one 1 x 1 image): flax's variance is
    max(E[x^2] - E[x]^2, 0) = 0, so the output is the bias, x gets no
    gradient and the running variance decays towards 0; F.batch_norm would
    raise there."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x = (np.random.RandomState(4).randn(*shape) * 2 + 1).astype(np.float32)
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.dtype(dtype))
    variables = _randomize(jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 5)
    pm = BatchNorm(8, dtype=getattr(torch, dtype))
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))

    def loss(xx):
        y, mut = fm.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.arange(8.0)), (y, mut)

    (_, (want, mut)), gx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x).astype(dtype))
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    t = t.permute(0, 3, 1, 2) if len(shape) == 4 else t
    t.requires_grad_()
    got = pm(t)
    (got.float() * torch.arange(8.0).view([1, 8] + [1] * (t.dim() - 2))).sum().backward()
    got = got.permute(0, 2, 3, 1) if len(shape) == 4 else got
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got.detach().float().numpy().reshape(-1),
                                  torch.from_numpy(np.asarray(variables["params"]["bias"]))
                                  .to(getattr(torch, dtype)).float().numpy())
    grad = t.grad.permute(0, 2, 3, 1) if len(shape) == 4 else t.grad
    np.testing.assert_array_equal(grad.float().numpy(), np.asarray(gx.astype(jnp.float32)))
    assert not grad.any()
    np.testing.assert_allclose(pm.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.running_var.numpy(), 0.9 * np.asarray(variables["batch_stats"]["var"]),
                               rtol=1e-6)


def test_batchnorm_update_uses_the_biased_variance():
    bn = BatchNorm(3)
    bn.reset_parameters()
    x = torch.randn(4, 3, 2, 2) * 3
    bn(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)), rtol=1e-6, atol=1e-6)
    assert "num_batches_tracked" not in bn.state_dict()
    no_affine = BatchNorm(3, use_bias=False, use_scale=False)
    assert [n for n, _ in no_affine.named_parameters()] == []


def test_l2_normalize_and_regression_loss_match_jax():
    import jax.numpy as jnp

    from passl_tpu.models.byol import byol_regression_loss as jax_loss
    from passl_tpu.nn.norm import l2_normalize as jax_l2

    rng = np.random.RandomState(2)
    x = rng.randn(5, 7).astype(np.float32)
    x[1] = 0.0  # the 1e-12 clamp: a zero row stays zero
    x[2] = 1e-8
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_l2(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    p, z = rng.randn(6, 9).astype(np.float32), rng.randn(6, 9).astype(np.float32)
    got = byol_regression_loss(torch.from_numpy(p).bfloat16(), torch.from_numpy(z))
    want = jax_loss(jnp.asarray(p).astype(jnp.bfloat16), jnp.asarray(z))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", None])
def test_ema_momentum_schedule_matches_jax(schedule):
    import jax.numpy as jnp

    from passl_tpu.engine.steps import ema_momentum_schedule as jax_schedule

    cfg = {"momentum": 0.996, **({"schedule": schedule} if schedule else {})}
    got, want = ema_momentum_schedule(cfg, 32), jax_schedule(cfg, 32)
    for step in (0, 1, 7, 16, 31, 32, 40):
        assert got(step) == float(want(jnp.asarray(step, jnp.int32))), step


# ----------------------------------------------------------- ResNet, necks


RESNETS = [
    dict(block="basic", layers=[1, 1, 1, 1], cifar_stem=True, num_classes=5),
    dict(block="bottleneck", layers=[1, 1, 1, 1], cifar_stem=False, num_classes=5),
    dict(block="bottleneck", layers=[1, 1, 1, 1], cifar_stem=False, num_classes=0,
         with_pool=False, groups=2, width_per_group=32),
]


def _flax_and_port(jm, pm, x, seed):
    import jax
    import jax.numpy as jnp

    variables = jax.device_get(jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=True))(
        jnp.asarray(x)))
    variables = _randomize(variables, seed)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    return variables


@pytest.mark.parametrize("kw", RESNETS, ids=["basic-cifar", "bottleneck-conv7", "resnext-map"])
def test_tiny_resnet_matches_jax(kw):
    """Train-mode forward, every gradient of sum(out * w), and the new
    batch_stats; then the eval forward on the updated statistics."""
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.resnet as jax_resnet

    x = np.random.RandomState(3).randn(8, 16, 16, 3).astype(np.float32)
    jm = jax_resnet.ResNet(**{**kw, "layers": tuple(kw["layers"])})
    pm = ResNet(**kw)
    variables = _flax_and_port(jm, pm, x, seed=4)
    out_shape = jax.eval_shape(lambda: jm.apply(variables, jnp.asarray(x), train=True,
                                                mutable=["batch_stats"])[0]).shape
    w = np.random.RandomState(5).randn(*out_shape).astype(np.float32)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got = pm.train()(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = _port_grads(jax.device_get(grads))
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        g, wg = p.grad.numpy(), want_g[name]
        # f32 summed in another order, through BatchNorm backwards whose
        # statistics cover 8 entries a channel at the 1 x 1 maps of the conv7
        # stem's last stages (a division by the spread of 8 numbers amplifies
        # the rounding): 1e-3 of the tensor's largest entry
        np.testing.assert_allclose(g, wg, rtol=1e-3, atol=1e-3 * np.abs(wg).max(), err_msg=name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    want_eval = jm.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
                         train=False)
    with torch.no_grad():
        got_eval = pm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cls_name", ["NonLinearNeckV2", "NonLinearNeckV3"])
def test_neck_matches_jax_on_a_feature_map(cls_name):
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.necks as jax_necks

    x = np.random.RandomState(6).randn(6, 3, 3, 16).astype(np.float32)
    jm = getattr(jax_necks, cls_name)(hid_channels=32, out_channels=8)
    pm = {"NonLinearNeckV2": NonLinearNeckV2, "NonLinearNeckV3": NonLinearNeckV3}[cls_name](
        16, 32, 8)
    variables = _flax_and_port(jm, pm, x, seed=7)
    w = np.random.RandomState(8).randn(6, 8).astype(np.float32)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    got = pm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = _port_grads(jax.device_get(grads))
    # f32 in another order: 1e-4 of the largest gradient (fc1's bias feeds a
    # BatchNorm, so its true gradient is 0 and both sides give rounding noise)
    atol = 1e-4 * max(np.abs(g).max() for g in want_g.values())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=1e-4, atol=atol,
                                   err_msg=name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6)


def test_resnet50_names_and_shapes_map_onto_the_port():
    """Full width, without allocating: flax shapes from eval_shape, the port on meta."""
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.resnet as jax_resnet

    jm = jax_resnet.resnet50(num_classes=0, with_pool=False)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                            train=True))
    with torch.device("meta"):
        pm = build_model({"name": "resnet50", "num_classes": 0, "with_pool": False})
    mapped = {}
    for coll, stats in (("params", False), ("batch_stats", True)):
        tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                      shapes[coll])
        for path, leaf in _flatten(tree).items():
            key, arr = _torch_name(path, leaf, stats)
            mapped[key] = tuple(arr.shape)
    assert mapped == {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    n_params = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_params == 23_508_032
    assert pm.out_channels == 2048


def test_resnet_runs_channels_last_whatever_the_input_strides():
    """The device augmentation's views are laid out [N, W, H, C]: the
    backbone still hands every conv and BatchNorm channels-last tensors."""
    from passl_tpu_torch.ops.augment import byol_device_augment

    v = torch.from_numpy(np.random.RandomState(10).randint(0, 256, (4, 16, 16, 3), dtype=np.uint8))
    views = byol_device_augment(v, v, torch.Generator().manual_seed(0))
    assert not views[0].is_contiguous()
    model = init_module(ResNet(block="basic", layers=[1, 1, 1, 1], num_classes=0),
                        torch.Generator().manual_seed(0))
    layouts = []
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, BatchNorm)):
            m.register_forward_hook(lambda m, inp, out: layouts.append(
                inp[0].is_contiguous(memory_format=torch.channels_last)))
    out = model(views[0])
    assert len(layouts) == 2 * 12 and all(layouts)
    torch.testing.assert_close(out, model(views[0].contiguous()), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                                  "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d"])
def test_every_variant_is_registered(name):
    with torch.device("meta"):
        model = build_model({"name": name, "num_classes": 0})
    assert model.out_channels == (512 if name in ("resnet18", "resnet34") else 2048)


# every (factory, fixed field) of the eight variants, with a value the
# factory does not fix itself
_FIXED = {"block": "bottleneck", "layers": (1, 1, 1, 1), "groups": 2, "width_per_group": 32}
_FACTORY_FIELDS = [
    ("resnet18", "block"), ("resnet18", "layers"), ("resnet34", "block"), ("resnet34", "layers"),
    ("resnet50", "block"), ("resnet50", "layers"), ("resnet101", "block"),
    ("resnet101", "layers"), ("resnet152", "block"), ("resnet152", "layers"),
    ("wide_resnet50_2", "block"), ("wide_resnet50_2", "layers"),
    ("wide_resnet50_2", "width_per_group"), ("wide_resnet101_2", "block"),
    ("wide_resnet101_2", "layers"), ("wide_resnet101_2", "width_per_group"),
    ("resnext50_32x4d", "block"), ("resnext50_32x4d", "layers"), ("resnext50_32x4d", "groups"),
    ("resnext50_32x4d", "width_per_group"),
]


@pytest.mark.parametrize("name, field", _FACTORY_FIELDS)
def test_resnet_factory_refuses_a_fixed_field_as_jax_does(name, field):
    """A config that repeats a field the named factory fixes (`name:
    resnext50_32x4d, groups: 1`) raises TypeError in both packages, instead
    of building another network under the factory's name."""
    from passl_tpu.models import build_model as jax_build_model

    cfg = {"name": name, "num_classes": 0, field: _FIXED[field]}
    with pytest.raises(TypeError):
        jax_build_model(dict(cfg))
    with pytest.raises(TypeError), torch.device("meta"):
        build_model(dict(cfg))


@pytest.mark.parametrize("kw, match", [
    ({"stem_impl": "s2d"}, "stem_impl"),
    ({"bn_impl": "ghost_grad"}, "bn_impl"),
    ({"bn_impl": "fused_grad"}, "bn_impl"),
    ({"bn_stats_stride": 2}, "bn_stats"),
    ({"bn_stats_slice": 2}, "bn_stats"),
])
def test_resnet_refuses_what_the_port_does_not_carry(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        ResNet(block="basic", layers=[1, 1, 1, 1], **kw)


@pytest.mark.parametrize("kw", [{"bn_stats_stride": 2}, {"bn_stats_slice": 2}])
def test_bn_splits_with_subsampled_statistics_raises_as_jax_does(kw):
    """SplitBatchNorm already takes per-split statistics: `bn_splits`
    together with `bn_stats_stride` / `bn_stats_slice` is a ValueError in both
    packages (JAX raises it where it builds the norm, at init)."""
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.resnet as jax_resnet

    jm = jax_resnet.ResNet(block="basic", layers=(1, 1, 1, 1), num_classes=0, bn_splits=2, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 3)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ResNet(block="basic", layers=[1, 1, 1, 1], num_classes=0, bn_splits=2, **kw)


# -------------------------------------------------------------- optimizer


def test_momentum_lars_matches_the_jax_rule():
    import jax.numpy as jnp

    from passl_tpu.optimizer.transforms import Momentum as JaxMomentum
    from passl_tpu.optimizer.transforms import MomentumLARS as JaxLARS

    rng = np.random.RandomState(9)
    tensors = {"w2d": rng.randn(6, 4), "w4d": rng.randn(3, 2, 2, 2), "b1d": rng.randn(5),
               "zero2d": np.zeros((3, 3)), "nograd2d": rng.randn(2, 3)}
    tensors = {k: v.astype(np.float32) for k, v in tensors.items()}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * (0 if k == "nograd2d" else 1)
              for k, v in tensors.items()} for _ in range(3)]
    wd = {"w2d": 1e-2, "w4d": 1e-2, "b1d": 0.0, "zero2d": 1e-2, "nograd2d": 0.0}
    lrs = [0.5, 0.3, 0.1]
    for jax_rule, kw in ((JaxLARS(momentum=0.9, trust_coefficient=0.02), dict(lars=True)),
                         (JaxMomentum(momentum=0.8), dict(lars=False, momentum=0.8))):
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tensors.items()}
        groups = [{"params": [params[k]], "weight_decay": wd[k]} for k in params]
        opt = MomentumLARS(groups, **({"momentum": 0.9, "trust_coefficient": 0.02}
                                      if kw["lars"] else {}), **kw)
        jp = {k: jnp.asarray(v) for k, v in tensors.items()}
        js = {k: jax_rule.init(v) for k, v in jp.items()}
        for step, (g, lr) in enumerate(zip(grads, lrs)):
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy())
            for pg in opt.param_groups:
                pg["lr"] = lr
            opt.step()
            for k in jp:
                jp[k], js[k] = jax_rule.update(jnp.asarray(g[k]), js[k], jp[k], lr, wd[k], step)
            for k, p in params.items():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{type(jax_rule).__name__} {k}")
                np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(),
                                           np.asarray(js[k]["buf"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["MomentumLARC", "Adan", "Adafactor"])
def test_unported_rules_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        build_optimizer({"name": name}, {"w": torch.nn.Parameter(torch.zeros(2, 2))})


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'NonLinearNeckV2', 'hid_channels': 64, 'out_channels': 64}",
    "Model.predictor={'name': 'NonLinearNeckV2', 'hid_channels': 64, 'out_channels': 64, "
    "'with_avg_pool': False}",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
    "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, {'RandFlipImage': {'prob': 0.5}}, "
    "{'ToCHWImage': {}}]}}]",
    "DataLoader.Train.sampler.batch_size=8",
]
# the parity runs: f32, and no device augmentation (a CPU torch.Generator and
# jax.random draw other numbers; tests/test_torch_augment.py holds that path),
# so the host normalizes the views: on raw 0-255 pixels flax's fast variance
# (E[x^2] - E[x]^2) loses digits that the port's BatchNorm keeps, and the
# gradients of the first stages part by 0.4% (see test_batchnorm_variance_*)
PARITY = [*TINY, "FP16.enable=False", "Model.use_device_augment=False",
          "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
          "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, {'RandFlipImage': {'prob': 0.5}}, "
          "{'NormalizeImage': {'scale': 0.00392157, 'mean': [0.485, 0.456, 0.406], "
          "'std': [0.229, 0.224, 0.225]}}, {'ToCHWImage': {}}]}}]"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def _port_state(model, variables) -> dict:
    return flax_to_torch(variables["params"], model, variables.get("batch_stats"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's init (as a torch state_dict file), its optimizer
    groups, its first 4 loader batches, and its metrics, params and
    batch_stats after 4 train steps on them."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))  # for the names and shapes
    variables0 = jax.device_get({"params": je.state.params, **je.state.model_state})
    init_file = os.path.join(str(tmp), "init.pt")
    torch.save(_port_state(port, variables0), init_file)
    groups = {_torch_name(path, leaf)[0]: je.optimizer.group_of(path).name
              for path, leaf in _flatten(variables0["params"]).items()}
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == 4:
            break
    metrics = []
    for b in batches:
        je.state, m = je.train_step(je.state, je.shard_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    final = _port_state(port, jax.device_get({"params": je.state.params,
                                              **je.state.model_state}))
    je.train_dataloader.close()
    return init_file, groups, batches, metrics, final


def test_frozen_group_matches_the_jax_optimizer(tmp_path, jax_run):
    _, jax_groups, _, _, _ = jax_run
    e = Engine(_config(tmp_path, *PARITY), mode="train", device="cpu")
    got = {name: e.optimizer.group_of(name).name for name, _ in e.model.named_parameters()}
    assert got == jax_groups
    assert {n for n, g in got.items() if g == "frozen"} == {
        n for n, _ in e.model.named_parameters() if n.startswith("target.")}
    e.close()


def test_tiny_byol_tracks_the_jax_train_step(tmp_path, jax_run):
    init_file, _, batches, jax_metrics, jax_final = jax_run
    e = Engine(_config(tmp_path, *PARITY, f"Global.pretrained_model={init_file}"), mode="train",
               device="cpu")
    # the loader tolerates a partial file: the converted one must fill every entry
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    assert not e.pretrained_report["extra"]
    init = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
    for b, want in zip(batches, jax_metrics):
        got = {k: float(v) for k, v in
               e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
        assert set(got) == set(want)
        # f32 forward and backward through 16 BatchNorms, summed in another order
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], atol=1e-6)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert e.state.step == 4
    # the target got no optimizer state: only the online tower and the predictor have buffers
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert all((id(p) in stateful) != n.startswith("target.")
               for n, p in e.model.named_parameters())
    final = e.model.state_dict()
    assert set(final) == set(jax_final)
    eps32 = float(np.finfo(np.float32).eps)
    for name, p in final.items():
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # the online parameters move by LARS steps (some by 1e-5 of their
        # size), the target by EMA, the BN statistics by the batches: each
        # tensor's change within 1e-3 of its norm, beside the f32 rounding of
        # the tensor itself at each of the 4 updates on either side (8 eps of
        # its norm); a bias that feeds a BatchNorm has a zero gradient and
        # moves by rounding noise alone, far below 1e-8
        tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8
        assert (d_port - d_jax).norm().item() <= tol, name
        assert d_jax.abs().max() > 0, name  # every entry of the state moved
    e.close()


def test_ema_pairs_follow_the_online_tower():
    model = init_module(build_model(dict(cfg_util.get_config(TINY_CFG, overrides=TINY)["Model"])),
                        torch.Generator().manual_seed(0))
    pairs = ema_pairs_of(model, model.ema_map(), total_steps=10)
    src, dst, m_fn = pairs[0]
    assert len(src) == len(dst) == len(list(model.online.parameters()))
    before = [t.detach().clone() for t in dst]
    apply_ema_pairs(pairs, 3)
    m = m_fn(3)
    assert 0.996 < m < 1.0
    for s, d, b in zip(src, dst, before):
        torch.testing.assert_close(d.detach(), m * b + (1 - m) * s.detach(), rtol=1e-6, atol=1e-7)
    assert model.frozen_patterns() == [r"^target\."]


def test_checkpoint_resumes_with_the_bn_statistics(tmp_path):
    run = tmp_path / "run"
    e = Engine(_config(run, *TINY, "Global.max_train_step=2"), mode="train", device="cpu")
    e.train()
    assert e.state.step == 2
    stats = {k: v.clone() for k, v in e.model.state_dict().items() if "running" in k}
    r = Engine(_config(tmp_path / "resume", *TINY, f"Global.checkpoint={run / 'latest.pt'}",
                       "Global.max_train_step=3", "Global.print_batch_step=1"), mode="train",
               device="cpu")
    r.train()
    assert r.train_loop.history[0]["step"] == 3 and np.isfinite(r.train_loop.history[0]["loss"])
    r2 = Engine(_config(tmp_path / "again", *TINY), mode="train", device="cpu")
    import passl_tpu_torch.utils.io as port_io

    port_io.load_checkpoint(str(run / "latest.pt"), r2.state)
    assert r2.state.step == 2
    for k, v in stats.items():
        assert torch.equal(r2.model.state_dict()[k], v), k
    r2.close()


def test_tiny_byol_trains_through_the_cli_on_the_cpu(tmp_path):
    from passl_tpu_torch.tools import train

    argv = ["-c", TINY_CFG, "--device", "cpu", "-o", f"Global.output_dir={tmp_path}",
            "-o", "Global.max_train_step=2", "-o", "Global.print_batch_step=1"]
    for o in TINY:
        argv += ["-o", o]
    e = train.main(argv)
    losses = [h["loss"] for h in e.train_loop.history]
    assert len(losses) == 2 and all(0.0 <= v <= 8.0 for v in losses)
    assert type(e.train_loop).__name__ == "ContrastiveLearningTrainingEpochLoop"
    assert e.model.use_device_augment and e.policy.compute_dtype == torch.bfloat16


# ---------------------------------------------------------------- refusals


def test_export_refuses_an_ssl_pretrain_config(tmp_path):
    with pytest.raises(ValueError, match="export targets inference models"):
        export.main(["-c", TINY_CFG, "-o", f"Global.output_dir={tmp_path}"])


def test_submodule_builder_refuses_unknown_keys_as_jax_does():
    """A class takes every key of its config block (a typo raises); `dtype`
    and `in_channels` go only where the target accepts them."""
    from passl_tpu_torch.models.builder import build_submodule

    with pytest.raises(TypeError, match="typo"):
        build_submodule({"name": "NonLinearNeckV2", "in_channels": 8, "hid_channels": 4,
                         "out_channels": 2, "typo": 1})
    with torch.device("meta"):
        neck = build_submodule({"name": "LinearNeck", "out_channels": 2}, in_channels=8,
                               dtype=torch.bfloat16, unused_default=1)
    assert neck.fc.weight.shape == (2, 8)


class _WithTransforms(BYOL):
    def param_transforms(self):
        return []


def test_engine_refuses_param_transforms(tmp_path):
    from passl_tpu_torch.models.base import MODELS

    if "_ByolWithTransforms" not in MODELS:
        MODELS.register(_WithTransforms, name="_ByolWithTransforms")
    with pytest.raises(NotImplementedError, match="param_transforms"):
        Engine(_config(tmp_path, *TINY, "Model.name=_ByolWithTransforms"), mode="train",
               device="cpu")


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_byol_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
