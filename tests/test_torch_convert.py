"""flax -> torch weight conversion (passl_tpu_torch/utils/convert.py).

The tiny CaiT of configs/classification/cait_tiny_synthetic.yaml, initialized
by the JAX package on the CPU, carried into the port's model: every flax leaf
is consumed, every torch parameter is filled, layouts are transposed, and
anything left over on either side raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passl_tpu.models import cait as jax_cait
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.cait import CaiT
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
            depth_token_only=1, num_classes=10, th_impl="einsum")


@pytest.fixture(scope="module")
def flax_params():
    model = jax_cait.CaiT(**TINY)
    init = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))
    variables = init(jnp.zeros((1, 32, 32, 3)))
    return jax.device_get(variables["params"])


def test_every_leaf_consumed_and_every_parameter_filled(flax_params):
    model = CaiT(**TINY)
    state = flax_to_torch(flax_params, model)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(_flatten(flax_params))
    model.load_state_dict(state, strict=True)
    n_flax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(flax_params))
    assert sum(p.numel() for p in model.parameters()) == n_flax


def test_layouts(flax_params):
    state = flax_to_torch(flax_params, CaiT(**TINY))
    qkv = flax_params["blocks_1"]["attn"]["qkv"]["kernel"]  # Dense [in, out]
    np.testing.assert_array_equal(state["blocks.1.attn.qkv.weight"].numpy(), qkv.T)
    conv = flax_params["patch_embed"]["proj"]["kernel"]  # HWIO
    np.testing.assert_array_equal(state["patch_embed.proj.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["norm.weight"].numpy(), flax_params["norm"]["scale"])
    np.testing.assert_array_equal(state["blocks_token_only.0.attn.q.bias"].numpy(),
                                  flax_params["blocks_token_only_0"]["attn"]["q"]["bias"])
    np.testing.assert_array_equal(state["blocks.0.attn.proj_l"].numpy(),
                                  flax_params["blocks_0"]["attn"]["proj_l"])  # [h, h] as is
    np.testing.assert_array_equal(state["blocks.0.gamma_1"].numpy(),
                                  flax_params["blocks_0"]["gamma_1"])
    assert all(t.dtype == torch.float32 for t in state.values())


def test_leftover_leaf_raises(flax_params):
    extra = {**flax_params, "blocks_2": flax_params["blocks_1"]}  # a block the model lacks
    with pytest.raises(KeyError, match="blocks_2"):
        flax_to_torch(extra, CaiT(**TINY))


def test_unfilled_parameter_raises(flax_params):
    missing = {k: v for k, v in flax_params.items() if k != "head"}
    with pytest.raises(KeyError, match="head.weight"):
        flax_to_torch(missing, CaiT(**TINY))


def test_shape_mismatch_raises(flax_params):
    with pytest.raises(ValueError, match="head"):
        flax_to_torch(flax_params, CaiT(**{**TINY, "num_classes": 7}))


def test_cait_s24_names_and_shapes_map_onto_the_port():
    """Full width, without allocating: flax shapes from eval_shape, the port on meta."""
    flax_model = jax_cait.CaiT(**{**jax_cait._CAIT["cait_s24_224"], "th_impl": "einsum"})
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))["params"]
    with torch.device("meta"):
        port = build_model({"name": "cait_s24_224"})
    target = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    mapped = {}
    for path, leaf in _flatten(jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)).items():
        key, arr = _torch_name(path, leaf)
        mapped[key] = tuple(arr.shape)
    assert mapped == target
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(int(np.prod(s)) for s in target.values()) == n_flax == 46_915_816


# ---------------------------------------------- BatchNorm statistics (batch_stats)


@pytest.fixture(scope="module")
def flax_resnet():
    from passl_tpu.models import resnet as jax_resnet

    kw = dict(block="basic", layers=(1, 1, 1, 1), num_classes=4, cifar_stem=True)
    model = jax_resnet.ResNet(**kw)
    init = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=True))
    variables = jax.device_get(init(jnp.zeros((2, 8, 8, 3))))
    return kw, variables["params"], variables["batch_stats"]


def test_batch_stats_fill_every_buffer(flax_resnet):
    from passl_tpu_torch.models.resnet import ResNet

    kw, params, stats = flax_resnet
    model = ResNet(**kw)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.5, stats)  # not the init values
    state = flax_to_torch(params, model, stats)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(_flatten(params)) + len(_flatten(stats))
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(model.layer2[0].downsample_bn.running_mean.numpy(),
                                  stats["layer2_0"]["downsample_bn"]["mean"])
    np.testing.assert_array_equal(model.bn1.running_var.numpy(), stats["bn1"]["var"])
    np.testing.assert_array_equal(model.bn1.weight.detach().numpy(), params["bn1"]["scale"])
    assert not any("num_batches_tracked" in k for k in state)


def test_missing_batch_stats_raise(flax_resnet):
    from passl_tpu_torch.models.resnet import ResNet

    kw, params, _ = flax_resnet
    with pytest.raises(KeyError, match="running_mean"):
        flax_to_torch(params, ResNet(**kw))


def test_unknown_batch_stats_leaf_raises(flax_resnet):
    from passl_tpu_torch.models.resnet import ResNet

    kw, params, stats = flax_resnet
    bad = {**stats, "bn1": {**stats["bn1"], "count": np.zeros(64, np.float32)}}
    with pytest.raises(ValueError, match="expected mean or var"):
        flax_to_torch(params, ResNet(**kw), bad)
