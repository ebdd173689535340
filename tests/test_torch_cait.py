"""CaiT of the PyTorch port (passl_tpu_torch/models/cait.py) against the JAX model.

The tiny CaiT of configs/classification/cait_tiny_synthetic.yaml with the
same weights in both frameworks (flax init, then every leaf redrawn with
numpy so that LayerScale, the head mixes and the attention all matter), the
same NHWC images from numpy, and logits compared at a stated tolerance. Also
pins the places where PyTorch's defaults differ from flax's: the tanh GELU,
dtype promotion through the f32 LayerScale gammas, LayerNorm statistics in
f32, the score dtype, and the NHWC patch embedding.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import passl_tpu.models.cait as jax_cait
from passl_tpu.nn import layers as jax_layers
from passl_tpu.ops.pallas.talking_heads import talking_heads_softmax as jax_th_softmax
import passl_tpu_torch.models.cait as port_cait
from passl_tpu_torch.models import MODELS
from passl_tpu_torch.nn import init as tinit
from passl_tpu_torch.nn import layers as port_layers
from passl_tpu_torch.utils.convert import flax_to_torch

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
            depth_token_only=1, num_classes=10)


def _randomize(params, seed):
    """Draw every flax leaf (given its shape) at a scale where each part of the model shows."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "proj_l" in name or "proj_w" in name:
            return np.eye(shape[0]) + 0.3 * rng.randn(*shape)
        if "gamma" in name:
            return rng.uniform(0.5, 1.5, shape)
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return 0.5 * rng.randn(*shape)  # biases, pos_embed, cls_token

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(draw(p, x), np.float32), params)


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _pair(dtype_jax=jnp.float32, dtype_torch=torch.float32, softmax="float32", seed=0):
    """(flax model, its params, port model) with the same weights."""
    jm = jax_cait.CaiT(**TINY, th_impl="einsum", dtype=dtype_jax, softmax_dtype=softmax)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = _randomize(shapes, seed)
    pm = port_cait.CaiT(**TINY, dtype=dtype_torch, softmax_dtype=softmax).eval()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def _jax_logits(jm, params, x, fused, monkeypatch):
    if fused:  # the JAX model's Pallas path, in interpret mode on the CPU
        monkeypatch.setattr(jax_cait, "resolve_th_impl", lambda impl: "fused")
        monkeypatch.setattr(jax_cait, "talking_heads_softmax",
                            functools.partial(jax_th_softmax, interpret=True))
    fwd = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))
    return np.asarray(fwd(params, jnp.asarray(x)).astype(jnp.float32))


@pytest.mark.parametrize("jax_path", ["einsum", "fused"])
def test_tiny_logits_f32(jax_path, monkeypatch):
    jm, params, pm = _pair()
    x = _images(4)
    want = _jax_logits(jm, params, x, jax_path == "fused", monkeypatch)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert np.abs(want).max() > 0.5  # the weights make the logits spread
    # f32 throughout; sums in another order than XLA's, over 3 blocks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_tiny_logits_bf16(monkeypatch):
    """The in1k config's precision: bf16 compute, bf16 scores, f32 gammas."""
    jm, params, pm = _pair(jnp.bfloat16, torch.bfloat16, softmax="bfloat16", seed=1)
    x = _images(4, seed=1)
    want = _jax_logits(jm, params, x, fused=True, monkeypatch=monkeypatch)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # bf16 rounds at other places in the two frameworks (bias add after the
    # matmul's rounding in XLA, GELU's internal precision), each worth up to
    # one bf16 ulp (2^-8 relative) and compounding over 3 blocks. Seeds 1-3
    # differ by 0.41-0.54% of the largest logit, cosine >= 0.99998: hold the
    # logits to 2% (about five ulps) and their direction to 1e-4
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999


def test_port_einsum_and_auto_agree_on_cpu():
    pm = port_cait.CaiT(**TINY).eval()
    tinit.init_module(pm, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(2))
    with torch.inference_mode():
        auto = pm(x)
        for blk in pm.blocks:
            blk.attn.th_impl = "einsum"
        einsum = pm(x)
    assert torch.equal(auto, einsum)  # auto on CPU tensors is the plain version


def test_gelu_is_flax_tanh_approximation():
    fm = jax_layers.Mlp(hidden_features=32)
    x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32) * 2
    params = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm = port_layers.Mlp(16, 32)
    pm.load_state_dict(flax_to_torch(params, pm))
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # torch's default (exact) GELU would not pass the same bound
    exact = pm.fc2(F.gelu(pm.fc1(torch.from_numpy(x)))).detach().numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_residual_stream_promotes_to_f32_in_bf16():
    blk = port_cait.CaiTSABlock(64, 4, dtype=torch.bfloat16, softmax_dtype=torch.bfloat16)
    tinit.init_module(blk, torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.inference_mode():
        y = blk(x)
    assert y.dtype == torch.float32  # bf16 branch * f32 gamma -> f32, as in JAX
    model = port_cait.CaiT(**TINY, dtype="bfloat16")
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_layernorm_bf16_matches_flax():
    x = (np.random.RandomState(0).randn(4, 7, 64) * 3 + 1).astype(np.float32)
    fl = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16)
    params = fl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = fl.apply(params, jnp.asarray(x))
    got = port_layers.LayerNorm(64, eps=1e-6, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # stats in f32 on both sides, one rounding to bf16 at the end: one ulp
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("softmax", [torch.bfloat16, torch.float32])
def test_scores_reach_talking_heads_at_softmax_dtype(softmax, monkeypatch):
    seen = []
    ref = port_cait.talking_heads_softmax_ref

    def spy(s, proj_l, proj_w):
        seen.append(s.dtype)
        return ref(s, proj_l, proj_w)

    monkeypatch.setattr(port_cait, "talking_heads_softmax_ref", spy)
    attn = port_cait.TalkingHeadAttention(64, 4, dtype=torch.bfloat16, softmax_dtype=softmax)
    tinit.init_module(attn, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = attn(torch.randn(2, 16, 64).bfloat16())
    assert seen == [softmax] and out.dtype == torch.bfloat16


def test_patch_embed_nhwc_matches_flax():
    x = np.random.RandomState(0).randn(2, 32, 24, 3).astype(np.float32)
    fm = jax_layers.PatchEmbed(patch_size=8, embed_dim=16)
    params = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm = port_layers.PatchEmbed(8, 16)
    pm.load_state_dict(flax_to_torch(params, pm))
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 12, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_module_is_seeded_and_fills_everything():
    def fresh(seed):
        m = port_cait.CaiT(**TINY)
        return tinit.init_module(m, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = fresh(0), fresh(0), fresh(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
    assert all(torch.isfinite(v).all() for v in a.values())
    assert torch.all(a["blocks.1.gamma_2"] == 1e-5) and torch.all(a["norm.weight"] == 1)
    assert torch.all(a["blocks.0.mlp.fc1.bias"] == 0)


def test_initializer_statistics():
    g = torch.Generator().manual_seed(0)
    t = tinit.trunc_normal_(torch.empty(256, 512), std=0.02, generator=g)
    assert abs(t.std().item() - 0.02) < 0.001
    fan_in = 512
    t = tinit.lecun_normal_(torch.empty(256, fan_in), generator=g)  # Linear [out, in]
    assert abs(t.std().item() - fan_in**-0.5) < 0.05 * fan_in**-0.5
    assert t.abs().max().item() <= 2 * fan_in**-0.5 / 0.87962566103423978 + 1e-6
    t = tinit.xavier_uniform_(torch.empty(256, 512), generator=g)
    assert t.abs().max().item() <= (6 / (256 + 512)) ** 0.5


def test_every_variant_is_registered_with_the_jax_config():
    for name, cfg in jax_cait._CAIT.items():
        assert name in MODELS
        with torch.device("meta"):
            m = MODELS.get(name)()
        assert m.img_size == cfg.get("img_size", 224)
        assert len(m.blocks) == cfg["depth"]
        assert m.blocks[0].attn.num_heads == cfg["num_heads"]
        assert m.cls_token.shape[-1] == cfg["embed_dim"]
        assert m.blocks[0].init_values == cfg["init_values"]


@pytest.mark.parametrize("fp16", [None, {"enable": False}, {"level": "O0"},
                                  {"enable": True, "level": "O2", "dtype": "bfloat16"},
                                  {"level": "O1", "dtype": "float16"}])
def test_policy_from_config_matches_jax(fp16):
    from passl_tpu.core.amp import Policy as JaxPolicy
    from passl_tpu_torch.core.amp import Policy, dtype_name

    want = jnp.dtype(JaxPolicy.from_config(fp16).compute_dtype).name
    assert dtype_name(Policy.from_config(fp16).compute_dtype) == want


def test_dense_without_bias_matches_flax():
    """`Dense(use_bias=False)`, as Swin's PatchMerging.reduction: no bias
    parameter, flax's output; the default keeps its zero-initialised bias."""
    x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32)
    fm = fnn.Dense(8, use_bias=False, dtype=jnp.bfloat16)
    params = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm = port_layers.Dense(16, 8, dtype=torch.bfloat16, use_bias=False)
    assert pm.bias is None and set(pm.state_dict()) == {"weight"}
    tinit.init_module(pm, torch.Generator().manual_seed(0))  # reset_parameters takes no bias
    pm.load_state_dict(flax_to_torch(params, pm))
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # one bf16 product of the same bf16-rounded operands, summed in f32 on both sides
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=2**-7, atol=1e-2)
    dense = tinit.init_module(port_layers.Dense(16, 8), torch.Generator().manual_seed(0))
    assert dense.bias is not None and torch.all(dense.bias == 0)


def test_conv_kernel_init_is_pluggable_and_defaults_to_xavier():
    """`Conv2d(kernel_init=...)`, as Swin's patch conv (trunc_normal 0.02);
    CaiT's PatchEmbed keeps xavier-uniform."""
    def weight(**kw):
        conv = port_layers.Conv2d(3, 96, 4, 4, **kw)
        return tinit.init_module(conv, torch.Generator().manual_seed(0)).weight.detach()

    trunc = functools.partial(tinit.trunc_normal_, std=0.02)
    w = weight(kernel_init=trunc)
    assert abs(w.std().item() - 0.02) < 0.002 and torch.equal(w, weight(kernel_init=trunc))
    xavier = weight()
    bound = (6.0 / (3 * 16 + 96 * 16)) ** 0.5  # fans of an OIHW kernel [96, 3, 4, 4]
    assert xavier.abs().max().item() <= bound and xavier.abs().max().item() > 0.9 * bound
    assert port_layers.PatchEmbed(16, 64).proj.kernel_init is tinit.xavier_uniform_
