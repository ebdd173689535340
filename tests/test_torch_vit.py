"""Vision Transformer of the PyTorch port (passl_tpu_torch/models/vision_transformer.py)
against the JAX model.

The tiny model has 2 blocks over a 32 x 32 image in 4 x 4 patches: 65 tokens,
the shortest sequence the flash resolver takes. Its weights are redrawn with
numpy and carried over by `flax_to_torch`; images come from numpy. Compared:
logits of the einsum path (f32, and bf16 with `softmax_dtype: bfloat16`) and
of the flash path (the port's autograd Function on CPU tensors, which runs
the kernels' plain versions, against the JAX model's library kernels in
interpret mode, with the JAX package's TPU check answered yes inside the
test only), the flash path's parameter gradients, the head options, the
refusals (remat is ported: tests/test_torch_vit_remat.py), export -> Predictor on the meta-built model, and 4 train steps of
configs/classification/vit_tiny_synthetic.yaml (patch 4, f32) on both of
the port's paths against the JAX engine's einsum path from the same init.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passl_tpu.models.vision_transformer as jax_vit
import passl_tpu.ops.attention as jax_attention
import passl_tpu_torch.models.vision_transformer as port_vit
from passl_tpu.engine import Engine as JaxEngine
from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.models import build_model
from passl_tpu_torch.ops.attention import flash_attention
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "vit_tiny_synthetic.yaml")
TINY = dict(img_size=32, patch_size=4, embed_dim=64, depth=2, num_heads=2, num_classes=8)


@pytest.fixture()
def jax_flash(monkeypatch):
    """The JAX model's flash path on this CPU: its TPU check answered yes and
    the library kernels in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jax_attention, "_tpu_backend", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def _randomize(params, seed):
    """Draw every flax leaf (given its shape) at a scale where each part of the model shows."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "scale" in name or "gamma" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if "pos_embed" in name or "cls_token" in name:
            return 0.5 * rng.randn(*shape)
        return 0.2 * rng.randn(*shape)  # biases

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(draw(p, x), np.float32), params)


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _pair(impl, dtype="float32", softmax="float32", seed=0, **kw):
    """(flax model, its params, port model) with the same weights."""
    cfg = {**TINY, **kw}
    jm = jax_vit.VisionTransformer(**cfg, dtype=jnp.dtype(dtype), softmax_dtype=softmax,
                                   attn_impl=impl)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = _randomize(shapes, seed)
    pm = port_vit.VisionTransformer(**cfg, dtype=dtype, softmax_dtype=softmax,
                                    attn_impl=impl).eval()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def _jax_logits(jm, params, x, **kw):
    fwd = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False, **kw))
    return np.asarray(fwd(params, jnp.asarray(x)).astype(jnp.float32))


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_tiny_einsum_logits_f32():
    jm, params, pm = _pair("einsum")
    x = _images(4)
    want = _jax_logits(jm, params, x)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    assert np.abs(want).max() > 0.5  # the weights make the logits spread
    # f32 throughout; sums in another order than XLA's, over 2 blocks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_tiny_flash_logits_f32(jax_flash):
    jm, params, pm = _pair("flash", seed=1)
    x = _images(4, seed=1)
    want = _jax_logits(jm, params, x)
    launches = flash_attention.launches
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert flash_attention.launches == launches  # CPU tensors: the plain versions
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_tiny_logits_bf16(impl, request):
    """The in1k config's precision: bf16 compute, `softmax_dtype: bfloat16`
    (which the flash path ignores: its softmax is f32 on both sides)."""
    if impl == "flash":
        request.getfixturevalue("jax_flash")
    jm, params, pm = _pair(impl, dtype="bfloat16", softmax="bfloat16", seed=2)
    x = _images(4, seed=2)
    want = _jax_logits(jm, params, x)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # bf16 rounds at other places in the two frameworks (XLA rounds each op of
    # the bf16 softmax, torch once at its end; bias adds after the matmul's
    # rounding; GELU's internal precision), each worth about one bf16 ulp
    # (2^-8 relative), over 2 blocks: the logits to 2% of the largest (about
    # five ulps) and their direction to 1e-4, as for Swin
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)
    assert _cos(got, want).min() > 0.9999


def test_tiny_flash_gradients_match_jax(jax_flash):
    """Every parameter's gradient of sum(logits * w), through the port's
    autograd Function (plain backward on CPU tensors) and the JAX model's
    library kernels' VJP in interpret mode; LayerScale on, so the gammas
    are compared too."""
    jm, params, pm = _pair("flash", seed=3, init_values=0.5)
    x = _images(2, seed=3)
    w = np.random.RandomState(4).randn(2, 8).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=False) * w)

    want = flax_to_torch(jax.device_get(jax.jit(jax.grad(loss))(params)), pm)
    (pm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want) and len(got) == 4 + 2 * 14 + 4
    for name, g in got.items():
        wv = want[name].numpy()
        # f32, sums in another order: 1e-4 of the tensor's largest entry
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-4 * np.abs(wv).max(),
                                   err_msg=name)
    qkv = [n for n in got if n.endswith("attn.qkv.weight")]
    assert len(qkv) == 2 and all(got[n].abs().max() > 0 for n in qkv)


def test_port_einsum_and_flash_paths_agree():
    """On the same weights the two paths differ only by where the scale and
    the rounding fall: q * scale before the product, or the f32 product scaled
    after, and the softmax's normalisation after p v."""
    _, _, pm = _pair("einsum", seed=5)
    x = torch.from_numpy(_images(2, seed=5))
    with torch.inference_mode():
        einsum = pm(x)
        for blk in pm.blocks:
            blk.attn.attn_impl = "flash"
        flash = pm(x)
    torch.testing.assert_close(flash, einsum, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(global_pool=True), dict(head_init="zeros"),
                                dict(head_init="small"), dict(num_classes=0),
                                dict(qkv_bias=False, init_values=0.1)])
def test_head_options_match_jax(kw):
    jm, params, pm = _pair("einsum", seed=6, **kw)
    x = _images(2, seed=6)
    want = _jax_logits(jm, params, x)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    feats = _jax_logits(jm, params, x, return_features=True)
    with torch.inference_mode():
        got_feats = pm(torch.from_numpy(x), return_features=True)
    assert got_feats.shape == (2, 64)
    np.testing.assert_allclose(got_feats.numpy(), feats, rtol=1e-4, atol=1e-4)


def test_stop_grad_patch_embed_matches_jax():
    jm, params, pm = _pair("einsum", seed=7, stop_grad_patch_embed=True)
    x = _images(2, seed=7)
    grads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=False)))(params)
    assert not np.asarray(grads["patch_embed"]["proj"]["kernel"]).any()
    pm(torch.from_numpy(x)).sum().backward()
    assert pm.patch_embed.proj.weight.grad is None
    assert pm.pos_embed.grad.abs().max() > 0


def test_head_inits_draw_as_asked():
    gen = torch.Generator().manual_seed(0)
    for head_init, std in (("trunc_normal", 0.02), ("small", 0.01), ("zeros", 0.0)):
        m = port_vit.VisionTransformer(**{**TINY, "num_classes": 500}, head_init=head_init)
        port_vit.HEAD_INITS[head_init](m.head.weight, generator=gen)
        assert abs(m.head.weight.std().item() - std) < 0.1 * std + 1e-7, head_init


def test_vit_base_names_and_shapes_map_onto_the_port():
    """Full width, without allocating: flax shapes from eval_shape, the port on meta."""
    flax_model = jax_vit.VisionTransformer(**jax_vit._VARIANTS["ViT_base_patch16_224"])
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))["params"]
    with torch.device("meta"):
        port = build_model({"name": "ViT_base_patch16_224"})
    target = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    mapped = {}
    for path, leaf in _flatten(jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)).items():
        key, arr = _torch_name(path, leaf)
        mapped[key] = tuple(arr.shape)
    assert mapped == target
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(int(np.prod(s)) for s in target.values()) == n_flax == 86_567_656


def test_convert_refuses_leftover_and_missing_leaves():
    _, params, pm = _pair("einsum", seed=8)
    extra = {**params, "blocks_2": params["blocks_1"]}
    with pytest.raises(KeyError, match="blocks_2"):
        flax_to_torch(extra, pm)
    missing = {k: v for k, v in params.items() if k != "cls_token"}
    with pytest.raises(KeyError, match="cls_token"):
        flax_to_torch(missing, pm)


VARIANTS = sorted(port_vit._VARIANTS)


@pytest.mark.parametrize("name", VARIANTS)
def test_every_variant_is_registered(name):
    from passl_tpu.models.base import MODELS as JAX_MODELS

    jm = JAX_MODELS.get(name)()  # the flax module: a dataclass of the variant's fields
    with torch.device("meta"):
        model = build_model({"name": name})
    assert isinstance(model, port_vit.VisionTransformer)
    assert (model.img_size, model.embed_dim, len(model.blocks)) == (jm.img_size, jm.embed_dim,
                                                                     jm.depth)
    blk = model.blocks[0]
    assert blk.attn.num_heads == jm.num_heads
    assert blk.mlp.fc1.out_features == int(jm.embed_dim * jm.mlp_ratio)
    assert model.patch_embed.proj.kernel_size == (jm.patch_size, jm.patch_size)


def test_every_jax_variant_is_ported():
    assert set(VARIANTS) == set(jax_vit._VARIANTS) | {"ViT_hybrid_base_patch16_224",
                                                      "ViT_hybrid_large_patch16_224"}


@pytest.mark.parametrize("kw, error, match", [
    ({"drop_rate": 0.1}, NotImplementedError, "drop_rate"),
    ({"attn_drop_rate": 0.1}, NotImplementedError, "attn_drop_rate"),
    ({"pipeline": True}, NotImplementedError, "pipeline"),
    ({"head_init": "uniform"}, ValueError, "head_init"),
    ({"attn_impl": "pallas"}, ValueError, "attn_impl"),
])
def test_refuses_what_the_port_does_not_carry(kw, error, match):
    with pytest.raises(error, match=match):
        port_vit.VisionTransformer(**{**TINY, **kw})


def test_flash_below_65_tokens_falls_back_with_the_warning():
    pm = port_vit.VisionTransformer(**{**TINY, "patch_size": 8}, attn_impl="flash").eval()
    with pytest.warns(UserWarning, match="sequence too short"), torch.inference_mode():
        pm(torch.zeros(1, 32, 32, 3))


def test_export_predict_on_the_meta_built_model(tmp_path):
    """tools/export builds the model on the meta device and Predictor loads
    it there too, on the flash path."""
    out = tmp_path / "artifact"
    export.main(["-c", TINY_CFG, "-o", f"Global.output_dir={out}", *sum(
        (["-o", o] for o in (*PARITY, "Model.attn_impl=flash")), [])])
    pred = Predictor(str(out), name="VisionTransformer", device="cpu")
    images = np.random.RandomState(9).rand(3, 32, 32, 3).astype(np.float32)
    got = pred.predict(images)
    assert got.shape == (3, 10) and np.isfinite(got).all()
    assert pred.model.blocks[0].attn.attn_impl == "flash"
    einsum = build_model(dict(_config(tmp_path, *PARITY)["Model"])).eval()
    einsum.load_state_dict(pred.model.state_dict())
    with torch.inference_mode():
        want = einsum(torch.from_numpy(images)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # flash vs einsum, f32
    assert len(pred.postprocess(got)[0]["class_ids"]) == 5


# ----------------------------------------------------- the slice as a whole

CLIP = "Optimizer.grad_clip={'name': 'ClipGradByGlobalNorm', 'clip_norm': 1.0}"
# patch 4: 65 tokens, the flash resolver's shortest; f32; no stochastic depth
# (the two frameworks draw other masks)
PARITY = ["Model.patch_size=4", "FP16.enable=False", "Model.drop_path_rate=0.0", CLIP]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's init (as a torch state_dict file), its first 4 loader
    batches, and its metrics and params after 4 train steps on them (its
    einsum path: the JAX package's flash path off a TPU is einsum)."""
    tmp = tmp_path_factory.mktemp("jax")
    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    params0 = jax.device_get(je.state.params)
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))  # for the names and shapes
    init_file = os.path.join(str(tmp), "init.pt")
    torch.save(flax_to_torch(params0, port), init_file)
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
    final = flax_to_torch(jax.device_get(je.state.params), port)
    je.train_dataloader.close()
    return init_file, batches, metrics, final


@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_tiny_vit_tracks_the_jax_train_step(tmp_path, jax_run, path):
    """The port's einsum path, and its flash path through the autograd
    Function on CPU tensors, against the JAX engine's (einsum) train step."""
    init_file, batches, jax_metrics, jax_final = jax_run
    e = Engine(_config(tmp_path, *PARITY, f"Model.attn_impl={path}",
                       f"Global.pretrained_model={init_file}"), mode="train", device="cpu")
    # the loader tolerates a partial file: the converted one must fill every entry
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    assert not e.pretrained_report["extra"]
    init = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
    for b, want in zip(batches, jax_metrics):
        got = {k: float(v) for k, v in e.train_step(e.state, to_device(b, e.device)).items()}
        assert set(got) == set(want)
        # one f32 forward and backward, summed in another order than XLA's
        # (and on the flash path with the scale after the product)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["CELoss"], want["CELoss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert e.state.step == 4
    total_lr = sum(m["lr"] for m in jax_metrics)
    dim = e.model.embed_dim
    for name, p in e.model.state_dict().items():
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # AdamW divides by |g| + eps, so an element whose gradient is near eps
        # moves by an amount that rounding decides: hold every element to a
        # tenth of the summed lr, and each tensor's update to 2e-3 relative
        assert (d_port - d_jax).abs().max().item() <= 0.1 * total_lr, name
        if name.endswith("attn.qkv.bias"):
            # the key bias adds one constant to every score of a row, which the
            # softmax cancels: its gradient is rounding noise on both sides,
            # so only the query and value thirds are held to the tensor rule
            keep = torch.ones(3 * dim, dtype=torch.bool)
            keep[dim:2 * dim] = False
            d_port, d_jax = d_port[keep], d_jax[keep]
        assert (d_port - d_jax).norm() <= 2e-3 * d_jax.norm(), name
    e.close()
