"""Swin Transformer of the PyTorch port (passl_tpu_torch/models/swin_transformer.py)
against the JAX model.

The JAX model is the geometry of tests/test_window_attention_kernel.py
(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), heads=(2, 4),
window_size=7): stage 1 has a shifted block and packs g = 2 windows into
L = 98, stage 2's window covers its 7 x 7 map (g = 1, L = 49, no mask). Its
weights are redrawn with numpy and carried over by `flax_to_torch`; images
come from numpy. Compared: logits of the einsum path (f32, and bf16 with
`softmax_dtype: bfloat16`) and of the fused path (the port's autograd
Function on CPU tensors, `attn_interpret=True`, against the JAX model's
Pallas kernel in interpret mode), the fused path's parameter gradients, the
refusals, export -> Predictor on the meta-built model, and 4 train steps of
configs/classification/swin_tiny_synthetic.yaml against the JAX engine from
the same init.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passl_tpu.models.swin_transformer as jax_swin
import passl_tpu_torch.models.swin_transformer as port_swin
from passl_tpu.engine import Engine as JaxEngine
from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.models import build_model
from passl_tpu_torch.tools import export
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "swin_tiny_synthetic.yaml")
TINY = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            window_size=7, num_classes=8, drop_path_rate=0.0)


def _randomize(params, seed):
    """Draw every flax leaf (given its shape) at a scale where each part of the model shows."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "relative_position_bias_table" in name:
            return rng.randn(*shape)  # bias of the order of the scores
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return 0.2 * rng.randn(*shape)  # biases

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(draw(p, x), np.float32), params)


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, 56, 56, 3).astype(np.float32)


def _pair(fused, dtype="float32", softmax="float32", seed=0):
    """(flax model, its params, port model) with the same weights; `fused`
    takes the kernel path on both sides (Pallas interpret mode; the port's
    autograd Function on CPU tensors)."""
    jm = jax_swin.SwinTransformer(**TINY, dtype=jnp.dtype(dtype), softmax_dtype=softmax,
                                  attn_interpret=fused)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)),
                                            train=False))["params"]
    params = _randomize(shapes, seed)
    pm = port_swin.SwinTransformer(**TINY, dtype=dtype, softmax_dtype=softmax,
                                   attn_interpret=fused).eval()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def _jax_logits(jm, params, x):
    fwd = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))
    return np.asarray(fwd(params, jnp.asarray(x)).astype(jnp.float32))


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("path", ["einsum", "fused"])
def test_tiny_logits_f32(path):
    jm, params, pm = _pair(fused=path == "fused")
    x = _images(4)
    want = _jax_logits(jm, params, x)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    assert np.abs(want).max() > 0.5  # the weights make the logits spread
    # f32 throughout; sums in another order than XLA's, over 4 blocks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("path", ["einsum", "fused"])
def test_tiny_logits_bf16(path):
    """The in1k configs' precision: bf16 compute, `softmax_dtype: bfloat16`
    (which the fused path ignores: its softmax is f32 on both sides)."""
    jm, params, pm = _pair(fused=path == "fused", dtype="bfloat16", softmax="bfloat16", seed=1)
    x = _images(4, seed=1)
    want = _jax_logits(jm, params, x)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # bf16 rounds at other places in the two frameworks (XLA rounds each op of
    # the bf16 softmax, torch once at its end; bias adds after the matmul's
    # rounding; GELU's internal precision), each worth about one bf16 ulp
    # (2^-8 relative) and compounding over 4 blocks. Seeds 1-3 differ by
    # 0.55-0.68% of the largest logit on both paths, cosine >= 0.99997: hold
    # the logits to 2% (about five ulps) and their direction to 1e-4
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)
    assert _cos(got, want).min() > 0.9999


def test_tiny_fused_gradients_match_jax():
    """Every parameter's gradient of sum(logits * w), through the port's
    autograd Function (plain backward on CPU tensors) and the JAX model's
    custom VJP with its Pallas backward kernel in interpret mode."""
    jm, params, pm = _pair(fused=True, seed=2)
    x = _images(2, seed=2)
    w = np.random.RandomState(3).randn(2, 8).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=False) * w)

    want = flax_to_torch(jax.device_get(jax.jit(jax.grad(loss))(params)), pm)
    (pm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want) and len(got) == 63
    for name, g in got.items():
        wv = want[name].numpy()
        # f32, sums in another order: 1e-4 of the tensor's largest entry
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-4 * np.abs(wv).max(),
                                   err_msg=name)
    tables = [n for n in got if n.endswith("relative_position_bias_table")]
    assert len(tables) == 4 and all(got[n].abs().max() > 0 for n in tables)


def test_port_einsum_and_fused_paths_agree():
    """On the same weights the two paths differ only by where the scale and
    the rounding fall: q * scale before the product, or the product's f32
    scaled after."""
    _, _, pm = _pair(fused=False, seed=4)
    x = torch.from_numpy(_images(2, seed=4))
    with torch.inference_mode():
        einsum = pm(x)
        for m in pm.modules():
            if isinstance(m, port_swin.WindowAttention):
                m.attn_interpret = True
        fused = pm(x)
    torch.testing.assert_close(fused, einsum, rtol=1e-5, atol=1e-5)


def test_block_geometry_and_constants():
    pm = port_swin.SwinTransformer(**TINY)
    b0, b1 = pm.layers_0_blocks
    c0, c1 = pm.layers_1_blocks
    assert (b0.ws, b0.shift, b0.g, b1.shift, b1.g) == (7, 0, 2, 3, 2)
    # 4 windows of the 14 x 14 map in 2 groups of 2: one [98, 98] mask per group
    assert b0._mask.array.shape == b1._mask.array.shape == (2, 98, 98)
    assert (c0.ws, c0.shift, c0.g, c0._mask, c1.shift) == (7, 0, 1, None, 0)
    # the index and the masks are neither parameters nor buffers
    assert not list(pm.buffers())
    assert not any("index" in k or "mask" in k for k in pm.state_dict())
    # the shifted block's packed masks: the windows' shift masks on the
    # diagonal, -100 off it
    shift = port_swin._shift_attn_mask(14, 14, 7, 3)
    for grp, packed in enumerate(b1._mask.array):
        np.testing.assert_array_equal(packed[:49, :49], shift[2 * grp])
        np.testing.assert_array_equal(packed[49:, 49:], shift[2 * grp + 1])
        assert (packed[:49, 49:] == -100).all() and (packed[49:, :49] == -100).all()
    np.testing.assert_array_equal(port_swin._packed_attn_mask(14, 14, 7, 3, 2),
                                  jax_swin._packed_attn_mask(14, 14, 7, 3, 2))
    np.testing.assert_array_equal(port_swin._relative_position_index(7),
                                  jax_swin._relative_position_index(7))


def test_window_partition_round_trip_matches_jax():
    x = np.random.RandomState(5).randn(2, 14, 21, 3).astype(np.float32)
    got = port_swin.window_partition(torch.from_numpy(x), 7)
    want = np.asarray(jax_swin.window_partition(jnp.asarray(x), 7))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port_swin.window_reverse(got, 7, 14, 21)
    assert torch.equal(back, torch.from_numpy(x))


def test_patch_merging_order_matches_jax():
    x = np.random.RandomState(6).randn(2, 16, 8).astype(np.float32)
    fm = jax_swin.PatchMerging((4, 4), 8)
    params = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm = port_swin.PatchMerging((4, 4), 8)
    pm.load_state_dict(flax_to_torch(params, pm))
    assert pm.reduction.bias is None
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_swin_tiny_names_and_shapes_map_onto_the_port():
    """Full width, without allocating: flax shapes from eval_shape, the port on meta."""
    flax_model = jax_swin.SwinTransformer(**jax_swin._SWIN["swin_tiny_patch4_window7_224"])
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))["params"]
    with torch.device("meta"):
        port = build_model({"name": "swin_tiny_patch4_window7_224"})
    target = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    mapped = {}
    for path, leaf in _flatten(jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)).items():
        key, arr = _torch_name(path, leaf)
        mapped[key] = tuple(arr.shape)
    assert mapped == target
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(int(np.prod(s)) for s in target.values()) == n_flax == 28_288_354


@pytest.mark.parametrize("name", sorted(port_swin._SWIN))
def test_every_variant_is_registered(name):
    with torch.device("meta"):
        model = build_model({"name": name})
    assert isinstance(model, port_swin.SwinTransformer)
    assert model.img_size == jax_swin._SWIN[name].get("img_size", 224)


@pytest.mark.parametrize("kw, error, match", [
    ({"lane_pad": 128}, NotImplementedError, "lane_pad"),
    ({"win_pack": 4}, NotImplementedError, "win_pack"),
    ({"remat": True}, NotImplementedError, "remat"),
    ({"drop_rate": 0.1}, NotImplementedError, "drop_rate"),
    ({"attn_drop_rate": 0.1}, NotImplementedError, "attn_drop_rate"),
    ({"attn_impl": "flash"}, ValueError, "attn_impl"),
])
def test_refuses_what_the_port_does_not_carry(kw, error, match):
    with pytest.raises(error, match=match):
        port_swin.SwinTransformer(**{**TINY, **kw})


def test_resolve_window_impl():
    r = port_swin.resolve_window_impl
    assert r("auto", "cpu") == r("auto", "cuda") == "einsum"  # as the JAX package resolves it
    assert r("einsum", "cuda") == "einsum" and r("fused", "cuda:0") == "fused"
    assert r("fused", "cpu", interpret=True) == r("einsum", "cpu", interpret=True) == "fused"
    with pytest.raises(ValueError, match="CUDA tensors"):
        r("fused", "cpu")
    pm = port_swin.SwinTransformer(**TINY, attn_impl="fused")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pm(torch.zeros(1, 56, 56, 3))


def test_export_predict_on_the_meta_built_model(tmp_path):
    """tools/export builds the model on the meta device and Predictor loads it
    there too: the masks and the index must survive both."""
    e = Engine(_config(tmp_path / "run", *PARITY, "Global.max_train_step=1"), mode="train",
               device="cpu")
    e.train()
    out = tmp_path / "artifact"
    export.main(["-c", TINY_CFG, "-o", f"Global.output_dir={out}", "-o", "Model.depths=[2, 2]",
                 "-o", f"Global.checkpoint={tmp_path / 'run' / 'latest.pt'}"])
    pred = Predictor(str(out), name="SwinTransformer", device="cpu")
    images = np.random.RandomState(7).rand(3, 32, 32, 3).astype(np.float32)
    got = pred.predict(images)
    e.model.eval()
    with torch.inference_mode():
        want = e.model(torch.from_numpy(images)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert len(pred.postprocess(got)[0]["class_ids"]) == 5


# ----------------------------------------------------- the slice as a whole

CLIP = "Optimizer.grad_clip={'name': 'ClipGradByGlobalNorm', 'clip_norm': 1.0}"
PARITY = ["Model.depths=[2, 2]", "Model.drop_path_rate=0.0", CLIP]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's init (as a torch state_dict file), its first 4 loader
    batches, and its metrics and params after 4 train steps on them."""
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


@pytest.mark.parametrize("path", ["einsum", "fused"])
def test_tiny_swin_tracks_the_jax_train_step(tmp_path, jax_run, path):
    """The port's einsum path, and its fused path through the autograd
    Function on CPU tensors, against the JAX engine's (einsum) train step."""
    init_file, batches, jax_metrics, jax_final = jax_run
    extra = ["Model.attn_interpret=True"] if path == "fused" else []
    e = Engine(_config(tmp_path, *PARITY, *extra, f"Global.pretrained_model={init_file}"),
               mode="train", device="cpu")
    # the loader tolerates a partial file: the converted one must fill every entry
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    assert not e.pretrained_report["extra"]
    init = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
    for b, want in zip(batches, jax_metrics):
        got = {k: float(v) for k, v in e.train_step(e.state, to_device(b, e.device)).items()}
        assert set(got) == set(want)
        # one f32 forward and backward, summed in another order than XLA's
        # (and on the fused path with the scale after the product)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["CELoss"], want["CELoss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert e.state.step == 4
    total_lr = sum(m["lr"] for m in jax_metrics)
    for name, p in e.model.state_dict().items():
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # AdamW divides by |g| + eps, so an element whose gradient is near eps
        # moves by an amount that rounding decides: hold every element to a
        # tenth of the summed lr, and each tensor's update to 2e-3 relative
        assert (d_port - d_jax).abs().max().item() <= 0.1 * total_lr, name
        assert (d_port - d_jax).norm() <= 2e-3 * d_jax.norm(), name
    e.close()
