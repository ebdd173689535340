"""MAE of the PyTorch port (passl_tpu_torch/models/mae.py) against the JAX
package.

On the CPU, at tiny sizes (a ViT encoder of 2 blocks over 32 x 32 images in
4 x 4 patches, 64 patches of which 16 stay visible, and a decoder of 2
blocks over all 65 tokens): the sin-cos tables of the port's copy of
`pos_embed.py` bitwise; `patchify`, `unpatchify` and `random_masking` on
JAX's noise bitwise; the loss and every gradient in f32 with the noise
`jax.random.uniform` drew handed to `masking_noise`, on the einsum path and
on the flash path (the encoder's 17 tokens fall back to einsum with the JAX
warning in both packages, the decoder's 65 take the port's flash Function,
the JAX library kernels in interpret mode); the masks' shape and the eval
masks' fixed seed; `MAEVisionTransformer`; and the slice as a whole: each of
the JAX engine's first 4 steps of configs/mae/mae_vit_tiny_synthetic.yaml
taken from JAX's state on its noise. Every MAE config builds on the meta
device; the learning check's extract fills the probe but its `fc_norm`. A
test marked `cuda` trains the tiny MAE on the card and skips elsewhere.
"""
import contextlib
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import mae as port_mae
from passl_tpu_torch.models.utils import pos_embed as port_pos
from passl_tpu_torch.models.vision_transformer import VisionTransformer
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_deit import (_adamw_moments, assert_step_tracks, jax_flash,  # noqa: F401
                             jax_states)
from test_torch_moco import _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "mae", "mae_vit_tiny_synthetic.yaml")
KW = dict(img_size=32, patch_size=4, embed_dim=32, depth=2, num_heads=2, decoder_embed_dim=32,
          decoder_depth=2, decoder_num_heads=2, mask_ratio=0.75, norm_pix_loss=True)


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """The port's tiny CPU steps on one OpenMP thread, put back after
    (test_torch_densecl.py says why threadpoolctl and not set_num_threads)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # a speed setting only
        yield
        return
    with threadpool_limits(1, user_api="openmp"):
        yield


@contextlib.contextmanager
def recorded_noise():
    """jax.random.uniform records each [n, l] draw (also under jit, through a
    debug callback) into the yielded list."""
    import jax

    record = []
    orig = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        u = orig(key, shape, *args, **kwargs)
        if len(tuple(shape)) == 2:
            jax.debug.callback(lambda v: record.append(np.asarray(v)), u)
        return u

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        yield record


@contextlib.contextmanager
def handed_noise(draws):
    """The port's masking draws the given noise, in order."""
    queue = list(draws)

    def masking_noise(n, l, generator, device):
        u = queue.pop(0)
        assert u.shape == (n, l)
        return torch.from_numpy(np.asarray(u, np.float32)).to(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mae, "masking_noise", masking_noise)
        yield queue


# ------------------------------------------------------- tables and masking


@pytest.mark.parametrize("dim, grid", [(32, 8), (64, 4), (768, 14), (512, 14), (1024, 16)])
def test_the_sincos_tables_are_the_jax_ones_bitwise(dim, grid):
    from passl_tpu.models.utils import pos_embed as jax_pos

    for cls in (False, True):
        want = jax_pos.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
        got = port_pos.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_pos.mocov3_2d_sincos_pos_embed(dim, grid, grid),
                                  jax_pos.mocov3_2d_sincos_pos_embed(dim, grid, grid))
    pos = np.arange(grid, dtype=np.float64)
    np.testing.assert_array_equal(port_pos.get_1d_sincos_pos_embed_from_grid(dim, pos),
                                  jax_pos.get_1d_sincos_pos_embed_from_grid(dim, pos))
    m = port_mae.MaskedAutoencoderViT(img_size=16 * grid, patch_size=16, embed_dim=dim, depth=0,
                                      num_heads=1, decoder_embed_dim=dim, decoder_depth=0)
    np.testing.assert_array_equal(m.pos_embed.array,
                                  jax_pos.get_2d_sincos_pos_embed(dim, grid, cls_token=True)[None])


def test_patchify_and_unpatchify_are_the_jax_ones_bitwise():
    from passl_tpu.models import mae as jax_mae

    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax_mae.patchify(x, 4))
    got = port_mae.patchify(torch.from_numpy(x), 4)
    assert got.shape == (3, 64, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_mae.unpatchify(got, 4).numpy(),
                                  np.asarray(jax_mae.unpatchify(want, 4)))
    np.testing.assert_array_equal(port_mae.unpatchify(got, 4).numpy(), x)


@pytest.mark.parametrize("ratio", [0.75, 0.5, 0.9])
def test_random_masking_on_the_jax_noise_is_bitwise(ratio):
    import jax

    from passl_tpu.models import mae as jax_mae

    x = np.random.RandomState(1).randn(4, 49, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = [np.asarray(a) for a in jax_mae.random_masking(x, ratio, key)]
    noise = np.asarray(jax.random.uniform(key, (4, 49)))
    got = [t.numpy() for t in port_mae.random_masking(torch.from_numpy(x), ratio,
                                                      torch.from_numpy(noise))]
    keep = int(49 * (1 - ratio))
    assert got[0].shape == (4, keep, 8) and got[1].sum(1).tolist() == [49 - keep] * 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(sorted(r) == list(range(49)) for r in got[2])


# ------------------------------------------------------------------- model


def _pair(impl, seed=0):
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mae import MaskedAutoencoderViT as JaxMAE

    jm = JaxMAE(**KW, attn_impl=impl)
    x = jnp.zeros((2, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "masking": jax.random.PRNGKey(1)}, x))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    pm = port_mae.MaskedAutoencoderViT(**KW, attn_impl=impl).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_mae_loss_and_gradients_match_jax_on_its_noise(impl, request):
    """Two train-mode steps of 4 images: the loss (f32, 1e-5 relative) and every
    parameter's gradient (1e-5 of the tensor's largest entry), the masks on the
    noise JAX drew. On the flash path both packages' encoders fall back to
    einsum at 17 tokens with the JAX package's warning."""
    import jax
    import jax.numpy as jnp

    if impl == "flash":
        request.getfixturevalue("jax_flash")
    jm, params, pm = _pair(impl, seed=2)
    rng = np.random.RandomState(3)

    @jax.jit
    def step(p, x, key):
        return jax.value_and_grad(lambda p: jm.apply({"params": p}, x, train=True,
                                                     rngs={"masking": key})["loss"])(p)

    with recorded_noise() as noise:
        runs = []
        for t in range(2):
            x = rng.randn(4, 32, 32, 3).astype(np.float32)
            loss, grads = step(params, jnp.asarray(x), jax.random.PRNGKey(10 + t))
            jax.effects_barrier()
            runs.append((x, float(loss), jax.device_get(grads)))
    assert len(noise) == 2 and noise[0].shape == (4, 64)
    for (x, want_loss, grads), u in zip(runs, noise):
        for p in pm.parameters():
            p.grad = None
        with handed_noise([u]) as left:
            if impl == "flash":
                with pytest.warns(UserWarning, match=r"sequence too short \(17\)"):
                    out = pm(torch.from_numpy(x), generator=torch.Generator())
            else:
                out = pm(torch.from_numpy(x), generator=torch.Generator())
        assert not left and set(out) == {"loss"} and out["loss"].dtype == torch.float32
        np.testing.assert_allclose(out["loss"].item(), want_loss, rtol=1e-5)
        out["loss"].backward()
        want_g = dict(_torch_name(p, a) for p, a in _flatten(grads).items())
        assert set(want_g) == {n for n, _ in pm.named_parameters()}
        for name, p in pm.named_parameters():
            wv = want_g[name]
            np.testing.assert_allclose(p.grad.numpy(), wv, rtol=1e-5,
                                       atol=1e-5 * np.abs(wv).max(), err_msg=name)
        assert pm.mask_token.grad.abs().max() > 0


def test_masks_hold_the_ratio_and_eval_masks_are_fixed():
    m = init_module(port_mae.MaskedAutoencoderViT(**KW), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32))
    seen = []
    orig = port_mae.random_masking

    def spy(x_, ratio, noise):
        out = orig(x_, ratio, noise)
        seen.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mae, "random_masking", spy)
        m.train()
        with pytest.raises(ValueError, match="generator"):
            m(x)
        a = m(x, generator=torch.Generator().manual_seed(1))["loss"]
        m.eval()
        with torch.no_grad():
            b, c = m(x)["loss"], m(x, generator=torch.Generator().manual_seed(5))["loss"]
    assert torch.isfinite(a) and torch.equal(b, c)  # eval: the fixed seed, whatever is given
    for x_masked, mask, ids_restore in seen:
        assert x_masked.shape == (3, 16, 32)
        assert mask.sum(1).tolist() == [48.0] * 3
        assert all(sorted(r.tolist()) == list(range(64)) for r in ids_restore)
    assert torch.equal(seen[1][2], seen[2][2])  # both eval calls took one mask


def test_mae_vision_transformer_is_the_global_pool_vit():
    m = port_mae.MAEVisionTransformer(img_size=32, patch_size=4, embed_dim=32, depth=1,
                                      num_heads=2, num_classes=0)
    assert isinstance(m, VisionTransformer) and m.global_pool and hasattr(m, "fc_norm")
    assert m.out_channels == 32
    assert not port_mae.MAEVisionTransformer(img_size=32, patch_size=4, embed_dim=32, depth=1,
                                             num_heads=2, global_pool=False).global_pool


@pytest.mark.parametrize("name", ["mae_vit_base_patch16", "mae_vit_large_patch16",
                                  "mae_vit_huge_patch14"])
def test_every_mae_variant_is_registered(name):
    from passl_tpu.models.base import MODELS as JAX_MODELS

    jm = JAX_MODELS.get(name)()
    with torch.device("meta"):
        model = build_model({"name": name})
    assert (len(model.blocks), len(model.decoder_blocks), model.patch_size) == (
        jm.depth, jm.decoder_depth, jm.patch_size)
    assert model.decoder_embed.out_features == jm.decoder_embed_dim
    assert model.blocks[0].attn.num_heads == jm.num_heads
    assert model.decoder_blocks[0].attn.num_heads == jm.decoder_num_heads


# ----------------------------------------------------- the slice as a whole

PARITY = ["FP16.enable=False", "DataLoader.Train.sampler.batch_size=16"]
STEPS = 4


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 4 loader batches (16 images), its metrics, its
    state before each step and after the last (parameters, AdamW moments) and
    the masking noise each step drew."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))
    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == STEPS:
            break

    def convert(model, state):
        return flax_to_torch(state.params, model), _adamw_moments(state.opt_state)

    with recorded_noise() as noise:  # the one trace records every step's draw
        metrics, states = jax_states(je, batches, port, convert)
        jax.effects_barrier()
    je.train_dataloader.close()
    assert len(noise) == STEPS and noise[0].shape == (16, 64)
    return batches, metrics, states, noise


def test_tiny_mae_steps_along_the_jax_engine(tmp_path, jax_run):
    batches, jax_metrics, states, noise = jax_run
    e = Engine(_config(tmp_path, *PARITY), mode="train", device="cpu")
    assert isinstance(e.model, port_mae.MaskedAutoencoderViT)
    with handed_noise(noise) as left:
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            assert isinstance(b, (tuple, list)) and len(b) == 2  # the image/label tuple
            assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    assert not left and e.state.step == STEPS
    e.close()


def test_mae_finetune_layerwise_decay_counts_the_vit_blocks():
    """mae_vit_base_ft_in1k: layerwise_decay over the 12 blocks, as the JAX
    engine counts the built model's depth."""
    from passl_tpu_torch.engine.engine import model_optimizer

    cfg = cfg_util.get_config(os.path.join(REPO, "configs", "mae", "mae_vit_base_ft_in1k.yaml"),
                              show=False)
    with torch.device("meta"):
        model = build_model(dict(cfg["Model"]))
    opt_cfg = {k: v for k, v in dict(cfg["Optimizer"]).items() if k != "grad_clip"}
    opt = model_optimizer(model, opt_cfg, dict(cfg["Model"]))
    scale = {n: opt.group_of(n).lr_scale for n, _ in model.named_parameters()}
    decay = cfg["Optimizer"]["layerwise_decay"]
    assert scale["blocks.11.mlp.fc2.weight"] == pytest.approx(decay)
    assert scale["blocks.0.attn.qkv.weight"] == pytest.approx(decay ** 12)
    assert scale["patch_embed.proj.weight"] == pytest.approx(decay ** 13)
    assert scale["head.weight"] == pytest.approx(1.0)


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "mae", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", n) for n in ("mae_structured.yaml",
                                                    "probe_mae_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_mae_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_fills_the_structured_probe_but_its_fc_norm(tmp_path):
    """The learning check's extract step: the encoder of
    tests/e2e/mae_structured.yaml's model under `backbone`, with the sin-cos
    table as `pos_embed`, fills every backbone entry of
    tests/e2e/probe_mae_structured.yaml's model but `fc_norm`, which it sets
    to a fresh LayerNorm's values, where the global-pool probe starts; the
    decoder and the pretrain `norm` stay out, and a missing block raises."""
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "mae_structured.yaml")
    probe = os.path.join(REPO, "tests", "e2e", "probe_mae_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    picked = extract_weights.mae_encoder(model.state_dict(), 32)
    assert not any(k.startswith(("backbone.decoder", "backbone.norm.", "backbone.mask"))
                   for k in picked)
    np.testing.assert_array_equal(picked["backbone.pos_embed"].numpy(),
                                  model.pos_embed.array)
    fresh = build_model(dict(cfg_util.get_config(probe)["Model"])).backbone.fc_norm
    for leaf in ("weight", "bias"):
        torch.testing.assert_close(picked[f"backbone.fc_norm.{leaf}"],
                                   getattr(fresh, leaf).detach(), rtol=0, atol=0)
    out = str(tmp_path / "backbone.pt")
    torch.save(picked, out)
    assert extract_weights.unfilled(probe, out, "backbone") == []
    extract_weights.require_filled(probe, out, "backbone")
    del picked["backbone.blocks.0.attn.qkv.weight"]
    torch.save(picked, out)
    assert extract_weights.unfilled(probe, out, "backbone") == [
        "backbone.blocks.0.attn.qkv.weight"]
    with pytest.raises(SystemExit, match=r"unfilled: \['backbone\.blocks\.0\.attn\.qkv"):
        extract_weights.require_filled(probe, out, "backbone")


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_mae_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from passl_tpu_torch.ops.attention import flash_attention

    e = Engine(_config(tmp_path, "Global.max_train_step=2", "Global.print_batch_step=1",
                       "Model.attn_impl=flash"), mode="train", device="cuda")
    flash_attention.launches = 0
    e.train()
    hist = e.train_loop.history
    assert [np.isfinite(h["loss"]) for h in hist] == [True, True]
    # 64 patches: the encoder's 17 tokens take einsum, the decoder's 65 flash
    assert flash_attention.launches == 2 * 2
