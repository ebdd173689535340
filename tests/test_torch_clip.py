"""CLIP of the PyTorch port (passl_tpu_torch/models/clip.py) against the JAX
package.

On the CPU, at the JAX tests' tiny sizes (tests/test_clip.py: a ViT tower of
2 blocks, 64 wide, over 32 x 32 images in 8 x 8 patches, a text tower of 2
causal blocks, 32 wide, over 16 tokens; the ModifiedResNet tower with one
bottleneck a stage, 16 wide): from the JAX weights carried across by
`flax_to_torch`, the train-mode loss, acc1 and logit scale (f32, 1e-5
relative), every parameter's gradient (max abs error at most 1e-4 of the
JAX gradient's norm, plus 1e-7 for gradients of rounding alone), the
ModifiedResNet tower's BatchNorm statistics, the eval logits, both encoders;
`logit_scale`'s gradient below, at and above its clamp at ln 100; the EOT
feature at the first largest token id; and the slice as a whole: each of the
JAX engine's first 3 steps of configs/clip/clip_tiny_synthetic.yaml taken
from JAX's state. The optimizer groups of clip_vit_b32_in1k against the JAX
package's `build_optimizer`, the three variants, every CLIP config built on the meta device.
A test marked `cuda` trains the tiny CLIP on the card and skips elsewhere.
"""
import glob
import math
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import build_dataloader, to_device
from passl_tpu_torch.engine.engine import Engine, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import clip as port_clip
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_path, flax_to_torch
from test_torch_deit import _adamw_moments, assert_step_tracks, jax_states
from test_torch_moco import _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "clip", "clip_tiny_synthetic.yaml")
VIT = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
           vision_patch_size=8, context_length=16, vocab_size=256, transformer_width=32,
           transformer_heads=4, transformer_layers=2)
RN = dict(embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1), vision_width=16,
          context_length=8, vocab_size=128, transformer_width=32, transformer_heads=4,
          transformer_layers=1)


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


def _batch(kw, n, seed):
    rs = np.random.RandomState(seed)
    res, ctx, vocab = kw["image_resolution"], kw["context_length"], kw["vocab_size"]
    return {"image": rs.randn(n, res, res, 3).astype(np.float32),
            "text": rs.randint(1, vocab - 1, (n, ctx)).astype(np.int32)}


def _pair(kw, seed):
    """The JAX CLIP, its variables drawn with numpy from their shapes (the
    logit scale at ln(1 / 0.07) + a draw), and the port's CLIP on them."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.clip import CLIP as JaxCLIP

    jm = JaxCLIP(**kw)
    b = _batch(kw, 2, 0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in b.items()}, train=True))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                           seed)
    variables["params"]["logit_scale"] = np.full((1,), math.log(1 / 0.07) + 0.3, np.float32)
    pm = port_clip.CLIP(**kw).train()
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))
    return jm, variables, pm


def _assert_grads(pm, grads, floor=1e-7):
    names = dict(pm.named_parameters())
    want = dict(_torch_name(p, a, names=names) for p, a in _flatten(grads).items())
    assert set(want) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        w = want[name]
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * np.linalg.norm(w) + floor, (name, err, np.linalg.norm(w))


def _jax_step(jm, variables, batch, mutable=False):
    import jax
    import jax.numpy as jnp

    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        out = jm.apply({"params": p, **rest}, jb, train=True,
                       mutable=["batch_stats"] if mutable else False)
        out, new = out if mutable else (out, {})
        return out["loss"], (out, new)

    (_, (out, new)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return jax.device_get(out), jax.device_get(grads), jax.device_get(new)


@pytest.mark.parametrize("kw", [VIT, RN], ids=["vit", "modified-resnet"])
def test_loss_gradients_and_statistics_match_jax(kw):
    """Two train-mode forwards and backwards of 6 pairs: loss, acc1 and logit
    scale, every gradient, and (the ModifiedResNet tower) every BatchNorm
    statistic after each; then the eval logits and both encoders."""
    import jax.numpy as jnp

    jm, variables, pm = _pair(kw, 1)
    resnet = isinstance(kw["vision_layers"], tuple)
    for t in range(2):
        b = _batch(kw, 6, 10 + t)
        want, grads, new = _jax_step(jm, variables, b, mutable=resnet)
        for p in pm.parameters():
            p.grad = None
        out = pm({k: torch.from_numpy(v) for k, v in b.items()})
        assert set(out) == {"loss", "acc1", "logit_scale"}
        for k in out:
            assert out[k].dtype == torch.float32
            np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        out["loss"].backward()
        _assert_grads(pm, grads)
        if resnet:  # the statistics moved as flax's did; the next step starts from them
            stats = flax_to_torch(variables["params"], pm, new["batch_stats"])
            for name, v in pm.state_dict().items():
                if "running" in name:
                    np.testing.assert_allclose(v.numpy(), stats[name].numpy(), rtol=1e-5,
                                               atol=1e-6, err_msg=name)
            variables = {**variables, "batch_stats": new["batch_stats"]}
    pm.eval()
    b = _batch(kw, 5, 20)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    v = {k: variables[k] for k in variables}
    with torch.no_grad():
        got = pm({k: torch.from_numpy(x) for k, x in b.items()})
        img = pm.encode_image(torch.from_numpy(b["image"]))
        txt = pm.encode_text(torch.from_numpy(b["text"]))
    assert got.shape == (5, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, jb, train=False)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(jm.apply(
        v, jb["image"], method=jm.encode_image)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jm.apply(
        v, jb["text"], method=jm.encode_text)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [-0.5, 0.0, 0.5], ids=["below", "at", "above"])
def test_logit_scale_gradient_at_the_clamp_is_jaxs(offset):
    """exp(min(logit_scale, ln 100)): below the clamp the gradient flows, above
    it none does, and at an exact tie JAX's `jnp.clip` passes half of it
    (`torch.clamp` would pass all of it)."""
    import jax
    import jax.numpy as jnp

    jm, variables, pm = _pair(VIT, 2)
    value = np.float32(math.log(100.0)) + np.float32(offset)
    variables["params"]["logit_scale"] = np.full((1,), value, np.float32)
    pm.logit_scale.data.fill_(float(value))
    b = _batch(VIT, 4, 3)
    want, grads, _ = _jax_step(jm, variables, b)
    out = pm({k: torch.from_numpy(x) for k, x in b.items()})
    out["loss"].backward()
    g, gw = pm.logit_scale.grad.item(), float(grads["logit_scale"][0])
    np.testing.assert_allclose(out["logit_scale"].item(), float(want["logit_scale"]), rtol=1e-6)
    np.testing.assert_allclose(g, gw, rtol=1e-4, atol=1e-7)
    if offset > 0:
        assert g == 0.0
    else:
        assert abs(g) > 1e-3
    if offset == 0.0:  # half of the gradient below the clamp's
        x = torch.tensor([float(value)], requires_grad=True)
        torch.exp(x).sum().backward()
        jg = jax.grad(lambda s: jnp.exp(jnp.clip(s, max=math.log(100.0)))[0])(
            jnp.asarray([value]))
        np.testing.assert_allclose(float(jg[0]), 0.5 * x.grad.item(), rtol=1e-6)


def test_the_eot_feature_is_at_the_first_largest_token():
    """Two equal largest ids in a row: both packages take the first."""
    import jax.numpy as jnp

    jm, variables, pm = _pair(VIT, 3)
    text = np.array([[5, 200, 7, 200, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                     [254, 3, 254, 9, 9, 254, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1]], np.int32)
    with torch.no_grad():
        got = pm.encode_text(torch.from_numpy(text)).numpy()
    want = np.asarray(jm.apply({"params": variables["params"]}, jnp.asarray(text),
                               method=jm.encode_text))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # moving the later copy of the largest id changes nothing, the first does
    for col in (3, 1):
        moved = text.copy()
        moved[0, col] = 6
        with torch.no_grad():
            out = pm.encode_text(torch.from_numpy(moved)).numpy()
        assert np.allclose(out[0], got[0], atol=1e-6) == (col == 3)


def test_the_text_tower_is_causal():
    """Tokens after each sequence's EOT do not reach its feature; one before does."""
    torch.manual_seed(0)
    pm = port_clip.CLIP(**VIT).eval()
    from passl_tpu_torch.nn.init import init_module

    init_module(pm, torch.Generator().manual_seed(4))
    text = torch.zeros(2, 16, dtype=torch.int32)
    text[0, :5] = torch.tensor([254, 3, 4, 5, 255])
    text[1, :3] = torch.tensor([254, 9, 255])
    with torch.no_grad():
        base = pm.encode_text(text)
        after = text.clone()
        after[0, 5:] = 17
        after[1, 3:] = 42
        before = text.clone()
        before[:, 1] = 77
        torch.testing.assert_close(pm.encode_text(after), base, rtol=1e-6, atol=1e-6)
        assert (pm.encode_text(before) - base).abs().amax(dim=1).min() > 1e-3


def test_the_tokens_reach_the_model_as_integers(tmp_path):
    """The loader's dict batch keeps the tokens int32 through prepare_batch
    and to_device; the images come as f32."""
    config = cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}"])
    loader = build_dataloader(config["DataLoader"]["Train"], "Train", seed=0)
    loader.set_epoch(1)
    b = next(iter(loader))
    loader.close()
    e = Engine(config, mode="train", device="cpu")
    got = to_device(e.prepare_batch(b), torch.device("cpu"))
    e.close()
    assert set(got) == {"image", "text"}
    assert got["text"].dtype == torch.int32 and got["image"].dtype == torch.float32
    assert got["text"].shape == (64, 16) and got["image"].shape == (64, 32, 32, 3)


@pytest.mark.parametrize("name", sorted(port_clip._CLIP_VARIANTS))
def test_every_clip_variant_is_registered_with_the_callers_keywords_winning(name):
    from passl_tpu.models.base import MODELS as JAX_MODELS

    jm = JAX_MODELS.get(name)(vocab_size=1000)
    with torch.device("meta"):
        pm = build_model({"name": name, "vocab_size": 1000})
    assert pm.token_embedding.embedding.shape == (1000, jm.transformer_width)
    assert pm.text_projection.shape == (jm.transformer_width, jm.embed_dim)
    if isinstance(jm.vision_layers, tuple):
        assert isinstance(pm.visual, port_clip.ModifiedResNet)
        assert pm.visual.attnpool.num_heads == jm.vision_width * 32 // 64
        assert pm.visual.attnpool.positional_embedding.shape == (50, 2048)
    else:
        assert len(pm.visual.resblocks) == jm.vision_layers
        assert pm.visual.conv1.weight.shape[-1] == jm.vision_patch_size


# ----------------------------------------------------- the slice as a whole

PARITY = ["FP16.enable=False", "DataLoader.Train.sampler.batch_size=16"]
STEPS = 3


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 3 loader batches of 16 pairs, metrics and states."""
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
        return (flax_to_torch(state.params, model),
                _adamw_moments(state.opt_state, model.state_dict()))

    metrics, states = jax_states(je, batches, port, convert)
    je.train_dataloader.close()
    return batches, metrics, states


def test_tiny_clip_steps_along_the_jax_engine(tmp_path, jax_run):
    batches, jax_metrics, states = jax_run
    e = Engine(_config(tmp_path, *PARITY), mode="train", device="cpu")
    assert isinstance(e.model, port_clip.CLIP)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert set(b) == {"image", "text"} and {"loss", "acc1", "logit_scale"} <= set(want)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    assert e.state.step == STEPS
    e.close()


def test_clip_config_groups_as_jax_build_optimizer_does():
    """clip_vit_b32_in1k: each parameter's group (name, weight decay, lr scale)
    from the port's engine against the JAX package's `build_optimizer` at the config's widths:
    `no_weight_decay_name` takes logit_scale and both position and class
    embeddings, `one_dim_param_no_weight_decay` the norms and biases."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.optimizer import build_optimizer as jax_build_optimizer

    config = cfg_util.get_config(os.path.join(REPO, "configs", "clip", "clip_vit_b32_in1k.yaml"),
                                 show=False)
    model_cfg = dict(config["Model"])
    opt_cfg = dict(config["Optimizer"])
    jm = jax_build_model(dict(model_cfg))
    b = {"image": jnp.zeros((1, 224, 224, 3)), "text": jnp.zeros((1, 77), jnp.int32)}
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), b, train=True))["params"]
    jopt = jax_build_optimizer(opt_cfg, params, frozen_patterns=[], num_layers=0)
    with torch.device("meta"):
        pm = build_model(dict(model_cfg))
    popt = model_optimizer(pm, opt_cfg, model_cfg)
    named = dict(pm.named_parameters())
    paths = {flax_path(n, p.dim()): n for n, p in named.items()}
    flat = _flatten(jax.tree_util.tree_map(lambda s: np.empty(0), params))
    assert set(paths) == set(flat)
    decays = set()
    for jpath, name in paths.items():
        jg, pg = jopt.group_of(jpath), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale) == (jg.name, jg.weight_decay,
                                                          jg.lr_scale), name
        decays.add((name.split(".")[-1], pg.weight_decay))
    for name in ("logit_scale", "positional_embedding", "class_embedding"):
        assert (name, 0.0) in decays
    assert ("proj", 0.2) in decays and ("text_projection", 0.2) in decays


CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "clip", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "clip_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_clip_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert isinstance(model, port_clip.CLIP)
    assert sum(p.numel() for p in model.parameters()) > 0


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_clip_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, "Global.max_train_step=3", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    hist = e.train_loop.history
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(0.0 <= h["acc1"] <= 1.0 for h in hist)
