"""DINO of the PyTorch port (passl_tpu_torch/models/dino.py) against the JAX
package.

On the CPU, at the JAX tests' tiny sizes (tests/test_ssl_methods.py: a ViT of
2 blocks, 64 wide, over 32 x 32 global crops in 8 x 8 patches and 16 x 16
local crops, heads of 64 -> 32 -> 128), from the JAX weights carried across
by `flax_to_torch`: `interpolate_pos_embed`'s values and gradient at DINO's
14 -> 6 and DINOv2's 16 -> 7 against `jax.image.resize`; the encoder's
features (the last n class tokens, the patch-token mean, a resized grid,
LayerScale); DINOPretrain's loss (f32, 1e-5 relative), every student
gradient (max abs error at most 1e-4 of the JAX gradient's norm), the
center after the step, one student forward a resolution and one teacher
forward; both linear probes (their frozen encoders); and the slice
as a whole: each of the JAX engine's first 3 steps of
tests/e2e/dino_structured.yaml (8 images of 2 + 4 crops, f32) from JAX's
state, the center included. The optimizer groups of
dino_vit_s16_pretrain_in1k against the JAX package's `build_optimizer`, the eight encoder
variants, every DINO config built on the meta device, and the learning
check's extract into the probe. A test marked `cuda` trains the tiny DINO on
the card. DINOv2 is in tests/test_torch_dinov2.py.
"""
import contextlib
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import dino as port_dino
from passl_tpu_torch.models.vision_transformer import interpolate_pos_embed
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_path, flax_to_torch
from test_torch_deit import _adamw_moments, assert_step_tracks, jax_states
from test_torch_moco import _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = os.path.join(REPO, "tests", "e2e")
BACKBONE = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
HEAD = dict(out_dim=128, hidden_dim=64, bottleneck_dim=32, global_crops=2, teacher_temp=0.04,
            base_momentum=0.9)


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


def crops(n, seed, sizes=(32, 32, 16, 16, 16, 16)):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, s, s, 3).astype(np.float32) for s in sizes]


def jax_variables(jm, example, seed, **kw):
    """The flax model's variables, drawn with numpy from their shapes."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        jax.tree_util.tree_map(jnp.asarray, example), **kw))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def port_state(model, variables) -> dict:
    ssl = {"ssl": variables["ssl"]} if "ssl" in variables else None
    return flax_to_torch(variables["params"], model, collections=ssl)


def assert_grads(model, grads, skip=lambda name: False, floor=1e-7):
    """Every parameter's gradient within 1e-4 of the JAX gradient's norm (plus
    `floor` for gradients of rounding alone); a parameter the loss does not
    reach has none in the port and zeros in JAX."""
    names = dict(model.named_parameters())
    want = dict(_torch_name(p, a, names=names) for p, a in _flatten(grads).items())
    assert set(want) == set(names)
    for name, p in names.items():
        w = want[name]
        if skip(name) or p.grad is None:
            assert skip(name) or not np.any(w), name
            continue
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * np.linalg.norm(w) + floor, (name, err, np.linalg.norm(w))


# ------------------------------------------------- the resize and the encoder


@pytest.mark.parametrize("old, new", [(14, 6), (16, 7), (4, 2)])
def test_interpolate_pos_embed_values_and_gradient_are_jaxs(old, new):
    """The bicubic, antialiased resize of `jax.image.resize` and its gradient,
    the class slot kept."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.vision_transformer import interpolate_pos_embed as jax_interp

    rs = np.random.RandomState(old)
    pos = rs.randn(1, old * old + 1, 24).astype(np.float32)
    r = rs.randn(1, new * new + 1, 24).astype(np.float32)
    want_out = np.asarray(jax_interp(jnp.asarray(pos), new, num_prefix=1))
    jgrad = np.asarray(jax.grad(lambda p: jnp.sum(jax_interp(p, new, num_prefix=1) * r))(
        jnp.asarray(pos)))
    t = torch.from_numpy(pos).requires_grad_(True)
    out = interpolate_pos_embed(t, new, num_prefix=1)
    assert out.shape == (1, new * new + 1, 24) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5, atol=1e-6)
    (out * torch.from_numpy(r)).sum().backward()
    assert np.abs(t.grad.numpy() - jgrad).max() <= 1e-5 * np.linalg.norm(jgrad)
    np.testing.assert_array_equal(t.grad.numpy()[:, 0], r[:, 0])  # the class slot passes through


@pytest.mark.parametrize("n_last, patch_avg, init_values, size", [
    (1, False, None, 32), (2, False, None, 16), (1, True, 1e-5, 32), (2, True, 1.0, 24)])
def test_encoder_features_match_jax(n_last, patch_avg, init_values, size):
    import jax.numpy as jnp

    from passl_tpu.models.dino import DINOVisionTransformer as JaxViT

    kw = dict(BACKBONE, init_values=init_values)
    jm = JaxViT(**kw)
    x = crops(3, 5, (size,))[0]
    variables = jax_variables(jm, x, 2)
    pm = port_dino.DINOVisionTransformer(**kw)
    pm.load_state_dict(port_state(pm, variables))
    assert hasattr(pm.blocks[0], "gamma_1") == (init_values is not None)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), n_last, patch_avg).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False, n_last_blocks=n_last,
                               return_patch_avg=patch_avg))
    assert got.shape == (3, 64 * (n_last + patch_avg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- pretrain


def _jax_pretrain_step(jm, variables, batch):
    """One train-mode forward and backward: the loss, the gradients and the
    updated `ssl` collection."""
    import jax
    import jax.numpy as jnp

    rest = {k: v for k, v in variables.items() if k != "params"}
    jb = [jnp.asarray(c) for c in batch]

    def loss(p):
        out, new = jm.apply({"params": p, **rest}, jb, train=True, mutable=["ssl"])
        return out["loss"], new

    (value, new), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return float(value), jax.device_get(grads), jax.device_get(new)


def test_pretrain_loss_gradients_and_center_match_jax():
    """Two train-mode steps of 6 images over 2 global and 4 local crops, from a
    nonzero center: the loss, every student gradient (the teacher takes none),
    the center after each; one student forward per resolution, in the order
    of their first appearance (two local sizes, interleaved), and 1 teacher
    forward a step; the eval forward leaves the center."""
    from passl_tpu.models.dino import DINOPretrain as JaxDINO

    jm = JaxDINO(backbone=BACKBONE, **HEAD)
    variables = jax_variables(jm, crops(2, 0), 3, train=True)
    pm = port_dino.DINOPretrain(backbone=BACKBONE, **HEAD).train()
    pm.load_state_dict(port_state(pm, variables))
    seen = {"student": [], "teacher": []}
    for tower in seen:
        getattr(pm, tower).register_forward_hook(
            lambda mod, args, out, tower=tower: seen[tower].append(tuple(args[0].shape)))
    for t in range(2):
        batch = crops(6, 10 + t, (32, 32, 16, 24, 16, 24))  # the local sizes interleaved
        want, grads, new = _jax_pretrain_step(jm, variables, batch)
        for p in pm.parameters():
            p.grad = None
        out = pm([torch.from_numpy(c) for c in batch])
        assert set(out) == {"loss"} and out["loss"].dtype == torch.float32
        np.testing.assert_allclose(out["loss"].item(), want, rtol=1e-5)
        out["loss"].backward()
        assert all(p.grad is None for p in pm.teacher.parameters())
        assert_grads(pm, grads)
        np.testing.assert_allclose(pm.center.numpy(), np.asarray(new["ssl"]["center"]),
                                   rtol=1e-5, atol=1e-7)
        variables = {**variables, "ssl": new["ssl"]}
    assert seen["student"] == [(12, 32, 32, 3), (12, 16, 16, 3), (12, 24, 24, 3)] * 2
    assert seen["teacher"] == [(12, 32, 32, 3)] * 2
    center = pm.center.clone()
    pm.eval()
    with torch.no_grad():
        assert torch.isfinite(pm([torch.from_numpy(c) for c in crops(2, 30)])["loss"])
    assert torch.equal(pm.center, center)


def test_center_moves_by_its_rule():
    """center <- 0.9 center + 0.1 mean of the teacher's raw outputs (in f32)."""
    pm = init_module(port_dino.DINOPretrain(backbone=BACKBONE, **HEAD),
                     torch.Generator().manual_seed(0)).train()
    pm.center.normal_(generator=torch.Generator().manual_seed(1))
    batch = [torch.from_numpy(c) for c in crops(4, 2)]
    before = pm.center.clone()
    with torch.no_grad():
        t = pm.teacher(torch.cat(batch[:2]))
        pm(batch)
    torch.testing.assert_close(pm.center, 0.9 * before + 0.1 * t.mean(0, keepdim=True),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------------ probes


@pytest.mark.parametrize("name", ["DINOLinearProbe", "DINOv2LinearProbe"])
def test_linear_probes_match_jax_over_their_frozen_encoders(name):
    """Logits against JAX's; the gradient reaches the head alone; the encoder
    stays in eval in training; the head starts at normal(0.01) and zero bias."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import dino as jax_dino

    enc = dict(BACKBONE, depth=3)
    jm = getattr(jax_dino, name)(encoder=enc, num_classes=7)
    pm = getattr(port_dino, name)(encoder=enc, num_classes=7).train()
    x = crops(4, 6, (32,))[0]
    variables = jax_variables(jm, x, 4)
    pm.load_state_dict(port_state(pm, variables))
    assert not pm.encoder.training and pm.head.training
    out = pm(torch.from_numpy(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=True))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    out.sum().backward()
    assert all(p.grad is None for p in pm.encoder.parameters())
    assert pm.head.weight.grad is not None
    assert pm.frozen_patterns() == [r"^encoder\."]
    feats = 64 * (3 if name == "DINOLinearProbe" else 2)  # at most the encoder's 3 blocks
    assert pm.head.in_features == feats
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x))))(
        variables["params"])
    assert not any(np.any(g) for g in jax.tree_util.tree_leaves(jgrads["encoder"]))
    fresh = init_module(getattr(port_dino, name)(encoder=enc, num_classes=500),
                        torch.Generator().manual_seed(0))
    assert abs(fresh.head.weight.std().item() - 0.01) < 1e-3
    assert torch.equal(fresh.head.bias, torch.zeros(500))


@pytest.mark.parametrize("name", sorted(port_dino._DINO_VARIANTS))
def test_every_dino_variant_is_registered(name):
    from passl_tpu.models.base import MODELS as JAX_MODELS

    jm = JAX_MODELS.get(name)()
    with torch.device("meta"):
        pm = build_model({"name": name})
    assert isinstance(pm, port_dino.DINOVisionTransformer)
    assert (len(pm.blocks), pm.embed_dim, pm.patch_size) == (jm.depth, jm.embed_dim,
                                                             jm.patch_size)
    assert pm.blocks[0].attn.num_heads == jm.num_heads
    assert hasattr(pm.blocks[0], "gamma_1") == (jm.init_values is not None)


# ----------------------------------------------------- the slice as a whole

DINO_CFG = os.path.join(E2E, "dino_structured.yaml")
PARITY = ["FP16.enable=False", "DataLoader.Train.sampler.batch_size=8",
          "DataLoader.Train.dataset.dataset.size=64"]
STEPS = 3


def engine_config(path, tmp_path, *overrides):
    return cfg_util.get_config(path, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def jax_engine_run(path, tmp, overrides, steps=STEPS, during=contextlib.nullcontext):
    """The JAX engine's first `steps` loader batches, its metrics on them and
    its state before each step and after the last (parameters, the `ssl`
    collection, AdamW moments), in the port's names and layouts; the steps
    run inside the context `during()` (DINOv2's record their draws there)."""
    from passl_tpu.engine import Engine as JaxEngine

    port = build_model(dict(engine_config(path, tmp, *overrides)["Model"]))
    je = JaxEngine(engine_config(path, tmp, *overrides), mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == steps:
            break

    def convert(model, state):
        return (port_state(model, {"params": state.params, **state.model_state}),
                _adamw_moments(state.opt_state, model.state_dict()))

    with during():
        metrics, states = jax_states(je, batches, port, convert)
    je.train_dataloader.close()
    return batches, metrics, states


def test_tiny_dino_steps_along_the_jax_engine(tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, clip 3.0, the cosine EMA,
    the center) from JAX's state: the loss, every parameter's and the
    center's change, the AdamW moments; the teacher has no optimizer state."""
    batches, jax_metrics, states = jax_engine_run(DINO_CFG, tmp_path / "jax", PARITY)
    e = Engine(engine_config(DINO_CFG, tmp_path, *PARITY), mode="train", device="cpu")
    assert isinstance(e.model, port_dino.DINOPretrain)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert [c.shape for c in b] == [(8, 32, 32, 3)] * 2 + [(8, 16, 16, 3)] * 4
        assert_step_tracks(e, b, want, states[t], states[t + 1], t)
        assert not torch.equal(e.model.center, states[t][0]["center"])
    assert e.state.step == STEPS
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert all((id(p) in stateful) != n.startswith("teacher.")
               for n, p in e.model.named_parameters())
    e.close()


def assert_groups_match_jax(path):
    """Each parameter's group (name, weight decay, lr scale, frozen) from the
    port's engine against the JAX engine's rules at the config's widths."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.optimizer import build_optimizer as jax_build_optimizer

    config = cfg_util.get_config(path, show=False)
    model_cfg = dict(config["Model"])
    opt_cfg = dict(config["Optimizer"])
    opt_cfg.pop("grad_clip", None)
    jm = jax_build_model(dict(model_cfg))
    x = [jnp.zeros((1, 224, 224, 3))] * 2 + [jnp.zeros((1, 96, 96, 3))]
    params = dict(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)}, x,
        train=True))["params"])
    params["teacher"] = params["student"]  # the JAX engine's init-sync copy
    num_layers = int(model_cfg.get("depth", 0) or getattr(jm, "depth", 0) or 0)
    jopt = jax_build_optimizer(opt_cfg, params, frozen_patterns=list(jm.frozen_patterns()),
                               num_layers=num_layers)
    with torch.device("meta"):
        pm = build_model(dict(model_cfg))
    popt = model_optimizer(pm, opt_cfg, model_cfg)
    named = dict(pm.named_parameters())
    paths = {flax_path(n, p.dim()): n for n, p in named.items()}
    flat = _flatten(jax.tree_util.tree_map(lambda s: np.empty(0), params))
    assert set(paths) == set(flat)
    for jpath, name in paths.items():
        jg, pg = jopt.group_of(jpath), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale) == (jg.name, jg.weight_decay,
                                                          jg.lr_scale), name
        assert (pg.rule == "Frozen") == (type(jg.rule).__name__ == "Frozen") == \
            name.startswith("teacher."), name
    return popt, named


def test_pretrain_config_groups_as_jax_build_optimizer_does():
    popt, named = assert_groups_match_jax(
        os.path.join(REPO, "configs", "dino", "dino_vit_s16_pretrain_in1k.yaml"))
    assert popt.group_of("student.head.prototypes").weight_decay == 0.04
    assert popt.group_of("student.backbone.norm.weight").weight_decay == 0.0


CENSUS = (sorted(glob.glob(os.path.join(REPO, "configs", "dino", "*.yaml")))
          + [DINO_CFG, os.path.join(E2E, "probe_dino_structured.yaml")])


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_dino_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_fills_the_structured_probe(tmp_path):
    """The learning check's extract: `student.backbone` re-rooted under
    `encoder` fills every encoder entry of the probe's model."""
    from passl_tpu_torch.tools import extract_weights

    model = init_module(build_model(dict(cfg_util.get_config(DINO_CFG)["Model"])),
                        torch.Generator().manual_seed(0))
    picked = extract_weights.extract(model.state_dict(), "student.backbone", rename="encoder")
    out = str(tmp_path / "backbone.pt")
    torch.save(picked, out)
    probe = os.path.join(E2E, "probe_dino_structured.yaml")
    assert extract_weights.unfilled(probe, out, "encoder") == []


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_dino_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(DINO_CFG, tmp_path, "Global.max_train_step=3",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    e.train()
    hist = e.train_loop.history
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert torch.isfinite(e.model.center).all() and e.model.center.abs().sum() > 0
