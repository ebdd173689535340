"""LV-ViT and its token-labeling trainer in the PyTorch port
(passl_tpu_torch/models/t2t_vit.py `LVViT`, `LVViTTokenLabel`) against the
JAX package.

On the CPU, at the sizes of configs/lvvit/lvvit_tiny_token_label_synthetic.yaml
(32 x 32 images, a 4 x 4 patch grid, top-3 token labels), from the JAX
parameters converted, on the same numpy inputs: `LVViT`'s train-mode logits
on the port's stochastic-depth draws handed to JAX, every gradient, its stem
BatchNorms' statistics and its eval logits; `LVViTTokenLabel`'s loss, its
three parts and every gradient on MixToken draws handed to both (a box
inside the grid, the coin off, a box clipped at the grid's edge); the eval
path and the logits on images alone; its state dict loading strictly into
`lvvit_s`, whose eval logits equal it; 4 steps on one fixed batch through
the JAX engine and the port's from JAX's state, with `mix_prob` 0 and no
stochastic depth so that neither draws, the loss falling in both. Then the
census: both configs under configs/lvvit/ build their models (the in1k
config's `label_root` maps are not in the repo). A test marked `cuda`
trains the tiny config on the card and skips elsewhere.
"""
import contextlib
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import build_dataset, to_device
from passl_tpu_torch.engine.engine import Engine, _refuse_unported
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import t2t_vit as port_t2t
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_beit import (assert_grads_match, engine_config, handed_bernoulli,
                             recorded_drop_path_draws)
from test_torch_deit import _adamw_moments, assert_step_tracks
from test_torch_moco import _one_openmp_thread, _randomize  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "lvvit", "lvvit_tiny_token_label_synthetic.yaml")
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=10)
GRID, TOPK = 4, 3
# MixToken's (lam, cx, cy, u) on the 4 x 4 grid: sides int(sqrt(0.7) 4) = 3,
# the box columns 1-2 and rows 0-1, the coin on; the same with the coin off;
# sides int(sqrt(0.95) 4) = 3 at the corner (0, 3), clipped to column 0 and
# rows 2-3
DRAWS = {"mixed": (0.3, 2, 1, 0.2), "unmixed": (0.3, 2, 1, 0.9), "clipped": (0.05, 0, 3, 0.1)}
BOX_CELLS = {"mixed": 4, "unmixed": 0, "clipped": 2}


def _batch(n, seed):
    """A token-label batch as the loader gives it (numpy)."""
    rs = np.random.RandomState(seed)
    vals = rs.rand(n, GRID, GRID, TOPK).astype(np.float32)
    vals /= vals.sum(-1, keepdims=True)
    return {"image": rs.randn(n, 32, 32, 3).astype(np.float32),
            "label": rs.randint(0, 10, n).astype(np.int32),
            "token_value": vals,
            "token_idx": rs.randint(0, 10, (n, GRID, GRID, TOPK)).astype(np.int32)}


def _torch_batch(b):
    return to_device(b, torch.device("cpu"))


def _variables(jm, seed):
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes)),
                      seed)


def _load(pm, variables):
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    return pm


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=msg)


def _assert_stats(pm, stats):
    state = pm.state_dict()
    keys = []
    for path, arr in _flatten(stats).items():
        key, arr = _torch_name(path, arr, stats=True)
        keys.append(key)
        np.testing.assert_allclose(state[key].numpy(), arr, rtol=1e-5, atol=1e-6, err_msg=key)
    assert len(keys) == 6  # the three stem BatchNorms' mean and var


@contextlib.contextmanager
def handed_mixtoken(lam, cx, cy, u):
    """JAX's MixToken draws (jax.random.beta, randint twice, uniform) give the
    values given, as traced."""
    import jax
    import jax.numpy as jnp

    coords = [cx, cy]
    orig = jax.random.uniform

    def beta(key, a, b, *args, **kwargs):
        return jnp.float32(lam)

    def randint(key, shape, minval, maxval, *args, **kwargs):
        return jnp.int32(coords.pop(0))

    def uniform(key, shape=(), *args, **kwargs):  # the coin: the only scalar uniform
        return jnp.float32(u) if tuple(shape) == () else orig(key, shape, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "beta", beta)
        mp.setattr(jax.random, "randint", randint)
        mp.setattr(jax.random, "uniform", uniform)
        yield coords


def _port_draws(lam, cx, cy, u):
    return (torch.tensor(lam, dtype=torch.float32), torch.tensor(cx), torch.tensor(cy),
            torch.tensor(u, dtype=torch.float32))


# ------------------------------------------------------------------ LVViT


def test_lvvit_logits_gradients_and_stem_statistics_match_jax():
    """`lvvit_s` at tiny widths: train-mode logits on the port's drop-path draws
    (linspace(0, 0.1, 2): block 1 draws twice) handed to JAX, every gradient,
    the three stem BatchNorms' statistics, and the eval logits."""
    import jax

    from passl_tpu.models import build_model as jax_build_model

    jm = jax_build_model(dict(TINY, name="lvvit_s"))
    variables = _variables(jm, 1)
    pm = _load(build_model(dict(TINY, name="lvvit_s")), variables)
    assert isinstance(pm, port_t2t.LVViT) and pm.grid == GRID
    assert pm.pos_embed.shape == (1, GRID * GRID + 1, 64)
    x, w = _batch(4, 2)["image"], np.random.RandomState(3).randn(4, 10).astype(np.float32)
    pm.train()
    with recorded_drop_path_draws() as draws:
        got = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    assert len(draws) == 2
    masks = [(u < 1.0 - rate).numpy() for u, rate in draws]

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * w).sum(), (out, mut["batch_stats"])

    with handed_bernoulli(masks):
        (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    _close(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(w)).sum().backward()
    assert_grads_match(pm, jax.device_get(grads))
    _assert_stats(pm, jax.device_get(stats))
    want = jm.apply({"params": variables["params"], "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)).numpy(), np.asarray(want))


# ------------------------------------------------------- token labeling


@pytest.fixture(scope="module")
def token_label_pair():
    from passl_tpu.models.t2t_vit import LVViTTokenLabel as JaxTokenLabel

    kw = dict(TINY, dense_weight=0.5, drop_path_rate=0.0)
    jm = JaxTokenLabel(**kw)
    variables = _variables(jm, 4)
    return jm, variables, kw


@pytest.mark.parametrize("case", list(DRAWS))
def test_token_label_loss_parts_and_gradients_match_jax(case, token_label_pair):
    """The loss, loss_cls, loss_aux and acc1 (1e-5 relative) and every gradient
    (1e-4 of each tensor's largest entry) on the same MixToken draws, the
    box's cells as the draws say; the stem statistics after the step."""
    import jax

    jm, variables, kw = token_label_pair
    pm = _load(port_t2t.LVViTTokenLabel(**kw), variables).train()
    b = _batch(6, 5)
    box = port_t2t.mixtoken_box(_port_draws(*DRAWS[case]), GRID, GRID, pm.mix_prob)
    assert int(box.sum()) == BOX_CELLS[case]

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, b,
                            train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1)})
        return out["loss"], (out, mut["batch_stats"])

    with handed_mixtoken(*DRAWS[case]) as left:
        (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    assert left == []
    got = pm(_torch_batch(b), mix=_port_draws(*DRAWS[case]))
    assert set(got) == set(want) == {"loss", "loss_cls", "loss_aux", "acc1"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["loss"].item(),
                               got["loss_cls"].item() + 0.5 * got["loss_aux"].item(), rtol=1e-6)
    got["loss"].backward()
    assert_grads_match(pm, jax.device_get(grads))
    _assert_stats(pm, jax.device_get(stats))


def test_token_label_draws_from_the_generator_when_none_is_handed(token_label_pair):
    """Without `mix` the four draws come from the generator, in JAX's order
    (lam, cx, cy, u), and the step equals the one on those draws handed in."""
    _, variables, kw = token_label_pair
    pm = _load(port_t2t.LVViTTokenLabel(**kw), variables).train()
    b = _torch_batch(_batch(4, 6))
    draws = port_t2t.mixtoken_draws(GRID, GRID, torch.Generator().manual_seed(7),
                                    torch.device("cpu"))
    assert [d.dtype for d in draws] == [torch.float32, torch.int64, torch.int64, torch.float32]
    assert 0 <= int(draws[1]) < GRID and 0 <= int(draws[2]) < GRID
    with torch.no_grad():
        got = pm(b, generator=torch.Generator().manual_seed(7))
        want = pm(b, mix=draws)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_token_label_eval_and_image_paths_match_jax(token_label_pair):
    """At eval (dict or images) and on images alone in training: the f32
    logits `head(cls) + 0.5 max(aux_head(patches))`, as JAX returns them."""
    jm, variables, kw = token_label_pair
    pm = _load(port_t2t.LVViTTokenLabel(**kw), variables)
    b = _batch(4, 8)
    want = np.asarray(jm.apply(variables, b, train=False))
    with torch.no_grad():
        for got in (pm.eval()(_torch_batch(b)), pm.eval()(torch.from_numpy(b["image"]))):
            assert got.dtype == torch.float32
            _close(got.numpy(), want)
        want_img = np.asarray(jm.apply(variables, b["image"], train=True,
                                       mutable=["batch_stats"])[0])
        _close(pm.train()(torch.from_numpy(b["image"])).numpy(), want_img)


def test_token_label_state_dict_loads_strictly_into_lvvit_s(token_label_pair):
    """The two models hold the same parameters and statistics (JAX asserts its
    trees equal), so the trainer's weights serve as `lvvit_s`: its eval logits
    (aux_weight 0.5) equal the trainer's (dense_weight 0.5) bitwise."""
    from passl_tpu.models import build_model as jax_build_model

    jm, variables, kw = token_label_pair
    jax_plain = _variables(jax_build_model(dict(TINY, name="lvvit_s")), 4)
    assert set(_flatten(jax_plain["params"])) == set(_flatten(variables["params"]))
    pm = _load(port_t2t.LVViTTokenLabel(**kw), variables).eval()
    plain = build_model(dict(TINY, name="lvvit_s"))
    plain.load_state_dict(pm.state_dict(), strict=True)
    x = torch.from_numpy(_batch(4, 9)["image"])
    with torch.no_grad():
        assert torch.equal(plain.eval()(x), pm(x))


# ----------------------------------------------------- the slice as a whole


def assert_step_tracks_resolved(engine, batch, want, before, after, t, skip=()):
    """`assert_step_tracks`, but for the entries whose gradient f32 does not
    resolve: where AdamW's scale sqrt(v / (1 - 0.999^(t+1))) after the step
    lies under 1e-5 of its tensor's largest, the update divides rounding noise
    by the epsilon (1e-8) and takes any value up to the lr, so those entries'
    changes are held within the lr; the rest of their tensors within a tenth
    of it, and their moments as `assert_step_tracks` holds them. The
    parameters under `skip` are not held."""
    (s0, _), (s1, m1) = before, after
    low = {}
    for name, mv in m1.items():
        scale = (mv["v"] / (1 - 0.999 ** (t + 1))).sqrt()
        if not name.startswith(skip) and (scale < 1e-5 * scale.max()).any():
            low[name] = scale < 1e-5 * scale.max()
    assert_step_tracks(engine, batch, want, before, after, t,
                       skip=lambda name: name in low or name.startswith(skip))
    lr = want["lr"]
    state = engine.optimizer.torch_optimizer.state
    named = dict(engine.model.named_parameters())
    for name, mask in low.items():
        assert mask.sum() <= max(2, mask.numel() // 100), (t, name)  # a few entries, no more
        diff = ((named[name] - s0[name]) - (s1[name] - s0[name])).detach().abs()
        assert diff[~mask].max().item() <= 0.1 * lr + 1e-7, (t, name)
        assert diff[mask].max().item() <= lr + 1e-7, (t, name)
        for kind, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            got_t, want_t = state[named[name]][key], m1[name][kind]
            assert (got_t - want_t).norm() <= 1e-4 * want_t.norm() + 1e-12, (t, name, kind)


STEM_BN = ("stem_bn0.", "stem_bn1.", "stem_bn2.")


def _stem_bn_grads_f64(model_cfg, flax_state, batch) -> dict:
    """The JAX model's gradients of the stem BatchNorms' scale and bias in f64
    (`jax.enable_x64`) at a JAX engine state, in the port's names."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.t2t_vit import LVViTTokenLabel as JaxTokenLabel

    kw = {k: v for k, v in model_cfg.items() if k != "name"}
    with jax.enable_x64(True):
        jm = JaxTokenLabel(**kw, dtype=jnp.float64)
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     {"params": flax_state.params, **flax_state.model_state})
        b64 = {k: np.asarray(v, np.float64) if v.dtype == np.float32 else v
               for k, v in batch.items()}

        def loss(params):
            out, _ = jm.apply({**f64, "params": params}, b64, train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0),
                                    "mixup": jax.random.PRNGKey(1)})
            return out["loss"]

        grads = jax.device_get(jax.jit(jax.grad(loss))(f64["params"]))
    return {k: v for k, v in (_torch_name(p, a) for p, a in _flatten(grads).items())
            if k.startswith(STEM_BN)}


def test_tiny_token_label_steps_along_the_jax_engine_on_a_fixed_batch(tmp_path):
    """The tiny config with `mix_prob` 0 and no stochastic depth, on the label-
    free loop (no Loss block): each of the JAX engine's 4 steps on its first
    loader batch, repeated, from JAX's state (the loss parts, every parameter's
    and statistic's change, the AdamW moments), and the loss falling in JAX
    and in the port's own 4 steps from JAX's initial state. The stem
    BatchNorms' scale and bias: flax's f32 BatchNorm (E[x²] - E[x]²) puts
    JAX's own f32 gradients of the first two 3e-4 to 5e-4 from its f64 ones,
    the port's two-pass statistics 2e-6, so their gradients are held against
    the JAX model's in f64 (1e-4 of the largest entry) and their steps are not
    held against JAX's f32 ones."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    # 8 steps an epoch, so that the cosine lr stays above 0 over the 4 steps
    overrides = ["DataLoader.Train.dataset.size=64", "DataLoader.Train.sampler.batch_size=8",
                 "Model.mix_prob=0.0", "Model.drop_path_rate=0.0"]
    config = engine_config(TINY_CFG, tmp_path, *overrides)
    port = build_model(dict(config["Model"]))
    je = JaxEngine(engine_config(TINY_CFG, tmp_path / "jax", *overrides), mode="train")
    je.train_dataloader.set_epoch(1)
    batch = next(iter(je.train_dataloader))
    je.train_dataloader.close()
    assert set(batch) == {"image", "label", "token_value", "token_idx"}
    flax_states, jax_metrics = [jax.device_get(je.state)], []
    for _ in range(4):
        je.state, m = je.train_step(je.state, je.shard_batch(batch))
        jax_metrics.append({k: float(v) for k, v in m.items()})
        flax_states.append(jax.device_get(je.state))
    states = [(flax_to_torch(s.params, port, s.model_state["batch_stats"]),
               _adamw_moments(s.opt_state, port.state_dict())) for s in flax_states]
    e = Engine(config, mode="train", device="cpu")
    assert isinstance(e.model, port_t2t.LVViTTokenLabel) and e.criterion is None
    named = dict(e.model.named_parameters())
    for t, want in enumerate(jax_metrics):
        assert {"loss", "loss_cls", "loss_aux", "acc1"} <= set(want)
        assert_step_tracks_resolved(e, batch, want, states[t], states[t + 1], t, skip=STEM_BN)
        f64 = _stem_bn_grads_f64(config["Model"], flax_states[t], batch)
        assert len(f64) == 6
        for name, g in f64.items():
            np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0,
                                       atol=1e-4 * np.abs(g).max(), err_msg=(t, name))
    e.model.load_state_dict(states[0][0])
    e.optimizer.torch_optimizer.state.clear()
    e.state.step = 0
    own = [float(e.train_step(e.state, to_device(batch, e.device))["loss"]) for _ in range(4)]
    jax_losses = [m["loss"] for m in jax_metrics]
    assert jax_losses[-1] < jax_losses[0] and own[-1] < own[0], (jax_losses, own)
    np.testing.assert_allclose(own, jax_losses, rtol=1e-4)
    e.close()


def test_the_trained_weights_serve_as_lvvit_s(tmp_path):
    """tools/export refuses the label-free token-label config, as the JAX
    engine does; the same config with `Model` swapped for `lvvit_s` and a
    `Loss` block exports the trainer's checkpoint, its input spec read from a
    sample of the token-label dataset (a dict), and Predictor's logits equal
    the trainer's eval logits."""
    from passl_tpu_torch.engine.inference import Predictor
    from passl_tpu_torch.tools import export

    e = Engine(engine_config(TINY_CFG, tmp_path / "train", "DataLoader.Train.dataset.size=16",
                             "DataLoader.Train.sampler.batch_size=8", "Global.max_train_step=1"),
               mode="train", device="cpu")
    e.train()
    ckpt = str(tmp_path / "train" / "latest.pt")
    argv = ["-c", TINY_CFG, "-o", f"Global.output_dir={tmp_path / 'serve'}",
            "-o", f"Global.checkpoint={ckpt}"]
    with pytest.raises(ValueError, match="export targets inference models"):
        export.main(argv)
    serve = [*argv, "-o", "Model=" + repr(dict(TINY, name="lvvit_s")),
             "-o", "Loss={'Train': [{'CELoss': {}}]}"]
    export.main(serve)
    pred = Predictor(str(tmp_path / "serve"), name="lvvit_s", device="cpu")
    assert pred.spec["input"]["shape"] == [None, 32, 32, 3]
    x = _batch(4, 10)["image"]
    with torch.no_grad():
        want = e.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(pred.predict(x), want)


# ------------------------------------------------------------------ census

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "lvvit", "*.yaml")))


def test_the_census_holds_2_lvvit_configs():
    assert len(CONFIGS) == 2


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_lvvit_config_builds(path):
    """The model of each; the tiny config's dataset too (the in1k config's
    label maps are not in the repo)."""
    config = cfg_util.get_config(path, show=False)
    _refuse_unported(config)
    assert "Loss" not in config
    with torch.device("meta"):
        model = build_model(dict(config["Model"]))
    assert isinstance(model, port_t2t.LVViTTokenLabel)
    if "tiny" in path:
        ds = build_dataset(config["DataLoader"]["Train"]["dataset"])
        assert ds[0]["token_idx"].shape == (model.grid, model.grid, TOPK)
    else:
        assert model.grid == 14 and config["DataLoader"]["Train"]["dataset"]["grid_size"] == 14
        assert round(sum(p.numel() for p in model.parameters()) / 1e6, 2) == 26.15


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_token_label_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(TINY_CFG, tmp_path, "DataLoader.Train.dataset.size=24",
                             "DataLoader.Train.sampler.batch_size=8", "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    stats0 = {k: v.clone() for k, v in e.model.state_dict().items() if ".running_" in k}
    e.train()
    hist = e.train_loop.history
    assert [np.isfinite(h["loss"]) for h in hist] == [True, True]
    assert all(abs(h["loss"] - h["loss_cls"] - 0.5 * h["loss_aux"]) <= 1e-5 for h in hist)
    after = e.model.state_dict()
    assert len(stats0) == 6 and all(not torch.equal(after[k], v) for k, v in stats0.items())
