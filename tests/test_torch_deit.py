"""DeiT of the PyTorch port (passl_tpu_torch/models/deit.py) against the JAX
package.

The tiny distilled model has 2 blocks over a 32 x 32 image in 4 x 4 patches:
64 patches, the class and the distillation token, 66 tokens (the flash
resolver takes 65 and up). Its weights are redrawn with numpy and carried
over by `flax_to_torch`. Compared: logits on the einsum path and on the flash
path (the port's autograd Function on CPU tensors, the plain versions of the
kernels, against the JAX model's library kernels in interpret mode), in f32
and in bf16; the flash path's gradients; the two heads' mean in training and
in eval; the names and shapes of DeiT-B distilled on the meta device; the
seven DeiT names; and the slice as a whole: each of the JAX engine's first 4
steps of configs/classification/deit_tiny_synthetic.yaml, taken from JAX's
state (parameters and AdamW moments). Every DeiT config builds on the meta
device. A test marked `cuda` serves the tiny model on the card on both paths
and skips elsewhere.
"""
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import deit as port_deit
from passl_tpu_torch.models.vision_transformer import VisionTransformer
from passl_tpu_torch.ops.attention import flash_attention
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "classification", "deit_tiny_synthetic.yaml")
TINY = dict(img_size=32, patch_size=4, embed_dim=64, depth=2, num_heads=2, num_classes=8)


@pytest.fixture()
def jax_flash(monkeypatch):
    """The JAX model's flash path on this CPU: its TPU check answered yes and
    the library kernels in interpret mode (tests/test_torch_vit.py's fixture,
    with JAX imported inside it: the card's machine, which runs this file's
    `cuda` test, has no JAX)."""
    import passl_tpu.ops.attention as jax_attention
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jax_attention, "_tpu_backend", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def _randomize(params, seed):
    """tests/test_torch_vit.py's draw of every flax leaf, at a scale where each
    part of the model shows."""
    from test_torch_vit import _randomize as draw

    return draw(params, seed)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


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


def _pair(impl, dtype="float32", softmax="float32", seed=0):
    """(flax model, its params, port model) with the same weights."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.deit import DistilledVisionTransformer as JaxDeiT

    jm = JaxDeiT(**TINY, dtype=jnp.dtype(dtype), softmax_dtype=softmax, attn_impl=impl)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = _randomize(shapes, seed)
    pm = port_deit.DistilledVisionTransformer(**TINY, dtype=dtype, softmax_dtype=softmax,
                                              attn_impl=impl).eval()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _jax_logits(jm, params, x):
    import jax
    import jax.numpy as jnp

    fwd = jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))
    return np.asarray(fwd(params, jnp.asarray(x)).astype(jnp.float32))


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_tiny_distilled_logits_f32(impl, request):
    if impl == "flash":
        request.getfixturevalue("jax_flash")
    jm, params, pm = _pair(impl, seed=1)
    x = _images(4, seed=1)
    want = _jax_logits(jm, params, x)
    launches = flash_attention.launches
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert flash_attention.launches == launches  # CPU tensors: the plain versions
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    assert np.abs(want).max() > 0.5  # the weights make the logits spread
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_tiny_distilled_logits_bf16(impl, request):
    """bf16 compute with `softmax_dtype: bfloat16` (which the flash path
    ignores), held as tests/test_torch_vit.py holds the ViT in bf16."""
    if impl == "flash":
        request.getfixturevalue("jax_flash")
    jm, params, pm = _pair(impl, dtype="bfloat16", softmax="bfloat16", seed=2)
    x = _images(4, seed=2)
    want = _jax_logits(jm, params, x)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)
    assert _cos(got, want).min() > 0.9999


def test_tiny_flash_gradients_match_jax(jax_flash):
    """Every parameter's gradient of sum(logits * w), dist_token and head_dist
    included, through the port's autograd Function and the JAX library
    kernels' VJP in interpret mode."""
    import jax
    import jax.numpy as jnp

    jm, params, pm = _pair("flash", seed=3)
    x = _images(2, seed=3)
    w = np.random.RandomState(4).randn(2, 8).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=False) * w)

    want = flax_to_torch(jax.device_get(jax.jit(jax.grad(loss))(params)), pm)
    (pm(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want) and {"dist_token", "head_dist.weight"} <= set(got)
    for name, g in got.items():
        wv = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-4 * np.abs(wv).max(),
                                   err_msg=name)
    assert got["dist_token"].abs().max() > 0 and got["head_dist.weight"].abs().max() > 0


def test_logits_are_the_two_heads_mean_in_training_and_eval():
    _, _, pm = _pair("einsum", seed=5)
    x = torch.from_numpy(_images(3, seed=5))
    with torch.no_grad():
        eval_logits = pm(x)
        pm.train()
        train_logits = pm(x)  # no drop path: the same function
        tokens = pm.patch_embed(x)
        n = x.shape[0]
        t = torch.cat([pm.cls_token.expand(n, -1, -1), pm.dist_token.expand(n, -1, -1), tokens],
                      dim=1) + pm.pos_embed
        for blk in pm.blocks:
            t = blk(t)
        t = pm.norm(t)
        want = (pm.head(t[:, 0]) + pm.head_dist(t[:, 1])) / 2
    torch.testing.assert_close(train_logits, eval_logits, rtol=0, atol=0)
    torch.testing.assert_close(eval_logits, want, rtol=1e-6, atol=1e-6)


def test_deit_base_distilled_names_and_shapes_map_onto_the_port():
    """Full width, without allocating: flax shapes from eval_shape, the port on
    meta; DeiT-B distilled has 198 tokens."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.base import MODELS as JAX_MODELS

    flax_model = JAX_MODELS.get("DeiT_base_distilled_patch16_224")()
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))["params"]
    with torch.device("meta"):
        port = build_model({"name": "DeiT_base_distilled_patch16_224"})
    target = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    mapped = {}
    for path, leaf in _flatten(jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)).items():
        key, arr = _torch_name(path, leaf)
        mapped[key] = tuple(arr.shape)
    assert mapped == target
    assert target["pos_embed"] == (1, 198, 768)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(int(np.prod(s)) for s in target.values()) == n_flax


@pytest.mark.parametrize("name", sorted(port_deit._DEIT))
def test_every_deit_name_is_registered(name):
    from passl_tpu.models.base import MODELS as JAX_MODELS

    jm = JAX_MODELS.get(name)()
    with torch.device("meta"):
        model = build_model({"name": name})
    distilled = "distilled" in name
    assert isinstance(model, port_deit.DistilledVisionTransformer if distilled
                      else VisionTransformer)
    assert type(jm).__name__ == type(model).__name__
    assert (model.img_size, model.embed_dim, len(model.blocks)) == (jm.img_size, jm.embed_dim,
                                                                     jm.depth)
    assert model.blocks[0].attn.num_heads == jm.num_heads


def test_every_jax_deit_name_is_ported():
    from passl_tpu.models import deit as jax_deit

    assert set(port_deit._DEIT) == set(jax_deit._DEIT)


CENSUS = ["deit_base_patch16_224_in1k.yaml", "deit_base_patch16_224_fp32_in1k.yaml",
          "deit_tiny_synthetic.yaml"]


@pytest.mark.parametrize("config", CENSUS)
def test_every_deit_config_builds(config):
    model_cfg = dict(cfg_util.get_config(os.path.join(REPO, "configs", "classification", config),
                                         show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_dropout_stays_refused():
    with pytest.raises(NotImplementedError, match="drop_rate"):
        port_deit.DistilledVisionTransformer(**TINY, drop_rate=0.1)
    with pytest.raises(NotImplementedError, match="attn_drop_rate"):
        port_deit.DistilledVisionTransformer(**TINY, attn_drop_rate=0.1)


# ----------------------------------------------------- the slice as a whole

# f32 (the config has no FP16 block); no stochastic depth: the two
# frameworks draw other masks
PARITY = ["Model.drop_path_rate=0.0"]
STEPS = 4


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def _adamw_moments(opt_state, names=None, transposed=frozenset()) -> dict:
    """The JAX AdamW state {path: {m, v}} as the port's (exp_avg, exp_avg_sq)
    (`names`: the model's, where a module name ends in `_<i>` without being
    a list item, as CLIP's `ln_1`; `transposed`: its transposed convs)."""
    out = {}
    for path, leaf in _flatten(opt_state).items():
        head, kind = path.rsplit("/", 1)
        if kind in ("m", "v"):
            name, arr = _torch_name(head, leaf, names=names, transposed=transposed)
            out.setdefault(name, {})[kind] = torch.from_numpy(np.array(arr, np.float32))
    return out


def force_adamw(engine: Engine, model_state: dict, moments: dict, step: int) -> None:
    """The engine's model, AdamW moments and step set to a JAX state."""
    engine.model.load_state_dict(model_state)
    named = dict(engine.model.named_parameters())
    opt = engine.optimizer.torch_optimizer
    opt.state.clear()
    for name, mv in moments.items():
        opt.state[named[name]] = {"step": torch.tensor(float(step)),
                                  "exp_avg": mv["m"].clone(), "exp_avg_sq": mv["v"].clone()}
    engine.state.step = step


def jax_states(engine, batches, port_model, convert) -> tuple:
    """The JAX engine's metrics on `batches` and its state before each step and
    after the last, each as (model state_dict, AdamW moments) by `convert`."""
    import jax

    states = [convert(port_model, jax.device_get(engine.state))]
    metrics = []
    for b in batches:
        engine.state, m = engine.train_step(engine.state, engine.shard_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(convert(port_model, jax.device_get(engine.state)))
    return metrics, states


def assert_step_tracks(engine: Engine, batch, want: dict, before: tuple, after: tuple,
                       t: int, skip=lambda name: False, loss_rtol: float = 1e-5) -> None:
    """One port step from JAX's state `before` against JAX's step: the loss
    parts, the lr, every parameter's change (each within 2e-3 of the JAX
    change's norm and every element within a tenth of the step's lr, as
    test_torch_vit.py holds AdamW's updates) and the AdamW moments (1e-4 of
    their norms)."""
    force_adamw(engine, *before, t)
    got = {k: float(v) for k, v in
           engine.train_step(engine.state, to_device(engine.prepare_batch(batch),
                                                     engine.device)).items()}
    assert set(want) <= set(got) | {"grad_norm"}, (set(want), set(got))
    for k, v in want.items():
        if "loss" in k or k.startswith("acc"):
            np.testing.assert_allclose(got[k], v, rtol=loss_rtol, atol=1e-7, err_msg=(t, k))
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    lr = want["lr"]
    (s0, _), (s1, m1) = before, after

    def held(name, x):
        # the key bias adds one constant to every score of a row, which the
        # softmax cancels: its gradient is rounding noise on both sides, which
        # AdamW scales up to the lr, so only the query and value thirds are held
        # (the ViT's `attn.qkv`, CLIP's `attn_qkv`)
        if name.endswith(("attn.qkv.bias", "attn_qkv.bias")):
            third = x.shape[0] // 3
            return torch.cat([x[:third], x[2 * third:]])
        return x

    final = engine.model.state_dict()
    for name, p in final.items():
        if skip(name) or not p.is_floating_point():
            continue
        d_port, d_jax = held(name, p - s0[name]), held(name, s1[name] - s0[name])
        assert (d_port - d_jax).abs().max().item() <= 0.1 * lr + 1e-7, (t, name)
        assert (d_port - d_jax).norm() <= 2e-3 * d_jax.norm() + 0.1 * lr, (t, name)
    state = engine.optimizer.torch_optimizer.state
    named = dict(engine.model.named_parameters())
    for name, mv in m1.items():
        if skip(name):
            continue
        for kind, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            got_t, want_t = held(name, state[named[name]][key]), held(name, mv[kind])
            assert (got_t - want_t).norm() <= 1e-4 * want_t.norm() + 1e-12, (t, name, kind)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 4 loader batches, metrics and states."""
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

    metrics, states = jax_states(je, batches, port, convert)
    je.train_dataloader.close()
    return batches, metrics, states


def test_tiny_deit_steps_along_the_jax_engine(tmp_path, jax_run):
    batches, jax_metrics, states = jax_run
    e = Engine(_config(tmp_path, *PARITY), mode="train", device="cpu")
    assert isinstance(e.model, port_deit.DistilledVisionTransformer)
    assert type(e.optimizer.torch_optimizer).__name__ == "AdamW"
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "CELoss"} <= set(want)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    assert e.state.step == STEPS
    e.close()


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_distilled_on_the_card_flash_against_einsum():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from passl_tpu_torch.nn.init import init_module

    x = torch.from_numpy(_images(4, seed=6)).cuda()
    out = {}
    for impl in ("einsum", "flash"):
        m = port_deit.DistilledVisionTransformer(**TINY, attn_impl=impl)
        init_module(m, torch.Generator().manual_seed(0))
        flash_attention.launches = 0
        with torch.inference_mode():
            out[impl] = m.cuda().eval()(x).float().cpu()
        assert flash_attention.launches == (TINY["depth"] if impl == "flash" else 0)
    torch.testing.assert_close(out["flash"], out["einsum"], rtol=1e-4, atol=1e-4)
