"""MoCo v3 of the PyTorch port (passl_tpu_torch/models/mocov3.py) against the
JAX package.

On the CPU, at tiny sizes (a ViT of 2 blocks over 32 x 32 images in 4 x 4
patches, 65 tokens, so the flash path runs; heads of 64 wide): the fixed
sin-cos table bitwise; the encoder's features on the einsum and flash paths;
two train-mode forwards and backwards from a converted init (the momentum
tower's predictor, which flax never initialises, filled from the base
tower's as the JAX engine fills it, and no other gap filled): the loss,
`acc1`, the base tower's gradients, the stop-gradient of the patch
embedding and every BatchNorm statistic (the affine-free last ones
included); the keys taken without the
momentum predictor; the init (patch embedding range, class token scale, no
qkv rule of its own); the linear probe; and the slice as a whole: each of
the JAX engine's first 4 steps of configs/mocov3/mocov3_tiny_synthetic.yaml
taken from JAX's state, the EMA moving the inert momentum predictor. Every
MoCo v3 config builds on the meta device; the learning check's extract
fills the probe. A test marked `cuda` trains the tiny MoCo v3 on the card.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import mocov3 as port_mocov3
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_deit import (_adamw_moments, assert_step_tracks, jax_flash,  # noqa: F401
                             jax_states)
from test_torch_moco import _assert_grads_agree, _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "mocov3", "mocov3_tiny_synthetic.yaml")
ENC = dict(img_size=32, patch_size=4, embed_dim=64, depth=2, num_heads=1, stop_grad_conv1=True)
KW = dict(encoder=ENC, dim=16, mlp_dim=32, T=0.2, base_momentum=0.99)
F32_TOL = 1e-5


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


def _views(n, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(n, 32, 32, 3).astype(np.float32)
    return x1, (x1 + 0.5 * rng.randn(n, 32, 32, 3)).astype(np.float32)


def _jax_variables(jm, seed):
    """The flax model's variables, drawn with numpy from their shapes."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((4, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), (x, x)))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def _port_state(model, variables) -> dict:
    return flax_to_torch(variables["params"], model, variables["batch_stats"])


def test_the_fixed_table_is_the_jax_one_bitwise():
    from passl_tpu.models.utils.pos_embed import mocov3_2d_sincos_pos_embed as jax_table

    for dim, h, w in ((64, 8, 8), (768, 14, 14), (96, 8, 8), (1024, 24, 24)):
        want = jax_table(dim, h, w)
        got = port_mocov3.MoCoV3ViT(img_size=16 * h, patch_size=16, embed_dim=dim, depth=0,
                                    num_heads=1).pos_embed.array
        assert got.dtype == want.dtype == np.float32 and got.shape == (1, h * w + 1, dim)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_encoder_features_match_jax(impl, request):
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mocov3 import MoCoV3ViT as JaxViT

    if impl == "flash":
        request.getfixturevalue("jax_flash")
    jm = JaxViT(**{**ENC, "num_heads": 2}, attn_impl=impl)
    x = _views(3, 0)[0]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 1)
    pm = port_mocov3.MoCoV3ViT(**{**ENC, "num_heads": 2}, attn_impl=impl).eval()
    pm.load_state_dict(flax_to_torch(params, pm))
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x, train=False))(
        params, jnp.asarray(x)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    assert got.shape == (3, 64) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _jax_steps(steps=2):
    """JAX MoCo v3's train-mode steps of 8 pairs from one randomized init: per
    step the views, loss, acc1, gradients and the variables after it."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mocov3 import MoCoV3Pretrain as JaxMoCoV3

    jm = JaxMoCoV3(**KW)
    variables = _jax_variables(jm, 2)
    assert "predictor" not in variables["params"]["momentum"]  # flax never ran it
    params, state = variables["params"], {"batch_stats": variables["batch_stats"]}

    @jax.jit
    def step(params, state, x1, x2):
        def loss(p):
            out, mut = jm.apply({"params": p, **state}, (x1, x2), train=True,
                                mutable=["batch_stats"])
            return out["loss"], (out, mut)

        return jax.value_and_grad(loss, has_aux=True)(params)

    out = []
    for t in range(steps):
        x1, x2 = _views(8, 10 + t)
        (_, (metrics, mut)), grads = step(params, state, x1, x2)
        state = jax.device_get(dict(mut))
        out.append(dict(x=(x1, x2), metrics=jax.device_get(metrics), grads=jax.device_get(grads),
                        after={"params": params, **state}))
    return variables, out


@pytest.fixture(scope="module")
def jax_steps():
    return _jax_steps()


def test_mocov3_steps_match_jax(jax_steps):
    """Two train-mode forwards and backwards of 8 pairs: loss and acc1, the base
    tower's gradients (the patch embedding's zero on both sides: stop_grad_conv1),
    no gradient into the momentum tower, and every BatchNorm statistic after
    each step (the base head's and predictor's twice a step, the momentum
    head's twice, the momentum predictor's never)."""
    variables, steps = jax_steps
    pm = port_mocov3.MoCoV3Pretrain(**KW)
    pm.load_state_dict(_port_state(pm, variables))
    pm.train()
    inert = {k: v.clone() for k, v in pm.state_dict().items()
             if k.startswith("momentum.predictor.")}
    for t, s in enumerate(steps):
        for p in pm.parameters():
            p.grad = None
        got = pm(tuple(torch.from_numpy(v) for v in s["x"]))
        assert set(got) == {"loss", "acc1"}
        np.testing.assert_allclose(got["loss"].item(), float(s["metrics"]["loss"]), rtol=F32_TOL)
        assert got["acc1"].item() == float(s["metrics"]["acc1"])
        got["loss"].backward()
        want_g = dict(_torch_name(p, a) for p, a in _flatten(s["grads"]).items())
        for name, p in pm.named_parameters():
            if name.startswith("momentum."):
                assert p.grad is None, name
                assert name.startswith("momentum.predictor.") or not np.any(want_g[name]), name
            elif name.startswith("base.encoder.patch_embed."):
                assert p.grad is None and not np.any(want_g[name]), name
            else:
                _assert_grads_agree(p.grad.numpy(), want_g[name], name)
        want_state = _port_state(pm, s["after"])
        stats = [k for k in want_state if "running" in k]
        assert len(stats) == 4 * 5  # two towers, 5 BatchNorms each (3 head, 2 predictor)
        for key in stats:
            if key.startswith("momentum.predictor."):
                continue  # JAX has none: the converter fills them from the base tower's
            np.testing.assert_allclose(pm.state_dict()[key].numpy(), want_state[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    for k, v in inert.items():  # the keys skip the momentum predictor
        assert torch.equal(pm.state_dict()[k], v), k


def test_keys_do_not_run_the_momentum_predictor():
    m = init_module(port_mocov3.MoCoV3Pretrain(**KW), torch.Generator().manual_seed(0)).train()
    x = tuple(torch.from_numpy(v) for v in _views(4, 3))
    state = {k: v.clone() for k, v in m.state_dict().items()}
    a = m(x)
    with torch.no_grad():
        for p in m.momentum.predictor.parameters():
            p.mul_(-3.0)
    m.load_state_dict({**m.state_dict(), **{k: v for k, v in state.items() if "running" in k}})
    b = m(x)
    assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["acc1"], b["acc1"])
    assert 0.0 <= a["acc1"].item() <= 1.0


def test_the_last_batchnorms_have_no_scale_or_bias():
    m = port_mocov3.MoCoV3Pretrain(**KW)
    for tower in (m.base, m.momentum):
        assert tower.head.bn2.weight is None and tower.head.bn2.bias is None
        assert tower.predictor.bn1.weight is None and tower.predictor.bn1.bias is None
        assert tower.head.bn0.weight is not None and tower.predictor.bn0.bias is not None
        assert all(getattr(tower.head, f"fc{i}").bias is None for i in range(3))
        assert tower.head.bn0.momentum == 0.9 and tower.head.bn0.epsilon == 1e-5


def test_init_follows_the_jax_code():
    """Patch embedding uniform in +-sqrt(6 / (3 p^2 + D)); class token of std
    1e-6; the blocks' qkv takes Block's default xavier-uniform over the fused
    [3D, D] kernel (the JAX file's `_mocov3_qkv_init` is never called)."""
    enc = dict(img_size=224, patch_size=16, embed_dim=384, depth=1, num_heads=6)
    m = init_module(port_mocov3.MoCoV3ViT(**enc), torch.Generator().manual_seed(0))
    val = (6.0 / (3 * 16 * 16 + 384)) ** 0.5
    w = m.patch_embed.proj.weight
    assert w.abs().max().item() <= val and w.abs().max().item() > 0.99 * val
    assert abs(w.std().item() - val / 3 ** 0.5) < 0.02 * val
    assert 0.5e-6 < m.cls_token.std().item() < 2e-6
    qkv = m.blocks[0].attn.qkv.weight
    xavier = (6.0 / (384 + 3 * 384)) ** 0.5
    assert qkv.abs().max().item() <= xavier and qkv.abs().max().item() > 0.99 * xavier
    assert not m.patch_embed.proj.bias.any()


def test_converter_fills_the_momentum_predictor_from_the_base_tower(jax_steps):
    variables, _ = jax_steps
    pm = port_mocov3.MoCoV3Pretrain(**KW)
    state = _port_state(pm, variables)
    filled = [k for k in state if k.startswith("momentum.predictor.")]
    assert len(filled) == 2 + 4 + 2  # fc0, fc1; bn0 (2 params, 2 stats); bn1's stats
    for k in filled:
        assert torch.equal(state[k], state["base" + k[len("momentum"):]]), k


@pytest.mark.parametrize("tower, module", [("momentum", "head"), ("momentum", "encoder"),
                                           ("base", "predictor")])
def test_the_converter_fills_nothing_else(jax_steps, tower, module):
    """A leaf the flax variables lack outside the momentum predictor raises: a
    target taken mid-training short of a leaf loads no online weight in its place."""
    variables, _ = jax_steps
    params = {k: dict(v) for k, v in variables["params"].items()}
    sub = dict(params[tower][module])
    del sub[sorted(sub)[0]]
    params[tower][module] = sub
    pm = port_mocov3.MoCoV3Pretrain(**KW)
    with pytest.raises(KeyError, match=f"no flax leaf fills \\['{tower}\\.{module}\\."):
        flax_to_torch(params, pm, variables["batch_stats"])


def test_moe_encoders_stay_refused(tmp_path):
    """A V-MoE encoder builds (tests/test_torch_mocov3_moe.py holds it against
    JAX); its recipe stays refused at its sharding degree: expert parallelism
    is not ported."""
    path = os.path.join(REPO, "configs", "mocov3", "mocov3_vmoe_base_in1k.yaml")
    config = cfg_util.get_config(path, overrides=[f"Global.output_dir={tmp_path}"], show=False)
    with pytest.raises(NotImplementedError, match="sharding"):
        Engine(config, mode="train", device="cpu")
    assert config["DistributedStrategy"]["sharding"]["degree"] == 4


def test_linear_probe_matches_jax():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.mocov3 import MoCoV3LinearProbe as JaxProbe

    enc = {**ENC, "patch_size": 8}
    jm = JaxProbe(encoder=enc, num_classes=5)
    x = _views(3, 4)[0]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 5)
    pm = port_mocov3.MoCoV3LinearProbe(encoder=enc, num_classes=5).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    assert not pm.encoder.training  # run in eval whatever the model's mode
    w = np.random.RandomState(6).randn(3, 5).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=True) * w)

    want, grads = jax.value_and_grad(loss)(params)
    got = (pm(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_g = dict(_torch_name(p, a) for p, a in _flatten(jax.device_get(grads)).items())
    for name, p in pm.named_parameters():
        if name.startswith("encoder."):
            assert p.grad is None and not np.any(want_g[name]), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=1e-5, atol=1e-6)
    assert pm.frozen_patterns() == [r"^encoder\."]
    init_module(pm, torch.Generator().manual_seed(0))
    assert abs(pm.head.weight.std().item() - 0.01) < 0.003 and not pm.head.bias.any()


# ----------------------------------------------------- the slice as a whole

PARITY = ["FP16.enable=False", "DataLoader.Train.sampler.batch_size=16"]
STEPS = 4


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 4 loader batches (16 pairs each), its metrics,
    and its state before each step and after the last: parameters (the
    momentum predictor copied in by the JAX engine), statistics and AdamW
    moments."""
    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))
    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    assert "predictor" in je.state.params["momentum"]
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == STEPS:
            break

    def convert(model, state):
        return (flax_to_torch(state.params, model, state.model_state["batch_stats"]),
                _adamw_moments(state.opt_state))

    metrics, states = jax_states(je, batches, port, convert)
    je.train_dataloader.close()
    return batches, metrics, states


def _rounding_alone(name: str) -> bool:
    """Entries the step does not decide: the momentum predictor's statistics,
    which JAX keeps none of, and the encoder's last LayerNorm bias, which shifts
    every sample's features alike before the bias-free fc0 and the head's
    first BatchNorm, which cancels the shift: its gradient is f32 rounding on
    both sides (0 in f64), and AdamW scales that rounding up to the lr."""
    return (name.startswith("momentum.predictor.bn") and "running" in name) or \
        name.endswith("encoder.norm.bias")


def test_tiny_mocov3_steps_along_the_jax_engine(tmp_path, jax_run):
    """Each of the JAX engine's 4 steps from JAX's state: loss, acc1, lr, every
    parameter's change (the momentum tower's by the EMA, its inert predictor
    included), the AdamW moments (none on the momentum tower) and every
    statistic but the momentum predictor's (JAX keeps none)."""
    batches, jax_metrics, states = jax_run
    e = Engine(_config(tmp_path, *PARITY), mode="train", device="cpu")
    assert e.train_step.ema_pairs and len(e.train_step.ema_pairs[0][0]) == \
        len(list(e.model.momentum.parameters()))
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert {"loss", "acc1"} <= set(want)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t, skip=_rounding_alone)
        state = e.optimizer.torch_optimizer.state
        assert not any(p in state for p in e.model.momentum.parameters())
        # the inert predictor followed the base tower's by the EMA
        m = e.train_step.ema_pairs[0][2](t)
        after = states[t + 1][0]
        for name, p in e.model.momentum.predictor.named_parameters():
            want_p = m * states[t][0][f"momentum.predictor.{name}"] \
                + (1 - m) * after[f"base.predictor.{name}"]
            torch.testing.assert_close(p.detach(), want_p, rtol=1e-5, atol=1e-7)
    e.close()


# ------------------------------------------------------------------ census

CENSUS = sorted(p for p in glob.glob(os.path.join(REPO, "configs", "mocov3", "*.yaml"))
                if "vmoe" not in p) + [
    os.path.join(REPO, "tests", "e2e", n) for n in ("mocov3_structured.yaml",
                                                    "probe_mocov3_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_mocov3_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_weights_fills_the_structured_probe(tmp_path):
    """The learning check's extract step: `base.encoder` of
    tests/e2e/mocov3_structured.yaml's model, re-rooted under `encoder`, fills
    every encoder entry of tests/e2e/probe_mocov3_structured.yaml's model."""
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "mocov3_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main([
        "--checkpoint", ckpt, "--prefix", "base.encoder", "--rename", "encoder", "--output",
        str(tmp_path / "encoder.pt"), "--check-config",
        os.path.join(REPO, "tests", "e2e", "probe_mocov3_structured.yaml")])
    assert set(picked) == {f"encoder.{k}" for k in model.base.encoder.state_dict()}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_mocov3_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, "Global.max_train_step=2", "Global.print_batch_step=1",
                       "Model.encoder.patch_size=4", "Model.encoder.attn_impl=flash"),
               mode="train", device="cuda")
    from passl_tpu_torch.ops.attention import flash_attention

    flash_attention.launches = 0
    e.train()
    hist = e.train_loop.history
    assert [np.isfinite(h["loss"]) for h in hist] == [True, True]
    assert flash_attention.launches == 2 * 4 * 2  # 2 steps, 4 encoder passes, 2 blocks
