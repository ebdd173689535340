"""SimCLR of the PyTorch port against the JAX package.

On the CPU, at tiny sizes: `nt_xent_co2_loss` (value, `acc1` and the
gradients of both inputs, CO2 weight 0 and 3); `NonLinearNeckfc3` in
training and eval with its BatchNorm statistics; SimCLR's device
augmentation cores fed the draws JAX made, recomputed here from the same
`jax.random` splits (every jitter op alone and all together, a strength of
0, grayscale, and the whole `simclr_device_augment` on square and
non-square uint8 views); the tiny SimCLR's loss, `acc1` and gradients from a
converted init; and the slice as a whole: the tiny SimCLR of
configs/simclr/simclr_r18_synthetic.yaml (16 x 16 images, batch 8, f32, no
device augmentation) tracks the JAX engine for 4 steps from the converted
init on the JAX loader's batches. A test marked `cuda` trains the tiny
SimCLR with the device augmentation on the card and skips elsewhere.
"""
import math
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.necks import NonLinearNeckfc3
from passl_tpu_torch.models.simclr import SimCLR, nt_xent_co2_loss
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.ops import augment as paug
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "simclr", "simclr_r18_synthetic.yaml")
# f32 forward against XLA's: the same f32 math summed in another order
F32_TOL = 1e-5


def _randomize(tree, seed):
    """Every flax leaf redrawn with numpy at a scale where each part shows."""
    import jax

    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if "'var'" in name:
            return 0.5 + rng.rand(*shape)
        return 0.2 * rng.randn(*shape)

    return jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(draw(p, x), np.float32), tree)


def _port_grads(grads) -> dict:
    return dict(_torch_name(path, arr) for path, arr in _flatten(grads).items())


def _assert_grads_agree(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """Within atol 1e-6, or at cosine >= 0.99999 where the tensor is large."""
    if np.allclose(got, want, rtol=0, atol=1e-6):
        return
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    assert cos >= 0.99999, f"{name}: cosine {cos}, max diff {np.abs(got - want).max()}"


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("co2_weight", [0.0, 3.0])
def test_nt_xent_co2_loss_and_its_gradients_match_jax(co2_weight):
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.simclr import nt_xent_co2_loss as jax_loss

    rng = np.random.RandomState(1)
    h1 = rng.randn(8, 16).astype(np.float32)
    h2 = (h1 + 3.0 * rng.randn(8, 16)).astype(np.float32)  # positives ahead for some rows

    def loss(a, b):
        out = jax_loss(a, b, 0.5, co2_weight)
        return out["loss"], out["acc1"]

    (want, want_acc), (ga, gb) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h1), jnp.asarray(h2))
    t1, t2 = torch.from_numpy(h1).requires_grad_(), torch.from_numpy(h2).requires_grad_()
    got = nt_xent_co2_loss(t1, t2, 0.5, co2_weight)
    assert got["loss"].dtype == got["acc1"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=F32_TOL)
    assert got["acc1"].item() == float(want_acc) and 0.0 < float(want_acc) < 1.0
    got["loss"].backward()
    _assert_grads_agree(t1.grad.numpy(), np.asarray(ga), "h1")
    _assert_grads_agree(t2.grad.numpy(), np.asarray(gb), "h2")


def test_nt_xent_takes_bf16_features_in_f32():
    h = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    got = nt_xent_co2_loss(h.bfloat16(), (h + 0.1).bfloat16())
    want = nt_xent_co2_loss(h.bfloat16().float(), (h + 0.1).bfloat16().float())
    assert got["loss"].dtype == torch.float32 and torch.equal(got["loss"], want["loss"])


# ------------------------------------------------------------------ neck


def test_nonlinear_neck_fc3_matches_jax_in_training_and_eval():
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.necks as jax_necks

    x = np.random.RandomState(6).randn(6, 3, 3, 16).astype(np.float32)
    jm = jax_necks.NonLinearNeckfc3(hid_channels=32, out_channels=8)
    pm = NonLinearNeckfc3(16, 32, 8)
    variables = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 7)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    assert all(pm.get_submodule(f"fc{i}").bias is None for i in (1, 2, 3))
    assert all(pm.get_submodule(f"bn{i}").weight is not None for i in (1, 2, 3))
    w = np.random.RandomState(8).randn(6, 8).astype(np.float32)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    got = pm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = _port_grads(jax.device_get(grads))
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    want_eval = jm.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
                         train=False)
    with torch.no_grad():
        got_eval = pm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------- augmentation


def _images(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _jax_jitter_draws(rng, n, brightness, contrast, saturation, hue, prob) -> dict:
    """The draws `passl_tpu/ops/augment.py color_jitter` makes from `rng`."""
    import jax

    kb, kc, ks, kh, kp = jax.random.split(rng, 5)
    out = {}
    for name, key, s in (("brightness", kb, brightness), ("contrast", kc, contrast),
                         ("saturation", ks, saturation)):
        if s > 0:
            out[name] = jax.random.uniform(key, (n, 1, 1, 1), minval=max(0, 1 - s),
                                           maxval=1 + s).reshape(n)
    if hue > 0:
        out["hue"] = jax.random.uniform(kh, (n, 1, 1), minval=-hue * math.pi,
                                        maxval=hue * math.pi).reshape(n)
    out["apply"] = jax.random.bernoulli(kp, prob, (n, 1, 1, 1)).reshape(n)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _jax_simclr_draws(rng, n, s) -> list:
    """The draws of `passl_tpu/ops/augment.py simclr_device_augment` per view."""
    import jax

    views = []
    for i in range(2):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(rng, i), 3)
        kb1, kb2 = jax.random.split(k3)
        views.append({
            "jitter": _jax_jitter_draws(k1, n, 0.8 * s, 0.8 * s, 0.8 * s, 0.2 * s, 0.8),
            "gray": torch.from_numpy(np.asarray(jax.random.bernoulli(k2, 0.2, (n, 1, 1, 1))
                                                .reshape(n))),
            "sigma": torch.from_numpy(np.asarray(jax.random.uniform(kb1, (n,), minval=0.1,
                                                                    maxval=2.0))),
            "blur": torch.from_numpy(np.asarray(jax.random.bernoulli(kb2, 0.5, (n, 1, 1, 1))
                                                .reshape(n))),
        })
    return views


JITTER_CASES = {
    "all": (0.4, 0.4, 0.4, 0.1, 0.8),
    "brightness": (0.6, 0.0, 0.0, 0.0, 1.0),
    "contrast": (0.0, 0.6, 0.0, 0.0, 1.0),
    "saturation": (0.0, 0.0, 0.6, 0.0, 1.0),
    "hue": (0.0, 0.0, 0.0, 0.4, 1.0),
    "saturation-0": (0.3, 0.3, 0.0, 0.05, 0.5),  # tests/e2e/simclr_digits.yaml's strengths
    "none": (0.0, 0.0, 0.0, 0.0, 0.8),
}


@pytest.mark.parametrize("case", list(JITTER_CASES))
def test_color_jitter_core_matches_jax_on_its_draws(case):
    import jax
    import jax.numpy as jnp

    from passl_tpu.ops import augment as jaug

    b, c, s, h, prob = JITTER_CASES[case]
    n = 12
    x = np.random.RandomState(3).rand(n, 7, 9, 3).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jaug.color_jitter(jnp.asarray(x), rng, brightness=b, contrast=c,
                                        saturation=s, hue=h, prob=prob))
    draws = _jax_jitter_draws(rng, n, b, c, s, h, prob)
    # a strength of 0 draws no factor, in JAX and in the port
    assert set(draws) == {k for k, v in zip(("brightness", "contrast", "saturation", "hue"),
                                            (b, c, s, h)) if v > 0} | {"apply"}
    port_draws = paug.color_jitter_draws(n, torch.Generator().manual_seed(0), torch.device("cpu"),
                                         b, c, s, h, prob)
    assert set(port_draws) == set(draws)
    if prob < 1.0:
        assert draws["apply"].any() and not draws["apply"].all()
    got = paug.color_jitter_core(torch.from_numpy(x), draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    if case == "none":  # nothing but the clip where the coin is set
        np.testing.assert_array_equal(got.numpy(), x)


def test_grayscale_matches_jax_on_its_draws():
    import jax
    import jax.numpy as jnp

    from passl_tpu.ops import augment as jaug

    x = np.random.RandomState(4).rand(10, 5, 6, 3).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jaug.random_grayscale(jnp.asarray(x), rng, prob=0.5))
    mask = torch.from_numpy(np.asarray(jax.random.bernoulli(rng, 0.5, (10, 1, 1, 1))).reshape(10))
    assert mask.any() and not mask.all()
    got = paug.grayscale_where(torch.from_numpy(x), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(paug.rgb_to_grayscale(torch.from_numpy(x)).numpy(),
                               np.asarray(jaug.rgb_to_grayscale(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    gen = torch.Generator().manual_seed(0)  # the random op: one coin an image, then the core
    coins = torch.rand(10, generator=torch.Generator().manual_seed(0)) < 0.5
    torch.testing.assert_close(paug.random_grayscale(torch.from_numpy(x), gen, prob=0.5),
                               paug.grayscale_where(torch.from_numpy(x), coins), rtol=0, atol=0)


@pytest.mark.parametrize("shape, strength", [((8, 12, 12, 3), 1.0), ((8, 10, 14, 3), 0.5)],
                         ids=["square", "non-square"])
def test_simclr_device_augment_core_matches_jax_on_its_draws(shape, strength):
    import jax
    import jax.numpy as jnp

    from passl_tpu.ops import augment as jaug

    v1, v2 = _images(shape, seed=1), _images(shape, seed=2)
    rng = jax.random.PRNGKey(3)
    w1, w2 = (np.asarray(a) for a in jaug.simclr_device_augment(
        jnp.asarray(v1), jnp.asarray(v2), rng, jitter_strength=strength))
    draws = _jax_simclr_draws(rng, shape[0], strength)
    for d in draws:  # the coins come up both ways
        assert d["blur"].any() != d["blur"].all() or d["gray"].any() != d["gray"].all()
    g1, g2 = paug.simclr_device_augment_core(torch.from_numpy(v1), torch.from_numpy(v2), draws)
    assert g1.dtype == g2.dtype == torch.float32 and tuple(g1.shape) == shape
    np.testing.assert_allclose(g1.numpy(), w1, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(g2.numpy(), w2, rtol=F32_TOL, atol=F32_TOL)


def test_simclr_device_augment_draws_each_view_from_the_generator():
    v = torch.from_numpy(_images((6, 8, 8, 3), seed=4))
    a = paug.simclr_device_augment(v, v, torch.Generator().manual_seed(1), jitter_strength=1.0)
    b = paug.simclr_device_augment(v, v, torch.Generator().manual_seed(1), jitter_strength=1.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])  # the same images, each view its own numbers
    draws = paug.simclr_draws(6, torch.Generator().manual_seed(1), v.device, 1.0)
    assert not torch.equal(draws[0]["sigma"], draws[1]["sigma"])
    assert all(torch.equal(x, y) for x, y in zip(a, paug.simclr_device_augment_core(v, v, draws)))


# -------------------------------------------------------------- the model

TINY_MODEL = dict(
    backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1], "num_classes": 0,
              "with_pool": False, "cifar_stem": True},
    neck={"name": "NonLinearNeckfc3", "hid_channels": 32, "out_channels": 16})


def test_tiny_simclr_loss_and_gradients_match_jax():
    """One concatenated backbone pass over both views: the loss, acc1, every
    gradient, and the new BatchNorm statistics from a converted init."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.simclr import SimCLR as JaxSimCLR

    rng = np.random.RandomState(9)
    x1 = rng.randn(8, 16, 16, 3).astype(np.float32)
    x2 = (x1 + 0.5 * rng.randn(8, 16, 16, 3)).astype(np.float32)
    batch = (jnp.asarray(x1), jnp.asarray(x2))
    jm = JaxSimCLR(**TINY_MODEL)
    pm = SimCLR(**TINY_MODEL)
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b))(batch))
    variables = _randomize(variables, 10)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                            train=True, mutable=["batch_stats"])
        return out["loss"], (out["acc1"], mut["batch_stats"])

    (want, (want_acc, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got = pm.train()((torch.from_numpy(x1), torch.from_numpy(x2)))
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=F32_TOL)
    assert got["acc1"].item() == float(want_acc)
    got["loss"].backward()
    want_g = _port_grads(jax.device_get(grads))
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_simclr_device_augment_needs_the_generator():
    pm = init_module(SimCLR(**TINY_MODEL, use_device_augment=True),
                     torch.Generator().manual_seed(0))
    v = torch.from_numpy(_images((4, 16, 16, 3)))
    with pytest.raises(ValueError, match="generator"):
        pm((v, v))
    out = pm((v, v), generator=torch.Generator().manual_seed(0))
    assert set(out) == {"loss", "acc1"} and torch.isfinite(out["loss"])


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'NonLinearNeckfc3', 'hid_channels': 64, 'out_channels': 32}",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.sampler.batch_size=8",
]
# the config's host transforms at 16 x 16 (jitter, grayscale, normalize on the host)
HOST_AUG = ("DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
            "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, "
            "{'RandFlipImage': {'prob': 0.5}}, {'ColorJitter': {'brightness': 0.4, "
            "'contrast': 0.4, 'saturation': 0.4, 'hue': 0.1, 'prob': 0.8}}, "
            "{'RandomGrayscale': {'p': 0.2}}, {'NormalizeImage': {'scale': 0.00392157, "
            "'mean': [0.4914, 0.4822, 0.4465], 'std': [0.2023, 0.1994, 0.2010]}}]}}]")
# uint8 crops for the device augmentation, as simclr_r50_in1k.yaml ships them
DEVICE_AUG = ["Model.use_device_augment=True", "Model.jitter_strength=1.0",
              "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
              "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, "
              "{'RandFlipImage': {'prob': 0.5}}, {'ToCHWImage': {}}]}}]"]
PARITY = [*TINY, HOST_AUG, "FP16.enable=False", "Model.use_device_augment=False"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's init (as a torch state_dict file), its first 4 loader
    batches, and its metrics and state after 4 train steps on them."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))

    def port_state(params, model_state):
        return flax_to_torch(params, port, model_state["batch_stats"])

    init_file = os.path.join(str(tmp), "init.pt")
    torch.save(port_state(*jax.device_get((je.state.params, je.state.model_state))), init_file)
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
    final = port_state(*jax.device_get((je.state.params, je.state.model_state)))
    je.train_dataloader.close()
    return init_file, batches, metrics, final


def _to_f64(model: torch.nn.Module) -> None:
    """Every parameter, buffer and compute dtype of `model` in float64."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64


def test_tiny_simclr_tracks_the_jax_train_step(tmp_path, jax_run):
    init_file, batches, jax_metrics, jax_final = jax_run
    engines = [Engine(_config(tmp_path / name, *PARITY, f"Global.pretrained_model={init_file}"),
                      mode="train", device="cpu") for name in ("f32", "f64")]
    e, e64 = engines
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    _to_f64(e64.model)
    init = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
    for b, want in zip(batches, jax_metrics):
        got = {k: float(v) for k, v in
               e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
        e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
        assert set(got) == set(want) and {"loss", "acc1"} <= set(got)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["acc1"] == want["acc1"]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], atol=1e-6)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert e.state.step == 4
    final, final64 = e.model.state_dict(), e64.model.state_dict()
    assert set(final) == set(jax_final)
    eps32 = float(np.finfo(np.float32).eps)
    for name, p in final.items():
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # test_torch_byol.py's rule: each tensor's change within 1e-3 of its
        # norm, beside 8 f32 roundings of the tensor itself; and beside how far
        # f32 resolves that change at all, the port's f32 run from its f64 run:
        # the stem's BatchNorm biases change by a sum that cancels, which f32
        # resolves to about 0.15% (JAX's jitted step lands 0.19% from the update
        # its own eager gradients give, the port 1e-5)
        f32_res = (d_port.double() - (final64[name] - init[name].double())).norm().item()
        tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + f32_res
        assert (d_port - d_jax).norm().item() <= tol, name
        assert d_jax.abs().max() > 0, name
    for x in engines:
        x.close()


def test_tiny_simclr_trains_through_the_cli_with_device_augmentation(tmp_path):
    from passl_tpu_torch.tools import train

    argv = ["-c", TINY_CFG, "--device", "cpu", "-o", f"Global.output_dir={tmp_path}",
            "-o", "Global.max_train_step=2", "-o", "Global.print_batch_step=1"]
    for o in [*TINY, *DEVICE_AUG]:
        argv += ["-o", o]
    e = train.main(argv)
    hist = e.train_loop.history
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and 0.0 <= h["acc1"] <= 1.0 for h in hist)
    assert e.model.use_device_augment and e.policy.compute_dtype == torch.bfloat16
    assert os.path.exists(os.path.join(str(tmp_path), "latest.pt"))


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_simclr_trains_on_the_card_with_device_augmentation(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, *DEVICE_AUG, "Global.max_train_step=2",
                       "Global.print_batch_step=1"), mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
