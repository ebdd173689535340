"""Fast-MoCo of the PyTorch port against the JAX package.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, 16 x 16 images in 2 x 2 patches of 8 x 8): `split_patches` and
`combine_embeddings` bitwise for s = 2 with r = 1, 2 and for s = 3 with
r = 2, and for s = 2 with r = 3 within f32's rounding of the three products
and their sum; the labels' order (`jnp.repeat`, not a tile); FastMoCo's loss, `acc1`,
gradients and both towers' statistics from a converted init; and the slice
as a whole: the tiny FastMoCo of configs/moco/fastmoco_r18_synthetic.yaml
takes each of the JAX engine's first 3 steps from JAX's state on the JAX
loader's batch; the learning check's extract step into the probe's model. A
census builds every FastMoCo config's model on the meta device. A test
marked `cuda` trains the tiny FastMoCo on the card and skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.fastmoco import (FastMoCo, combine_embeddings, query_labels,
                                             split_patches)
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_densecl import _drawn_variables
from test_torch_mocobyol import _buffers, _force, _port_buffers, _to_f64
from test_torch_moco import _assert_grads_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "moco", "fastmoco_r18_synthetic.yaml")
# f32 against XLA's: the same f32 math summed in another order
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """The port's tiny CPU steps on one OpenMP thread, put back after: beside
    the test runner's other workers, OpenMP's barriers over a thread a core
    cost more than the tiny convolutions they split. Through threadpoolctl,
    not `torch.set_num_threads`, which also turns MKL's dynamic threading off
    for the rest of the worker and so moves the rounding of later files'
    products (ROADMAP.md, Queue 3)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # a speed setting only; the card's tests run without it
        yield
        return
    with threadpool_limits(1, user_api="openmp"):
        yield


@pytest.mark.parametrize("s, r", [(2, 1), (2, 2), (2, 3), (3, 2)])
def test_patches_and_combinations_match_jax(s, r):
    """The patches (a reshape and a transpose) equal JAX's bit for bit, and so
    do their subset means (the {0, 1/r} selection product in f32) where each
    mean sums at most two nonzero terms. The means of three terms round in the
    order each library's product sums them: each side rounds three products
    and two sums, each by at most half an f32 ulp of the terms' absolute sum,
    so the two agree within 3 ulps of it (1.0 at most over 6 seeds)."""
    import jax.numpy as jnp

    from passl_tpu.models import fastmoco as jax_fastmoco

    rng = np.random.RandomState(10 * s + r)
    x = rng.randn(3, 6 * s, 4 * s, 2).astype(np.float32)
    got = split_patches(torch.from_numpy(x), s).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_fastmoco.split_patches(jnp.asarray(x), s)))
    assert got.shape == (3 * s * s, 6, 4, 2)
    np.testing.assert_array_equal(got[s + 1], x[0, 6:12, 4:8])  # image 0, row 1, column 1
    z = rng.randn(5 * s * s, 7).astype(np.float32)
    got = combine_embeddings(torch.from_numpy(z), s * s, r).numpy()
    want = np.asarray(jax_fastmoco.combine_embeddings(jnp.asarray(z), s * s, r))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if r == 3:
        sel = np.abs(np.asarray(combine_embeddings(torch.eye(s * s), s * s, r)))
        mag = np.einsum("ks,nsd->nkd", sel, np.abs(z).reshape(5, s * s, -1)).reshape(got.shape)
        assert np.all(np.abs(got - want) <= 3 * np.finfo(np.float32).eps * mag)
    else:
        np.testing.assert_array_equal(got, want)


def test_labels_repeat_each_key_for_its_queries():
    np.testing.assert_array_equal(query_labels(3, 4).numpy(), np.repeat(np.arange(3), 4))
    assert not np.array_equal(query_labels(3, 4).numpy(), np.tile(np.arange(3), 4))


def _tiny_kw() -> dict:
    return dict(backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1],
                          "num_classes": 0, "with_pool": False, "cifar_stem": True},
                neck={"name": "NonLinearNeckV2", "hid_channels": 32, "out_channels": 16},
                predictor={"name": "NonLinearNeckV2", "hid_channels": 32, "out_channels": 16,
                           "with_avg_pool": False},
                divide=2, combine_r=2, T=0.5, base_momentum=0.99)


def test_fastmoco_loss_acc_gradients_and_statistics_match_jax():
    """One train-mode forward and backward of 6 pairs of 16 x 16 views (36
    queries of each view against 6 keys) from a converted init, the target
    randomized apart from the online tower: the loss (2 T times the
    cross-entropy, both view orders), acc1, every online and predictor
    gradient (the target takes none), and every BatchNorm's statistics
    (the patches one batch, the whole views another). On PyTorch's own
    convolutions: oneDNN's f32 ones round coarser (the stem's gradient at a
    cosine of 0.99997 to JAX's)."""
    import jax

    from passl_tpu.models.fastmoco import FastMoCo as JaxFastMoCo

    rng = np.random.RandomState(4)
    x1 = rng.randn(6, 16, 16, 3).astype(np.float32)
    x2 = (x1 + 0.5 * rng.randn(6, 16, 16, 3)).astype(np.float32)
    jm = JaxFastMoCo(**_tiny_kw())
    variables = _drawn_variables(jm, 6, (x1, x2))
    params, state = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        out, mut = jm.apply({"params": p, **state}, (x1, x2), train=True, mutable=["batch_stats"])
        return out["loss"], (out, mut)

    (_, (want, mut)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm = FastMoCo(**_tiny_kw())
    pm.load_state_dict(flax_to_torch(params, pm, state["batch_stats"]))
    pm.train()
    with torch.backends.mkldnn.flags(enabled=False):
        got = pm((torch.from_numpy(x1), torch.from_numpy(x2)))
    assert set(got) == {"loss", "acc1"}
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=F32_TOL)
    # the share of 36 hits: JAX's mean multiplies by 1/36, one f32 rounding apart
    np.testing.assert_allclose(got["acc1"].item(), float(want["acc1"]), rtol=2e-7)
    with torch.backends.mkldnn.flags(enabled=False):
        got["loss"].backward()
    want_g = dict(_torch_name(k, a) for k, a in _flatten(jax.device_get(grads)).items())
    for name, p in pm.named_parameters():
        if name.startswith("target."):
            assert p.grad is None and not np.any(want_g[name]), name
        else:
            _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    want_state = flax_to_torch(params, pm, jax.device_get(mut["batch_stats"]))
    for key, v in want_state.items():
        if "running" in key:
            np.testing.assert_allclose(pm.state_dict()[key].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_fastmoco_hooks():
    m = init_module(FastMoCo(**_tiny_kw()), torch.Generator().manual_seed(0))
    assert m.ema_map() == [("online", "target", {"momentum": 0.99, "schedule": "cosine"})]
    assert m.frozen_patterns() == [r"^target\."]
    assert not any(n.startswith("target.predictor") for n, _ in m.named_parameters())
    m.target.load_state_dict(m.online.state_dict())
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    out = m.eval()((x, x))
    assert set(out) == {"loss", "acc1"} and torch.isfinite(out["loss"])


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'NonLinearNeckV2', 'hid_channels': 64, 'out_channels': 32}",
    "Model.predictor={'name': 'NonLinearNeckV2', 'hid_channels': 64, 'out_channels': 32, "
    "'with_avg_pool': False}",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
    "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, "
    "{'ColorJitter': {'brightness': 0.4, 'contrast': 0.4, 'saturation': 0.4, 'hue': 0.4, "
    "'prob': 0.8}}, {'RandomGrayscale': {'p': 0.2}}, "
    "{'SimCLRGaussianBlur': {'sigma': [0.1, 2.0], 'p': 0.5}}, {'RandFlipImage': {'prob': 0.5}}, "
    "{'NormalizeImage': {'scale': 0.00392157, 'mean': [0.485, 0.456, 0.406], "
    "'std': [0.229, 0.224, 0.225]}}]}}]",
    "DataLoader.Train.sampler.batch_size=8",
]
PARITY = [*TINY, "FP16.enable=False"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 3 loader batches, its metrics on them, and its
    state (parameters, statistics, momentum buffers) before each of its 3
    train steps and after the last, in the port's names and layouts."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))

    def port_state(state):
        state = jax.device_get(state)
        return (flax_to_torch(state.params, port, state.model_state["batch_stats"]),
                _port_buffers(state.opt_state))

    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == 3:
            break
    metrics, states = [], [port_state(je.state)]
    for b in batches:
        je.state, m = je.train_step(je.state, je.shard_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(port_state(je.state))
    je.train_dataloader.close()
    return batches, metrics, states


def test_tiny_fastmoco_steps_along_the_jax_engine(tmp_path, jax_run):
    """Each of the JAX engine's 3 train steps (the target's cosine EMA from
    0.99), from JAX's state before it: the metrics, and every parameter,
    statistic and momentum buffer after it, by the rule of
    test_torch_mocobyol.py (each tensor's change within 1e-3 of its norm,
    beside 8 f32 roundings of the tensor and the f32 resolution of the change,
    the port's f32 step from its f64 step, counted for each side)."""
    batches, jax_metrics, states = jax_run
    engines = [Engine(_config(tmp_path / name, *PARITY), mode="train", device="cpu")
               for name in ("f32", "f64")]
    e, e64 = engines
    _to_f64(e64.model)
    eps32 = float(np.finfo(np.float32).eps)
    with torch.backends.mkldnn.flags(enabled=False):
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            for x in engines:
                _force(x, states[t], t)
            got = {k: float(v) for k, v in
                   e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
            got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
            assert set(got) == set(want) and {"loss", "acc1"} <= set(got)
            f32_res = abs(got["loss"] - float(got64["loss"]))
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + f32_res, t
            np.testing.assert_allclose(got["acc1"], want["acc1"], rtol=2e-7)  # as above
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
            before, (after, bufs_after) = states[t][0], states[t + 1]
            final, final64 = e.model.state_dict(), e64.model.state_dict()
            assert set(final) == set(after)
            for name, p in final.items():
                d_port, d_jax = p - before[name], after[name] - before[name]
                f32_res = (d_port.double() - (final64[name] - before[name].double())).norm().item()
                tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + 2 * f32_res
                assert (d_port - d_jax).norm().item() <= tol, (t, name)
            bufs, bufs64 = (_buffers(x) for x in engines)
            assert set(bufs) == set(bufs_after)
            assert not any(n.startswith("target.") for n in bufs_after)  # frozen: no state
            for name, buf in bufs_after.items():
                f32_res = (bufs[name].double() - bufs64[name].double()).norm().item()
                tol = 1e-3 * buf.norm().item() + 1e-8 + 2 * f32_res
                assert (bufs[name] - buf).norm().item() <= tol, (t, name)
    for x in engines:
        x.close()


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "moco", "fastmoco_*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "fastmoco_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_fastmoco_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == "FastMoCo"
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_weights_fills_the_structured_probe(tmp_path):
    """The learning check's extract step: the backbone of
    tests/e2e/fastmoco_structured.yaml's model under `online.backbone` fills
    every backbone entry of tests/e2e/probe_structured.yaml's model."""
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "fastmoco_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "online.backbone",
                                   "--rename", "backbone", "--output",
                                   str(tmp_path / "backbone.pt"), "--check-config",
                                   os.path.join(REPO, "tests", "e2e", "probe_structured.yaml")])
    want = model.get_submodule("online.backbone").state_dict()
    assert set(picked) == {f"backbone.{k}" for k in want}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_fastmoco_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) and 0 <= h["acc1"] <= 1 for h in e.train_loop.history] == [
        True, True]
