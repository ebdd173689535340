"""PixPro of the PyTorch port against the JAX package.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, 32 x 32 images, so a 4 x 4 map): `MLP2d` in train and eval;
`pixpro_regression_loss` on identical crops (-> -2), disjoint ones (-> 0),
flipped boxes (x1 > x2) and random ones, with the cell distances compared
first and the positive masks then exactly; `PixelPropagation` at p 1 and 2
with 1 and 2 transform layers; PixPro's loss, gradients and both towers'
statistics from a converted init; `PixProTwoViewsTransform` through the
port's loader, bitwise the JAX loader's batch dict, and on through
`prepare_batch` and `to_device` as f32 tensors; and the slice as a whole:
the tiny PixPro of configs/pixpro/pixpro_r18_synthetic.yaml takes each of
the JAX engine's first 3 steps (MomentumLARS, the cosine EMA) from JAX's
state on the JAX loader's batch; the learning check's extract step into the
probe's model, and an extracted ResNet-50 PixPro backbone into
configs/pixpro/pixpro_r50_lp_in1k.yaml's probe. A census builds every
PixPro config's model on the meta device. A test marked `cuda` trains the
tiny PixPro on the card and skips elsewhere.
"""
import copy
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import build_dataloader, to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.necks import MLP2d
from passl_tpu_torch.models.pixpro import (PixelPropagation, PixPro, cell_distances,
                                           pixpro_regression_loss)
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_densecl import _drawn_variables
from test_torch_mocobyol import _buffers, _force, _port_buffers, _to_f64
from test_torch_moco import _assert_grads_agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "pixpro", "pixpro_r18_synthetic.yaml")
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


def _boxes(rng, n: int, flip: float = 0.5) -> np.ndarray:
    """n crop boxes (x1, y1, x2, y2) in a 200 x 200 image, each flipped (x1 <-> x2)
    with probability `flip`, as PixProTwoViewsTransform gives them."""
    x1, y1 = rng.randint(0, 100, n), rng.randint(0, 100, n)
    w, h = rng.randint(30, 100, n), rng.randint(30, 100, n)
    box = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    flipped = rng.rand(n) < flip
    box[flipped] = box[flipped][:, [2, 1, 0, 3]]
    return box


# ------------------------------------------------------------------ MLP2d


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_mlp2d_matches_jax(train):
    """Output and the input's gradient in f32, and in training the BatchNorm's
    running statistics after the forward (every position of every image one
    sample, flax's BatchNorm over NHWC)."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.necks import MLP2d as JaxMLP2d

    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 5, 24).astype(np.float32)
    jn = JaxMLP2d(hid_channels=20, out_channels=12)
    variables = _drawn_variables(jn, 4, x)
    pn = MLP2d(24, 20, 12)
    pn.load_state_dict(flax_to_torch(variables["params"], pn, variables["batch_stats"]))
    pn.train(train)
    c = rng.randn(3, 4, 5, 12).astype(np.float32)

    def f(x_):
        out, mut = jn.apply(variables, x_, train=train, mutable=["batch_stats"])
        return jnp.sum(out * c), (out, mut)

    (_, (want, mut)), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = pn(xt)
    torch.sum(got * torch.from_numpy(c)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=F32_TOL, atol=F32_TOL)
    stats = flax_to_torch(variables["params"], pn,
                          jax.device_get(mut["batch_stats"]) if train else variables["batch_stats"])
    for key in ("bn1.running_mean", "bn1.running_var"):
        np.testing.assert_allclose(pn.state_dict()[key].numpy(), stats[key].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ the loss


def _jax_loss_parts(q, k, cq, ck, pos_ratio):
    """JAX's loss, and its distances and positive mask as the JAX function
    computes them: jnp.sqrt's results (the diagonals, then the distances'
    numerator) and the one stop_gradient's argument, recorded."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.pixpro import pixpro_regression_loss as jax_loss

    sqrts, masks = [], []
    sqrt, stop = jnp.sqrt, jax.lax.stop_gradient
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "sqrt", lambda a: sqrts.append(sqrt(a)) or sqrts[-1])
        mp.setattr(jax.lax, "stop_gradient", lambda a: masks.append(a) or stop(a))
        loss = jax_loss(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cq), jnp.asarray(ck), pos_ratio)
    # l2_normalize's two, then the two diagonals and the distances' numerator
    assert len(sqrts) == 5 and len(masks) == 1
    n = q.shape[0]
    max_diag = jnp.maximum(jnp.maximum(sqrts[2], sqrts[3]).reshape(n, 1, 1), 1e-6)
    return float(loss), np.asarray(sqrts[4] / max_diag), np.asarray(masks[0])


@pytest.mark.parametrize("case", ["random", "flipped", "identity", "disjoint"])
def test_pixpro_regression_loss_matches_jax(case):
    """The cell distances (f32, 1e-6 of the diagonal) first, then the positive
    masks exactly, then the loss and its gradient. A cell pair whose distance
    lies within 1e-6 of `pos_ratio` is a near tie, where f32 rounding in
    another order may land on the other side: the test counts such pairs
    (none in these cases) and holds every other pair exactly. Identical crops
    give each cell itself as a positive and q = k: the loss is -2
    (`tests/test_dense_methods.py:58`); disjoint crops have no positive: 0."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.pixpro import pixpro_regression_loss as jax_loss

    rng = np.random.RandomState({"random": 0, "flipped": 1, "identity": 2, "disjoint": 3}[case])
    n, h, w, c = 6, 4, 5, 8
    q = rng.randn(n, h, w, c).astype(np.float32)
    k = rng.randn(n, h, w, c).astype(np.float32)
    cq, ck = _boxes(rng, n, 0.0 if case == "random" else 0.5), _boxes(rng, n, 0.5)
    pos_ratio = 0.7
    if case == "flipped":  # every box of q flipped, k's not
        cq, ck = _boxes(rng, n, 1.0), _boxes(rng, n, 0.0)
    if case == "identity":
        k, ck, pos_ratio = q, cq, 0.1
    if case == "disjoint":
        ck = cq + 1000.0
    want, want_dist, want_mask = _jax_loss_parts(q, k, cq, ck, pos_ratio)
    dist = cell_distances(torch.from_numpy(cq), torch.from_numpy(ck), h, w).numpy()
    np.testing.assert_allclose(dist, want_dist, rtol=1e-6, atol=1e-6)
    near = np.abs(want_dist - pos_ratio) <= 1e-6
    assert near.sum() == 0, f"{near.sum()} near-tie cell pairs"
    np.testing.assert_array_equal((dist < pos_ratio)[~near], want_mask[~near].astype(bool))
    qt = torch.from_numpy(q).requires_grad_()
    got = pixpro_regression_loss(qt, torch.from_numpy(k), torch.from_numpy(cq),
                                 torch.from_numpy(ck), pos_ratio)
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=F32_TOL, atol=1e-6)
    want_dq = jax.grad(lambda q_: jax_loss(q_, jnp.asarray(k), jnp.asarray(cq), jnp.asarray(ck),
                                           pos_ratio))(jnp.asarray(q))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want_dq), rtol=F32_TOL, atol=1e-6)
    if case == "identity":
        np.testing.assert_allclose(got.item(), -2.0, rtol=1e-5)
    if case == "disjoint":
        assert want_mask.sum() == 0 and got.item() == 0.0
    if case == "flipped":  # the mirrored grid matches other cells than the unflipped would
        unflipped = cell_distances(torch.from_numpy(cq[:, [2, 1, 0, 3]]), torch.from_numpy(ck),
                                   h, w).numpy()
        assert ((unflipped < pos_ratio) != (dist < pos_ratio)).any()


# -------------------------------------------------------- PixelPropagation


@pytest.mark.parametrize("p, layers", [(1.0, 1), (2.0, 1), (2.0, 2)])
def test_pixel_propagation_matches_jax(p, layers):
    """The output, the input's and the transform convs' gradients, in f32."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.pixpro import PixelPropagation as JaxProp

    rng = np.random.RandomState(int(p * 10 + layers))
    x = rng.randn(3, 4, 4, 12).astype(np.float32)
    jp = JaxProp(p=p, transform_layers=layers)
    params = _drawn_variables(jp, 5, x)
    pp = PixelPropagation(12, p, layers)
    pp.load_state_dict(flax_to_torch(params["params"], pp))
    assert sorted(pp.state_dict()) == sorted(
        f"transform.{i}.{leaf}" for i in range(layers) for leaf in ("weight", "bias"))
    c = rng.randn(3, 4, 4, 12).astype(np.float32)
    (want, want_g) = jax.value_and_grad(
        lambda v, x_: jnp.sum(jp.apply(v, x_) * c), argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = pp(xt)
    torch.sum(out * torch.from_numpy(c)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jp.apply(params, jnp.asarray(x))),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g[1]), rtol=F32_TOL, atol=F32_TOL)
    want_pg = dict(_torch_name(k, a) for k, a in _flatten(jax.device_get(want_g[0])["params"]).items())
    for name, prm in pp.named_parameters():
        _assert_grads_agree(prm.grad.numpy(), want_pg[name], name)


# ------------------------------------------------------------------ PixPro


def _tiny_kw() -> dict:
    return dict(backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1],
                          "num_classes": 0, "with_pool": False, "cifar_stem": True},
                neck={"name": "MLP2d", "hid_channels": 32, "out_channels": 16},
                pixpro_p=2.0, pixpro_momentum=0.99, pixpro_pos_ratio=0.7,
                pixpro_transform_layer=1)


def test_pixpro_loss_gradients_and_statistics_match_jax():
    """One train-mode forward and backward of 4 pairs of 32 x 32 crops with
    their boxes (some flipped), from a converted init (the key tower
    randomized apart from the online one): the loss, every online gradient
    (the key tower takes none) and both towers' BatchNorm statistics."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.pixpro import PixPro as JaxPixPro

    rng = np.random.RandomState(11)
    x1 = rng.randn(4, 32, 32, 3).astype(np.float32)
    batch = {"view1": x1, "view2": (x1 + 0.5 * rng.randn(4, 32, 32, 3)).astype(np.float32),
             "coord1": _boxes(rng, 4), "coord2": _boxes(rng, 4)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxPixPro(**_tiny_kw())
    variables = _drawn_variables(jm, 9, jb)
    params, state = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        out, mut = jm.apply({"params": p, **state}, jb, train=True, mutable=["batch_stats"])
        return out["loss"], mut

    (want, mut), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm = PixPro(**_tiny_kw())
    pm.load_state_dict(flax_to_torch(params, pm, state["batch_stats"]))
    pm.train()
    got = pm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == {"loss"}
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=F32_TOL)
    got["loss"].backward()
    want_g = dict(_torch_name(k, a) for k, a in _flatten(jax.device_get(grads)).items())
    for name, p in pm.named_parameters():
        if name.startswith("encoder_k."):
            assert p.grad is None and not np.any(want_g[name]), name
        else:
            _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    want_state = flax_to_torch(params, pm, jax.device_get(mut["batch_stats"]))
    for key, v in want_state.items():
        if "running" in key:
            np.testing.assert_allclose(pm.state_dict()[key].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_pixpro_hooks():
    m = init_module(PixPro(**_tiny_kw()), torch.Generator().manual_seed(0))
    assert m.ema_map() == [("encoder", "encoder_k", {"momentum": 0.99, "schedule": "cosine"})]
    assert m.frozen_patterns() == [r"^encoder_k\."]
    assert {n.split(".")[0] for n, _ in m.named_parameters()} == {
        "encoder", "encoder_k", "propagation"}
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    c = torch.from_numpy(_boxes(np.random.RandomState(0), 2))
    out = m.eval()((x, x, c, c))  # the four as a tuple
    assert set(out) == {"loss"} and torch.isfinite(out["loss"])


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'MLP2d', 'hid_channels': 64, 'out_channels': 32}",
    "DataLoader.Train.dataset.size=64",
    "DataLoader.Train.sampler.batch_size=8",
]
PARITY = [*TINY, "FP16.enable=False"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def test_the_loader_gives_the_jax_batch_dict_and_the_engine_takes_it(tmp_path):
    """PixProTwoViewsTransform through the port's loader (2 workers): the JAX
    loader's batch dict bitwise (views, and boxes with flips); then
    `Engine.prepare_batch` passes the dict through and `to_device` gives f32
    tensors with the boxes as they were."""
    from passl_tpu.data import build_dataloader as jax_build_dataloader

    config = _config(tmp_path, *PARITY)
    dl = copy.deepcopy(dict(config["DataLoader"]["Train"], loader={"num_workers": 2}))
    batches = []
    for build in (jax_build_dataloader, build_dataloader):
        loader = build(copy.deepcopy(dl), "Train", seed=42)
        loader.set_epoch(1)
        batches.append(next(iter(loader)))
        loader.close()
    want, got = batches
    assert isinstance(got, dict) and set(got) == set(want) == {"view1", "view2", "coord1", "coord2"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["view1"].shape == (8, 32, 32, 3) and got["coord1"].shape == (8, 4)
    flipped = got["coord1"][:, 0] > got["coord1"][:, 2]
    assert flipped.any() and not flipped.all()
    e = Engine(config, mode="train", device="cpu")
    on_device = to_device(e.prepare_batch(got), e.device)
    assert set(on_device) == set(got)
    for k, v in on_device.items():
        assert v.dtype == torch.float32 and torch.equal(v, torch.from_numpy(got[k])), k
    e.close()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 3 loader batches, its metrics on them, and its
    state (parameters, statistics, LARS momentum buffers) before each of its
    3 train steps and after the last, in the port's names and layouts."""
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


def test_tiny_pixpro_steps_along_the_jax_engine(tmp_path, jax_run):
    """Each of the JAX engine's 3 train steps (MomentumLARS, the key tower's
    cosine EMA from 0.99), from JAX's state before it: the metrics, and every
    parameter, statistic and momentum buffer after it, by the rule of
    test_torch_mocobyol.py (beside 8 f32 roundings of the tensor and the f32
    resolution of the change, the port's f32 step from its f64 step, counted
    for each side), but each tensor's change within 1e-2 of its norm where
    that rule takes 1e-3. PixPro's first steps resolve coarser in f32: its
    loss at init is a remainder of +-cosines (0.02 of terms near 1), and at 8
    images a ReLU that rounding flips moves a BatchNorm bias's step. By step
    3, JAX's f32 step of encoder.backbone.layer3.0.bn1.bias lies 0.55% from
    the port's f64 step, and the port's own f32 step 0.0001% to 0.19% of it
    as its summation order goes (1, 2, 4 or 8 threads); at 1e-3 the rule
    would take JAX's rounding for a difference. A wrong rate, momentum,
    weight decay, trust ratio or EMA moves a change by its whole size."""
    batches, jax_metrics, states = jax_run
    engines = [Engine(_config(tmp_path / name, *PARITY), mode="train", device="cpu")
               for name in ("f32", "f64")]
    e, e64 = engines
    assert type(e.optimizer.torch_optimizer).__name__ == "MomentumLARS"
    _to_f64(e64.model)
    eps32 = float(np.finfo(np.float32).eps)
    with torch.backends.mkldnn.flags(enabled=False):
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            for x in engines:
                _force(x, states[t], t)
            got = {k: float(v) for k, v in
                   e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
            got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
            assert set(got) == set(want) and "loss" in got
            f32_res = abs(got["loss"] - float(got64["loss"]))
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + f32_res, t
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
            before, (after, bufs_after) = states[t][0], states[t + 1]
            final, final64 = e.model.state_dict(), e64.model.state_dict()
            assert set(final) == set(after)
            for name, p in final.items():
                d_port, d_jax = p - before[name], after[name] - before[name]
                f32_res = (d_port.double() - (final64[name] - before[name].double())).norm().item()
                tol = 1e-2 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + 2 * f32_res
                assert (d_port - d_jax).norm().item() <= tol, (t, name)
            bufs, bufs64 = (_buffers(x) for x in engines)
            assert set(bufs) == set(bufs_after)
            assert not any(n.startswith("encoder_k.") for n in bufs_after)  # frozen: no state
            for name, buf in bufs_after.items():
                f32_res = (bufs[name].double() - bufs64[name].double()).norm().item()
                if bufs64[name].norm() <= 1e-6 * bufs[name].norm():
                    # a bias that feeds a BatchNorm (MLP2d's conv1): its gradient is 0
                    # (1e-17 in f64) and f32's is rounding alone, on each side its own;
                    # both must lie at the rounding of the layer's weight gradient
                    scale = bufs[name.replace(".bias", ".weight")].norm().item()
                    assert max(bufs[name].norm(), buf.norm()) <= 64 * eps32 * scale, (t, name)
                    continue
                tol = 1e-2 * buf.norm().item() + 1e-8 + 2 * f32_res
                assert (bufs[name] - buf).norm().item() <= tol, (t, name)
    for x in engines:
        x.close()


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "pixpro", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "pixpro_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_pixpro_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == model_cfg["name"]
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("backbone, probe", [
    ("resnet18", os.path.join("tests", "e2e", "probe_structured.yaml")),
    ("resnet50", os.path.join("configs", "pixpro", "pixpro_r50_lp_in1k.yaml")),
], ids=["structured-probe", "r50-lp-in1k"])
def test_extract_weights_fills_the_probe(tmp_path, backbone, probe):
    """The learning check's extract step (tests/e2e/pixpro_structured.yaml's
    model into tests/e2e/probe_structured.yaml's), and a ResNet-50 PixPro at
    tiny neck widths into configs/pixpro/pixpro_r50_lp_in1k.yaml's
    `LinearProbe`: `encoder.backbone` fills every backbone entry."""
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "pixpro_structured.yaml")
    model_cfg = dict(cfg_util.get_config(structured)["Model"])
    if backbone == "resnet50":
        model_cfg.update(backbone={"name": "resnet50", "num_classes": 0, "with_pool": False},
                         neck={"name": "MLP2d", "hid_channels": 16, "out_channels": 8})
    model = init_module(build_model(model_cfg), torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "encoder.backbone",
                                   "--rename", "backbone", "--output",
                                   str(tmp_path / "backbone.pt"), "--check-config",
                                   os.path.join(REPO, probe)])
    want = model.get_submodule("encoder.backbone").state_dict()
    assert set(picked) == {f"backbone.{k}" for k in want}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_pixpro_trains_on_the_card(tmp_path):
    """Two steps on the card, the boxes on the card as f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    batch = to_device(e.prepare_batch(next(iter(e.train_dataloader))), e.device)
    assert all(v.device.type == "cuda" and v.dtype == torch.float32 for v in batch.values())
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
