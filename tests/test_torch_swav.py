"""SwAV of the PyTorch port against the JAX package, and the engine's
`param_transforms`, `optimizer_overrides` and config-regex grouping.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, crops of 16 and 8 px, dim != num_prototypes so that the
prototypes' normalized axis shows): `sinkhorn_knopp` with fewer and with more
samples than prototypes, at 3 and at 50 iterations; `SwAVNeck` in f32 and
bf16 and without its hidden layer; SwAV's loss, gradients and BatchNorm
statistics with `num_crops` [2] and `crops_for_assign` [0, 1], and [2, 4]
with [0] (the backbone takes one batch per resolution); unit-norm prototypes
at init and after every step, frozen for `freeze_prototypes_iter` steps;
the data path's crop lists; the optimizer groups of a config's regexes
(flax paths such as `^prototypes/`) against the JAX builder's on nine
configs; and the slice as a whole: the tiny SwAV of
configs/swav/swav_r18_synthetic.yaml takes each of the JAX engine's first 3
steps, across its prototype freeze of 2, from JAX's state on the JAX
loader's batch; the learning check's extract step into the probe's model.
A census builds every SwAV config's model on the meta device. A test marked `cuda` trains the tiny SwAV on the card and skips
elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.necks import SwAVNeck
from passl_tpu_torch.models.swav import SwAV, sinkhorn_knopp
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_path, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "swav", "swav_r18_synthetic.yaml")
# f32 against XLA's: the same f32 math summed in another order
F32_TOL = 1e-5


def _randomize(tree, seed):
    """Every flax leaf redrawn with numpy at a scale where each part shows;
    the prototypes then unit-norm, as the engine keeps them."""
    import jax

    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            w = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            return w / np.linalg.norm(w, axis=0) if "prototypes" in name else w
        if "'var'" in name:
            return 0.5 + rng.rand(*shape)
        return 0.2 * rng.randn(*shape)

    return jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(draw(p, x), np.float32), tree)


def _assert_grads_agree(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """Within atol 1e-6, or at cosine >= 0.99999 where the tensor is large."""
    if np.allclose(got, want, rtol=0, atol=1e-6):
        return
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    assert cos >= 0.99999, f"{name}: cosine {cos}, max diff {np.abs(got - want).max()}"


# -------------------------------------------------------------- sinkhorn


@pytest.mark.parametrize("iterations", [3, 50])
@pytest.mark.parametrize("b, k", [(6, 20), (40, 12)], ids=["B<K", "B>K"])
def test_sinkhorn_knopp_matches_jax(b, k, iterations):
    """On cosines of unit vectors at eps 0.05 (exp up to 4.9e8, no max taken
    out): JAX's exact form, each row of Q summing to 1."""
    import jax.numpy as jnp

    from passl_tpu.models.swav import sinkhorn_knopp as jax_sinkhorn

    rng = np.random.RandomState(b + k + iterations)
    z = rng.randn(b, 8)
    c = rng.randn(k, 8)
    scores = ((z / np.linalg.norm(z, axis=1, keepdims=True))
              @ (c / np.linalg.norm(c, axis=1, keepdims=True)).T).astype(np.float32)
    want = np.asarray(jax_sinkhorn(jnp.asarray(scores), 0.05, iterations))
    got = sinkhorn_knopp(torch.from_numpy(scores), 0.05, iterations)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, k) and not got.requires_grad
    # exp of scores / 0.05 carries a rounding of the scores 20 times over
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got.sum(dim=1), torch.ones(b), rtol=1e-5, atol=1e-5)


def test_sinkhorn_takes_bf16_scores_in_f32_without_gradient():
    s = torch.rand(4, 6, generator=torch.Generator().manual_seed(0)).bfloat16().requires_grad_()
    q = sinkhorn_knopp(s)
    assert q.dtype == torch.float32 and not q.requires_grad
    torch.testing.assert_close(q, sinkhorn_knopp(s.detach().float()))


# ------------------------------------------------------------------ neck


@pytest.mark.parametrize("dtype, hid", [("float32", 16), ("bfloat16", 16), ("float32", 0)],
                         ids=["f32", "bf16", "f32-no-hidden-layer"])
def test_swav_neck_matches_jax(dtype, hid):
    """avgpool, fc-bn-relu (unless hid is 0), fc, l2-normalize in training:
    the output, the gradients and the new running statistics."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.necks import SwAVNeck as JaxSwAVNeck

    rng = np.random.RandomState(5)
    x = rng.randn(8, 3, 3, 24).astype(np.float32)
    w = rng.randn(8, 12).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jm = JaxSwAVNeck(hid_channels=hid, out_channels=12, dtype=jdt)
    pm = SwAVNeck(24, hid, 12, dtype=dtype)
    variables = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 6)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))

    def loss(params):
        out, mut = jm.apply({"params": params, **{k: v for k, v in variables.items()
                                                  if k != "params"}},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * w), (out, mut.get("batch_stats", {}))

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got = pm.train()(torch.from_numpy(x))
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    # bf16: both round the same f32 values to bf16 at each layer's output, one
    # ulp (2^-8 of a unit vector's entry) apart at most where they part
    tol = F32_TOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got.float().norm(dim=1), torch.ones(8), rtol=tol, atol=tol)
    (got.float() * torch.from_numpy(w)).sum().backward()
    want_g = dict(_torch_name(p, a) for p, a in _flatten(jax.device_get(grads)).items())
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        if dtype == "float32":
            _assert_grads_agree(p.grad.numpy(), want_g[name], name)
            continue
        g, h = p.grad.double().flatten(), torch.from_numpy(want_g[name]).double().flatten()
        if name == "fc1.bias":
            # a bias before a BatchNorm has the gradient 0; in bf16 both hold the
            # rounding of a cancelling sum, far below the weight's gradient
            # (8e-4 and 1.5e-3 of it here)
            scale = pm.fc1.weight.grad.double().norm()
            assert g.norm() <= 2 ** -7 * scale and h.norm() <= 2 ** -7 * scale
        else:  # bf16 products: a cosine of the two gradients
            assert torch.dot(g, h) / (g.norm() * h.norm()) >= 0.999, name
    assert bool(stats) == (hid > 0) and hasattr(pm, "bn1") == (hid > 0)
    # bf16: the statistics of bf16 activations of about 0.5, whose ulp (2^-9)
    # the momentum passes on at 0.1
    stats_atol = 1e-6 if dtype == "float32" else 2 ** -9 * 0.1
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=tol, atol=stats_atol,
                                   err_msg=key)


# ------------------------------------------------------------------ SwAV


def _tiny_kw(num_crops, crops_for_assign) -> dict:
    return dict(backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1],
                          "num_classes": 0, "with_pool": False, "cifar_stem": True},
                neck={"name": "SwAVNeck", "hid_channels": 32, "out_channels": 16},
                dim=16, num_prototypes=12, temperature=0.1, epsilon=0.05,
                num_crops=list(num_crops), crops_for_assign=list(crops_for_assign))


def _crops(num_crops, seed: int, n: int = 4) -> list:
    rng = np.random.RandomState(seed)
    return [rng.randn(n, size, size, 3).astype(np.float32)
            for count, size in zip(num_crops, (16, 8)) for _ in range(count)]


@pytest.mark.parametrize("num_crops, crops_for_assign", [([2], [0, 1]), ([2, 4], [0])],
                         ids=["crops-2-assign-0-1", "crops-2-4-assign-0"])
def test_swav_loss_gradients_and_statistics_match_jax(num_crops, crops_for_assign):
    """One train-mode forward and backward from a converted init: the loss,
    every gradient, and the running statistics after one backbone batch per
    resolution (two with crops of 16 and 8 px, in that order). The config's
    own pair, [2, 4] and [0, 1], is the tracking test's below."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.swav import SwAV as JaxSwAV

    kw = _tiny_kw(num_crops, crops_for_assign)
    crops = _crops(num_crops, seed=len(num_crops))
    jm, pm = JaxSwAV(**kw), SwAV(**kw)
    jcrops = [jnp.asarray(c) for c in crops]
    variables = jax.device_get(jax.jit(lambda c: jm.init(jax.random.PRNGKey(0), c))(jcrops))
    variables = _randomize(variables, 11)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    assert tuple(pm.prototypes.weight.shape) == (12, 16)

    def loss(params, c):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, c,
                            train=True, mutable=["batch_stats"])
        return out["loss"], mut["batch_stats"]

    (want, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jcrops)
    got = pm.train()([torch.from_numpy(c) for c in crops])
    assert set(got) == {"loss"} and got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=F32_TOL)
    got["loss"].backward()
    want_g = dict(_torch_name(p, a) for p, a in _flatten(jax.device_get(grads)).items())
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("num_crops, batches", [([2], 1), ([2, 4], 2), ([2, 6], 2)])
def test_the_backbone_takes_one_batch_per_resolution(num_crops, batches):
    """Crops grouped by height in order of first appearance, each group one
    call; the neck's running mean is that many chained updates."""
    m = init_module(SwAV(**_tiny_kw(num_crops, [0, 1])), torch.Generator().manual_seed(0)).train()
    seen = []
    m.backbone.register_forward_hook(lambda mod, inp, out: seen.append(tuple(inp[0].shape)))
    neck_in = []
    m.neck.bn1.register_forward_hook(lambda mod, inp, out: neck_in.append(inp[0].detach()))
    crops = [torch.from_numpy(c) for c in _crops(num_crops, seed=3)]
    m(crops[::-1] if batches == 1 else crops)
    assert len(seen) == batches
    assert seen[0] == (4 * num_crops[0], 16, 16, 3)
    if batches == 2:
        assert seen[1] == (4 * num_crops[1], 8, 8, 3)
    want = torch.zeros(32)
    for h in neck_in:
        want = 0.9 * want + 0.1 * h.mean(dim=0)
    torch.testing.assert_close(m.neck.bn1.running_mean, want, rtol=1e-5, atol=1e-7)


def test_swav_hooks_keep_the_dotted_idiom():
    m = SwAV(**_tiny_kw([2], [0]), freeze_prototypes_iter=5)
    assert m.optimizer_overrides() == [{"name": r"^prototypes\.", "freeze_steps": 5}]
    assert SwAV(**_tiny_kw([2], [0])).optimizer_overrides() == []
    (pat, fn), = m.param_transforms()
    assert pat == r"^prototypes\.weight$"
    w = torch.randn(12, 16, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(fn(w).norm(dim=1), torch.ones(12))  # each prototype: a row
    assert m.prototypes.weight.dtype == torch.float32
    assert SwAV(**_tiny_kw([2], [0]), dtype="bfloat16").prototypes.compute_dtype == torch.float32


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'SwAVNeck', 'hid_channels': 32, 'out_channels': 16}",
    "Model.dim=16", "Model.num_prototypes=24",
    "DataLoader.Train.dataset.dataset.image_size=24",
    "DataLoader.Train.dataset.transforms=[["
    "{'RandomResizedCrop': {'size': 16, 'scale': [0.3, 1.0]}}, {'RandFlipImage': {'prob': 0.5}}, "
    "{'NormalizeImage': {'scale': 0.00392157}}], ["
    "{'RandomResizedCrop': {'size': 8, 'scale': [0.05, 0.3]}}, {'RandFlipImage': {'prob': 0.5}}, "
    "{'NormalizeImage': {'scale': 0.00392157}}]]",
    "DataLoader.Train.sampler.batch_size=8",
]
PARITY = [*TINY, "FP16.enable=False"]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def test_prototypes_stay_unit_norm_and_frozen_for_their_steps(tmp_path):
    """Through the engine in the config's bf16: unit-norm at init and after
    every step; steps 1-2 leave them where they were (lr 0, then the
    renormalization's rounding), steps 3-4 move them."""
    e = Engine(_config(tmp_path, *TINY), mode="train", device="cpu")
    w = e.model.prototypes.weight
    assert e.optimizer.group_of("prototypes.weight").freeze_steps == 2
    torch.testing.assert_close(w.norm(dim=1), torch.ones(24), rtol=0, atol=1e-6)
    e.train_dataloader.set_epoch(1)
    it = iter(e.train_dataloader)
    moved = []
    for _ in range(4):
        before = w.detach().clone()
        e.train_step(e.state, to_device(e.prepare_batch(next(it)), e.device))
        torch.testing.assert_close(w.norm(dim=1), torch.ones(24), rtol=0, atol=1e-5)
        moved.append((w - before).abs().max().item())
    assert max(moved[:2]) <= 1e-6 and min(moved[2:]) > 1e-5, moved
    e.close()


@pytest.mark.parametrize("num_crops", [[2], [2, 6]], ids=["2-crops", "8-crops"])
def test_the_crop_lists_reach_the_model_untouched(tmp_path, num_crops):
    """SwAVMultiCropDataset's samples collate to a list of stacks, one per
    crop; the label-free engine passes it on as it is, also with two crops of
    one size (which looks like a batch of two views)."""
    config = _config(tmp_path, *TINY, f"DataLoader.Train.dataset.num_crops={num_crops}",
                     f"Model.num_crops={num_crops}", "Model.crops_for_assign=[0]")
    ds = config["DataLoader"]["Train"]["dataset"]
    ds["transforms"] = ds["transforms"][:len(num_crops)]
    e = Engine(config, mode="train", device="cpu")
    e.train_dataloader.set_epoch(1)
    batch = next(iter(e.train_dataloader))
    assert isinstance(batch, list) and len(batch) == sum(num_crops)
    assert [b.shape[1] for b in batch] == [16] * 2 + [8] * (sum(num_crops) - 2)
    assert e.prepare_batch(batch) is batch
    out = e.model(to_device(batch, e.device))
    assert torch.isfinite(out["loss"])
    e.close()


def _port_buffers(opt_state) -> dict:
    """The JAX rule's momentum buffers as the port's, by parameter name."""
    out = {}
    for path, leaf in _flatten(opt_state).items():
        if path.endswith("/buf"):
            name, arr = _torch_name(path[:-len("/buf")], leaf)
            out[name] = torch.from_numpy(np.array(arr, np.float32))
    return out


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


def _to_f64(model: torch.nn.Module) -> None:
    """Every parameter, buffer and compute dtype of `model` in float64."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64


def _force(engine: Engine, state: tuple, step: int) -> None:
    """The engine's model, momentum buffers and step set to a JAX state."""
    model_state, buffers = state
    engine.model.load_state_dict(model_state)
    named = dict(engine.model.named_parameters())
    opt = engine.optimizer.torch_optimizer
    opt.state.clear()
    for name, buf in buffers.items():
        opt.state[named[name]]["momentum_buffer"] = buf.clone()
    engine.state.step = step


def _buffers(engine: Engine) -> dict:
    state = engine.optimizer.torch_optimizer.state
    return {n: state[p]["momentum_buffer"] for n, p in engine.model.named_parameters()
            if p in state}


def test_tiny_swav_steps_along_the_jax_engine_across_the_prototype_freeze(tmp_path, jax_run):
    """Each of the JAX engine's 3 train steps (MomentumLARS, prototypes frozen
    for 2), from JAX's state before it: the loss, every parameter and
    statistic, and every momentum buffer after it; the prototypes and their
    buffer by name at every step. The port in f64 from the same state is the
    yardstick of how far f32 resolves each change (test_torch_byol.py's rule,
    counted for each side). A free run would measure rounding, not the port:
    at 8 images a BatchNorm bias's gradient is a small remainder of large
    sums, and f32 trajectories part from f64 within a few steps."""
    batches, jax_metrics, states = jax_run
    engines = [Engine(_config(tmp_path / name, *PARITY), mode="train", device="cpu")
               for name in ("f32", "f64")]
    e, e64 = engines
    assert e.optimizer.group_of("prototypes.weight").freeze_steps == 2
    _to_f64(e64.model)
    eps32 = float(np.finfo(np.float32).eps)
    proto_moved = []
    with torch.backends.mkldnn.flags(enabled=False):
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            for x in engines:
                _force(x, states[t], t)
            got = {k: float(v) for k, v in
                   e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
            got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
            assert set(got) == set(want)
            f32_res = abs(got["loss"] - float(got64["loss"]))
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + 2 * f32_res, t
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
            for name, buf in bufs_after.items():
                f32_res = (bufs[name].double() - bufs64[name].double()).norm().item()
                tol = 1e-3 * buf.norm().item() + 1e-8 + 2 * f32_res
                assert (bufs[name] - buf).norm().item() <= tol, (t, name)
            # the prototypes: unit-norm rows, frozen over steps 1-2, and a
            # momentum buffer that accumulates through the freeze as JAX's does
            w = e.model.prototypes.weight.detach()
            torch.testing.assert_close(w.norm(dim=1), torch.ones(24), rtol=0, atol=1e-5)
            torch.testing.assert_close(w, after["prototypes.weight"], rtol=1e-4, atol=1e-6)
            buf = bufs["prototypes.weight"]
            assert buf.abs().max() > 0
            torch.testing.assert_close(buf, bufs_after["prototypes.weight"], rtol=1e-3, atol=1e-6)
            proto_moved.append((w - before["prototypes.weight"]).abs().max().item())
    assert len(proto_moved) == 3 and max(proto_moved[:2]) <= 1e-6 < proto_moved[2], proto_moved
    for x in engines:
        x.close()


# --------------------------------------------- config regexes (Repair of the optimizer)

GROUP_CONFIGS = [
    ("tests/e2e/swav_structured.yaml", None),
    ("configs/classification/cait_s24_224_in1k.yaml", 224),
    ("configs/classification/swin_tiny_patch4_window7_224_in1k.yaml", 224),
    ("configs/classification/swin_large_patch4_window7_224_in1k.yaml", 224),
    ("configs/classification/vit_base_patch16_224_in1k.yaml", 224),
    ("configs/classification/vit_base_patch16_384_ft_in1k.yaml", 384),
    ("configs/mocov3/mocov3_vit_base_ft_in1k.yaml", 224),
    ("configs/byol/byol_r50_in1k.yaml", 224),
    ("configs/byol/byol_r18_synthetic.yaml", 32),
]


@pytest.mark.parametrize("path, size", GROUP_CONFIGS, ids=[p for p, _ in GROUP_CONFIGS])
def test_config_regexes_group_as_the_jax_builder_does(path, size):
    """Each parameter's group (name, weight decay, lr scale, freeze steps)
    from the port's engine (`model_optimizer`) and from the JAX engine's
    rules (the model's frozen patterns and optimizer overrides, the depth
    for layerwise decay), at the configs' own widths: the JAX params as
    shapes (`jax.eval_shape`), the port's model on the meta device. The
    SwAV config's `^prototypes/` is a flax path: the port matches it too."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.optimizer import build_optimizer as jax_build_optimizer

    config = cfg_util.get_config(os.path.join(REPO, path), show=False)
    model_cfg = dict(config["Model"])
    opt_cfg = dict(config["Optimizer"])
    opt_cfg.pop("grad_clip", None)
    jm = jax_build_model(dict(model_cfg))
    if model_cfg["name"] == "SwAV":
        x = [jnp.zeros((2, 32, 32, 3))] * 2 + [jnp.zeros((2, 16, 16, 3))] * 4
        args = (x,)
    elif model_cfg["name"] == "BYOL":
        args = ((jnp.zeros((2, size, size, 3)),) * 2,)
    else:
        args = (jnp.zeros((1, size, size, 3)),)
    train = model_cfg["name"] in ("SwAV", "BYOL")
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, train=train))["params"]
    jax_cfg = dict(opt_cfg)
    if hasattr(jm, "optimizer_overrides") and jm.optimizer_overrides():
        jax_cfg["param_group"] = list(jax_cfg.get("param_group", []) or []) + jm.optimizer_overrides()
    num_layers = int(model_cfg.get("depth", 0) or getattr(jm, "depth", 0) or 0)
    frozen = list(jm.frozen_patterns()) if hasattr(jm, "frozen_patterns") else []
    jopt = jax_build_optimizer(jax_cfg, params, frozen_patterns=frozen, num_layers=num_layers)

    with torch.device("meta"):
        pm = build_model(dict(model_cfg))
    popt = model_optimizer(pm, opt_cfg, model_cfg)
    named = dict(pm.named_parameters())
    paths = {flax_path(n, p.dim()): n for n, p in named.items()}
    flat = _flatten(jax.tree_util.tree_map(lambda s: np.empty(0), params))
    assert set(paths) == set(flat)
    for jpath, name in paths.items():
        jg, pg = jopt.group_of(jpath), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale, pg.freeze_steps) == \
            (jg.name, jg.weight_decay, jg.lr_scale, jg.freeze_steps), name
        assert (pg.rule == "Frozen") == (type(jg.rule).__name__ == "Frozen"), name
    if model_cfg["name"] == "SwAV":
        assert popt.group_of("prototypes.weight").name == "^prototypes/"
        assert popt.group_of("prototypes.weight").freeze_steps == 16


def test_flax_path_inverts_the_converters_names():
    assert flax_path("blocks.3.attn.qkv.weight", 2) == "blocks_3/attn/qkv/kernel"
    assert flax_path("layer1.0.conv1.weight", 4) == "layer1_0/conv1/kernel"
    assert flax_path("layer1.0.bn1.weight", 1) == "layer1_0/bn1/scale"
    assert flax_path("prototypes.weight", 2) == "prototypes/kernel"
    assert flax_path("cls_token", 3) == "cls_token"
    for path in ("blocks_3/attn/qkv/kernel", "norm/scale", "head/bias", "stages_0_1/x"):
        arr = np.zeros((2, 3)) if path.endswith("kernel") else np.zeros(3)
        name, arr = _torch_name(path, arr)
        assert flax_path(name, arr.ndim) == path


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "swav", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "swav_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_swav_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == model_cfg["name"]
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_weights_fills_the_structured_probe(tmp_path):
    """The learning check's extract step: the backbone of
    tests/e2e/swav_structured.yaml's model under `backbone` fills every
    backbone entry of tests/e2e/probe_structured.yaml's model."""
    from passl_tpu_torch.nn.init import init_module
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "swav_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "backbone", "--rename",
                                   "backbone", "--output", str(tmp_path / "backbone.pt"),
                                   "--check-config",
                                   os.path.join(REPO, "tests", "e2e", "probe_structured.yaml")])
    want = model.get_submodule("backbone").state_dict()
    assert set(picked) == {f"backbone.{k}" for k in want}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_swav_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=3", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True] * 3
    w = e.model.prototypes.weight
    assert w.device.type == "cuda"
    torch.testing.assert_close(w.norm(dim=1), torch.ones(24, device="cuda"), rtol=0, atol=1e-5)
