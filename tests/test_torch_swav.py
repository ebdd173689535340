"""SwAV of the PyTorch port against the JAX package: the model, and the
engine's `param_transforms` and `optimizer_overrides` hooks.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, crops of 16 and 8 px, dim != num_prototypes so that the
prototypes' normalized axis shows): `sinkhorn_knopp` with fewer and with more
samples than prototypes, at 3 and at 50 iterations; `SwAVNeck` in f32 and
bf16 and without its hidden layer; SwAV's loss, gradients and BatchNorm
statistics with `num_crops` [2] and `crops_for_assign` [0, 1], and [2, 4]
with [0] (the backbone takes one batch per resolution); the hooks' dotted
idiom. The slice as a whole (the prototypes through the engine, the crop
lists, the tiny SwAV along the JAX engine across its prototype freeze, the
config regexes' groups, the census, the extract step, the card) is in
tests/test_torch_swav_engine.py.
"""

import numpy as np
import pytest
import torch

from passl_tpu_torch.models.necks import SwAVNeck
from passl_tpu_torch.models.swav import SwAV, sinkhorn_knopp
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

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
