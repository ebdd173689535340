"""MoCo v1/v2 of the PyTorch port against the JAX package: the model.

On the CPU, at tiny sizes: `SplitBatchNorm` against JAX's at 1, 2, 4 and 8
splits of 8 images and at 4 splits of 6 (the gcd rule takes 2), in training
(output, gradients, running statistics) and in eval; a tiny `bn_splits`
ResNet; `info_nce_logits`; MoCo's train steps with the permutation JAX drew
handed to the port (loss, `acc1`, gradients, the queue, the pointer and
both encoders' statistics), once where K is a multiple of N and once where
JAX's `dynamic_update_slice` clamps the write to K - N; the queue's clamped
write; eval; the converter on the `ssl` collection. The slice as a whole
(the tiny MoCo v2 along the JAX engine, fp16, resume, the CLI, the card) is
in tests/test_torch_moco_engine.py, which imports this file's helpers.
"""
import contextlib

import numpy as np
import pytest
import torch

import passl_tpu_torch.models.moco as port_moco
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.moco import MoCo, info_nce_logits
from passl_tpu_torch.models.resnet import ResNet
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.nn.norm import SplitBatchNorm
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """The port's tiny CPU steps on one OpenMP thread, put back after: beside
    the test runner's other workers, OpenMP's barriers over a thread a core
    cost more than the tiny convolutions they split (a tiny engine's three
    steps took 40 s beside five workers, 5 s alone). Through threadpoolctl,
    not `torch.set_num_threads`, which also turns MKL's dynamic threading off
    for the rest of the worker (ROADMAP.md, Queue 3). The files that import
    this fixture run under it too."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # a speed setting only; the card's tests run without it
        yield
        return
    with threadpool_limits(1, user_api="openmp"):
        yield


def _randomize(tree, seed):
    """Every flax leaf redrawn with numpy at a scale where each part shows
    (the queue and its pointer kept)."""
    import jax

    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "queue" in name:
            return np.asarray(leaf)
        if "scale" in name:
            return 1.0 + 0.1 * rng.randn(*shape)
        if "kernel" in name:
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if "'var'" in name:
            return 0.5 + rng.rand(*shape)
        return 0.2 * rng.randn(*shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(draw(p, x), np.asarray(x).dtype), tree)


def _port_grads(grads) -> dict:
    return dict(_torch_name(path, arr) for path, arr in _flatten(grads).items())


def _assert_grads_agree(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """Within atol 1e-6, or at cosine >= 0.99999 where the tensor is large."""
    if np.allclose(got, want, rtol=0, atol=1e-6):
        return
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    assert cos >= 0.99999, f"{name}: cosine {cos}, max diff {np.abs(got - want).max()}"


def _port_state(model, variables) -> dict:
    return flax_to_torch(variables["params"], model, variables.get("batch_stats"),
                         collections={"ssl": variables["ssl"]} if "ssl" in variables else None)


@contextlib.contextmanager
def _recorded_permutations():
    """jax.random.permutation records each permutation it draws (also under
    jit, through a debug callback) into the yielded list."""
    import jax

    record = []
    orig = jax.random.permutation

    def permutation(key, x, *args, **kwargs):
        p = orig(key, x, *args, **kwargs)
        jax.debug.callback(lambda v: record.append(np.asarray(v)), p)
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "permutation", permutation)
        yield record


@contextlib.contextmanager
def _handed_permutations(perms):
    """The port's shuffle draws the given permutations, in order."""
    queue = list(perms)

    def shuffle_permutation(n, generator, device):
        p = queue.pop(0)
        assert len(p) == n
        return torch.from_numpy(np.asarray(p, np.int64)).to(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_moco, "shuffle_permutation", shuffle_permutation)
        yield queue


# ------------------------------------------------------------ SplitBatchNorm

# (N, splits, H x W): 8 images in 1 to 8 splits, 6 in 4 (the gcd takes 2), and
# one value per channel in each split (a 1 x 1 map, one image a split)
SPLIT_CASES = [(8, 1, (3, 4)), (8, 2, (3, 4)), (8, 4, (3, 4)), (8, 8, (3, 4)), (6, 4, (3, 4)),
               (8, 8, (1, 1))]


@pytest.mark.parametrize("n, splits, hw", SPLIT_CASES,
                         ids=[f"n{n}-splits{s}-{h}x{w}" for n, s, (h, w) in SPLIT_CASES])
def test_split_batchnorm_matches_jax(n, splits, hw):
    import jax
    import jax.numpy as jnp

    from passl_tpu.nn.norm import SplitBatchNorm as JaxSplit

    rng = np.random.RandomState(n + splits)
    x = (rng.randn(n, *hw, 6) * 2 + 1).astype(np.float32)
    x[: n // 2] += 3.0  # each split's statistics differ from the batch's
    fm = JaxSplit(num_splits=splits, use_running_average=False)
    variables = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _randomize(variables, 1)
    pm = SplitBatchNorm(6, num_splits=splits)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    w = rng.randn(*x.shape).astype(np.float32)

    def loss(params, xx):
        y, mut = fm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()  # NHWC -> the port's NCHW
    got = pm.train()(t)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    (got * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    # one value per split and channel: y is the bias, x takes no gradient (JAX's is 0)
    gx_port = t.grad if t.grad is not None else torch.zeros_like(t)
    _assert_grads_agree(gx_port.permute(0, 2, 3, 1).numpy(), np.asarray(gx), "x")
    _assert_grads_agree(pm.weight.grad.numpy(), np.asarray(gp["scale"]), "scale")
    _assert_grads_agree(pm.bias.grad.numpy(), np.asarray(gp["bias"]), "bias")
    np.testing.assert_allclose(pm.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pm.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-6)
    # eval: the running statistics
    fe = JaxSplit(num_splits=splits, use_running_average=True)
    want_eval = fe.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got_eval = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_eval.permute(0, 2, 3, 1).numpy(), np.asarray(want_eval),
                               rtol=F32_TOL, atol=F32_TOL)


def test_split_batchnorm_statistics_are_per_split_and_full_batch():
    x = torch.randn(8, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    x[:4] += 5.0
    bn = SplitBatchNorm(3, num_splits=2, momentum=0.0)
    bn.reset_parameters()
    y = bn(x)
    for half in (y[:4], y[4:]):  # each split normalized by its own statistics
        torch.testing.assert_close(half.mean(dim=(0, 2, 3)), torch.zeros(3), atol=1e-5, rtol=0)
    torch.testing.assert_close(bn.running_mean, x.mean(dim=(0, 2, 3)), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_var, x.var(dim=(0, 2, 3), unbiased=False), rtol=1e-5,
                               atol=1e-5)
    assert bn(x.bfloat16()).dtype == torch.float32  # the compute dtype, f32 here
    assert SplitBatchNorm(3, dtype=torch.bfloat16)(x).dtype == torch.bfloat16


def test_tiny_bn_splits_resnet_matches_jax():
    """Train-mode forward, every gradient and the new batch_stats of a
    [1, 1, 1, 1] ResNet with SplitBatchNorm at every norm position."""
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.resnet as jax_resnet

    kw = dict(block="basic", layers=[1, 1, 1, 1], cifar_stem=True, num_classes=0, bn_splits=4)
    x = np.random.RandomState(3).randn(8, 16, 16, 3).astype(np.float32)
    jm = jax_resnet.ResNet(**{**kw, "layers": (1, 1, 1, 1)})
    pm = ResNet(**kw)
    assert sum(isinstance(m, SplitBatchNorm) for m in pm.modules()) == 1 + 2 * 4 + 3
    variables = jax.device_get(jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=True))(
        jnp.asarray(x)))
    variables = _randomize(variables, 4)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    w = np.random.RandomState(5).randn(8, 512).astype(np.float32)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    got = pm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = _port_grads(jax.device_get(grads))
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    with torch.no_grad():
        got_eval = pm.eval()(torch.from_numpy(x))
    want_eval = jm.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
                         train=False)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=1e-4, atol=1e-4)


def test_bn_splits_resnet_runs_channels_last():
    model = init_module(ResNet(block="basic", layers=[1, 1, 1, 1], num_classes=0, bn_splits=2),
                       torch.Generator().manual_seed(0))
    layouts = []
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, SplitBatchNorm)):
            m.register_forward_hook(lambda m, inp, out: layouts.append(
                inp[0].is_contiguous(memory_format=torch.channels_last)
                and out.is_contiguous(memory_format=torch.channels_last)))
    model(torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1)))
    assert len(layouts) == 2 * 12 and all(layouts)


# ------------------------------------------------------------------ MoCo


def test_info_nce_logits_match_jax():
    import jax.numpy as jnp

    from passl_tpu.models.moco import info_nce_logits as jax_logits

    rng = np.random.RandomState(2)
    q, k = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    queue = rng.randn(8, 20).astype(np.float32)
    want = jax_logits(jnp.asarray(q), jnp.asarray(k), jnp.asarray(queue), 0.2)
    got = info_nce_logits(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(queue), 0.2)
    assert tuple(got.shape) == (6, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def _tiny_moco_kw(K: int) -> dict:
    return dict(backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1],
                          "num_classes": 0, "with_pool": False, "cifar_stem": True,
                          "bn_splits": 4},
                neck={"name": "NonLinearNeckV1", "hid_channels": 32, "out_channels": 16},
                dim=16, K=K, m=0.99, T=0.2)


@pytest.mark.parametrize("K", [24, 12], ids=["K-multiple-of-N", "clamped-write"])
def test_moco_steps_match_jax_on_its_permutations(K):
    """Three train-mode forwards and backwards of 8 images: loss, acc1, the
    query encoder's gradients, the queue and pointer, both encoders'
    statistics; at K = 12 the second write starts at ptr 8 and JAX clamps it
    to K - N = 4, then the pointer is 4 and the third write starts there."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.moco import MoCo as JaxMoCo

    rng = np.random.RandomState(7)
    kw = _tiny_moco_kw(K)
    jm, pm = JaxMoCo(**kw), MoCo(**kw)
    x0 = jnp.zeros((8, 16, 16, 3))
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(0),
                                        "shuffle": jax.random.PRNGKey(1)}, (x0, x0)))
    variables = _randomize(variables, 8)
    pm.load_state_dict(_port_state(pm, variables))
    pm.train()
    params, state = variables["params"], {k: v for k, v in variables.items() if k != "params"}
    ptrs = []
    for step in range(3):
        x1 = rng.randn(8, 16, 16, 3).astype(np.float32)
        x2 = (x1 + 0.5 * rng.randn(8, 16, 16, 3)).astype(np.float32)

        def loss(p):
            out, mut = jm.apply({"params": p, **state}, (jnp.asarray(x1), jnp.asarray(x2)),
                                train=True, mutable=["batch_stats", "ssl"],
                                rngs={"shuffle": jax.random.PRNGKey(10 + step)})
            return out["loss"], (out["acc1"], mut)

        with _recorded_permutations() as perms:
            (want, (want_acc, mut)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        assert len(perms) == 1 and not np.array_equal(perms[0], np.arange(8))
        state = jax.device_get(dict(mut))
        for p in pm.parameters():
            p.grad = None
        with _handed_permutations(perms) as left:
            got = pm((torch.from_numpy(x1), torch.from_numpy(x2)),
                     generator=torch.Generator().manual_seed(0))
        assert not left
        np.testing.assert_allclose(got["loss"].item(), float(want), rtol=F32_TOL)
        assert got["acc1"].item() == float(want_acc)
        got["loss"].backward()
        want_g = _port_grads(jax.device_get(grads))
        for name, p in pm.named_parameters():
            if name.startswith("encoder_k."):  # keys take no gradient
                assert p.grad is None and not np.any(want_g[name]), name
            else:
                _assert_grads_agree(p.grad.numpy(), want_g[name], name)
        want_state = _port_state(pm, {"params": params, **state})
        ptrs.append(int(pm.queue_ptr))
        assert ptrs[-1] == int(want_state["queue_ptr"])
        np.testing.assert_allclose(pm.queue.numpy(), want_state["queue"].numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)
        for key, v in want_state.items():
            if "running" in key:
                np.testing.assert_allclose(pm.state_dict()[key].numpy(), v.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=key)
    assert ptrs == ([8, 16, 0] if K == 24 else [8, 4, 0])


def test_moco_enqueue_clamps_as_dynamic_update_slice_does():
    import jax
    import jax.numpy as jnp

    m = MoCo(**_tiny_moco_kw(10))
    init_module(m, torch.Generator().manual_seed(0))
    queue = jnp.asarray(m.queue.numpy())
    ptr, written = 0, []
    for step in range(4):
        k = torch.nn.functional.normalize(torch.randn(4, 16, generator=torch.Generator()
                                                      .manual_seed(step)), dim=1)
        before = m.queue.clone()
        port_moco.enqueue(m.queue, m.queue_ptr, k)
        queue = jax.lax.dynamic_update_slice(queue, jnp.asarray(k.numpy()).T, (0, ptr))
        ptr = (ptr + 4) % 10
        np.testing.assert_array_equal(m.queue.numpy(), np.asarray(queue))
        assert int(m.queue_ptr) == ptr
        written.append([int(c) for c in torch.nonzero((m.queue != before).any(dim=0))])
    # the third write starts at 8 and is clamped to K - N = 6: never wraps round
    assert written == [[0, 1, 2, 3], [4, 5, 6, 7], [6, 7, 8, 9], [2, 3, 4, 5]]
    with pytest.raises(ValueError, match="does not fit"):
        port_moco.enqueue(m.queue, m.queue_ptr, torch.zeros(11, 16))


def test_moco_eval_neither_shuffles_nor_enqueues():
    m = init_module(MoCo(**_tiny_moco_kw(12)), torch.Generator().manual_seed(0)).eval()
    m.encoder_k.load_state_dict(m.encoder_q.state_dict())  # as the engine starts it
    queue = m.queue.clone()
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with _handed_permutations([]):  # a draw would fail: none is left
        out = m((x, x))
    assert set(out) == {"loss", "acc1"} and out["acc1"].item() == 1.0  # k is q's own image
    assert torch.equal(m.queue, queue) and int(m.queue_ptr) == 0
    with pytest.raises(ValueError, match="generator"):
        m.train()((x, x))


def test_moco_queue_starts_unit_norm_from_the_init_generator():
    a = init_module(MoCo(**_tiny_moco_kw(12)), torch.Generator().manual_seed(3))
    b = init_module(MoCo(**_tiny_moco_kw(12)), torch.Generator().manual_seed(3))
    assert torch.equal(a.queue, b.queue) and a.queue.dtype == torch.float32
    torch.testing.assert_close(a.queue.norm(dim=0), torch.ones(12), rtol=1e-6, atol=1e-6)
    assert a.queue_ptr.dtype == torch.long and int(a.queue_ptr) == 0
    assert a.ema_map() == [("encoder_q", "encoder_k", {"momentum": 0.99})]
    assert a.frozen_patterns() == [r"^encoder_k\."]
    assert build_model({"name": "MoCoV2", **_tiny_moco_kw(12)}).K == 12


def test_converter_carries_the_ssl_collection():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.moco import MoCo as JaxMoCo

    kw = _tiny_moco_kw(12)
    x0 = jnp.zeros((4, 16, 16, 3))
    variables = jax.device_get(JaxMoCo(**kw).init({"params": jax.random.PRNGKey(0),
                                                   "shuffle": jax.random.PRNGKey(1)}, (x0, x0)))
    variables["ssl"]["queue_ptr"] = np.asarray(7, np.int32)
    pm = MoCo(**kw)
    state = _port_state(pm, variables)
    pm.load_state_dict(state)
    np.testing.assert_array_equal(pm.queue.numpy(), np.asarray(variables["ssl"]["queue"]))
    assert pm.queue_ptr.dtype == torch.long and int(pm.queue_ptr) == 7
    with pytest.raises(KeyError, match="queue"):  # every entry must be filled
        flax_to_torch(variables["params"], pm, variables["batch_stats"])
    with pytest.raises(KeyError, match="typo"):  # and every leaf must land
        flax_to_torch(variables["params"], pm, variables["batch_stats"],
                      collections={"ssl": {**variables["ssl"], "typo": np.zeros(1)}})
