"""MoCo v1/v2 of the PyTorch port against the JAX package.

On the CPU, at tiny sizes: `SplitBatchNorm` against JAX's at 1, 2, 4 and 8
splits of 8 images and at 4 splits of 6 (the gcd rule takes 2), in training
(output, gradients, running statistics) and in eval; a tiny `bn_splits`
ResNet; `info_nce_logits`; MoCo's train steps with the permutation JAX drew
handed to the port (loss, `acc1`, gradients, the queue, the pointer and
both encoders' statistics), once where K is a multiple of N and once where
JAX's `dynamic_update_slice` clamps the write to K - N; the converter on the
`ssl` collection; a non-finite fp16 step that keeps the queue and the
pointer; resume; and the slice as a whole: the tiny MoCo v2 of
configs/moco/mocov2_r18_synthetic.yaml tracks the JAX engine for 4 steps on
the same permutations. A test marked `cuda` trains the tiny MoCo v2 on the
card and skips elsewhere.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import passl_tpu_torch.models.moco as port_moco
from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.moco import MoCo, info_nce_logits
from passl_tpu_torch.models.resnet import ResNet
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.nn.norm import SplitBatchNorm
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils import io as port_io
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "moco", "mocov2_r18_synthetic.yaml")
F32_TOL = 1e-5


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
        m._enqueue(k)
        queue = jax.lax.dynamic_update_slice(queue, jnp.asarray(k.numpy()).T, (0, ptr))
        ptr = (ptr + 4) % 10
        np.testing.assert_array_equal(m.queue.numpy(), np.asarray(queue))
        assert int(m.queue_ptr) == ptr
        written.append([int(c) for c in torch.nonzero((m.queue != before).any(dim=0))])
    # the third write starts at 8 and is clamped to K - N = 6: never wraps round
    assert written == [[0, 1, 2, 3], [4, 5, 6, 7], [6, 7, 8, 9], [2, 3, 4, 5]]
    with pytest.raises(ValueError, match="does not fit"):
        m._enqueue(torch.zeros(11, 16))


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


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True, 'bn_splits': 4}",
    "Model.neck={'name': 'NonLinearNeckV1', 'hid_channels': 64, 'out_channels': 32}",
    "Model.dim=32", "Model.K=20",
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
    """The JAX engine's init (as a torch state_dict file), its first 4 loader
    batches, the permutations its 4 train steps drew, and its metrics and
    state after them."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))

    def port_state(state):
        return _port_state(port, jax.device_get({"params": state.params, **state.model_state}))

    with _recorded_permutations() as perms:
        je = JaxEngine(_config(tmp, *PARITY), mode="train")
        jax.effects_barrier()
        init_file = os.path.join(str(tmp), "init.pt")
        torch.save(port_state(je.state), init_file)
        je.train_dataloader.set_epoch(1)
        batches = []
        for b in je.train_dataloader:
            batches.append(b)
            if len(batches) == 4:
                break
        n_init = len(perms)
        metrics = []
        for b in batches:
            je.state, m = je.train_step(je.state, je.shard_batch(b))
            metrics.append({k: float(v) for k, v in m.items()})
        jax.effects_barrier()
        step_perms = perms[n_init:]
    final = port_state(je.state)
    je.train_dataloader.close()
    return init_file, batches, step_perms, metrics, final


def _to_f64(model: torch.nn.Module) -> None:
    """Every parameter, buffer and compute dtype of `model` in float64."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64


def test_tiny_mocov2_tracks_the_jax_train_step(tmp_path, jax_run):
    """The port in f32 beside JAX's f32 engine, and the port in f64 as the
    yardstick of how far f32 resolves this run: at 8 images in 4 splits the
    trajectory is sensitive (from one state, the port's f32 and f64 gradients
    agree to 5e-6, yet after 4 steps a BatchNorm bias of layer 2 parts by
    1%, JAX's f32 from the f64 run as much). oneDNN's f32 convolutions on the
    CPU round further still (0.2% on layer 1's BatchNorm gradients at the
    init, 30% by step 4): the comparison runs on PyTorch's own convolutions."""
    init_file, batches, perms, jax_metrics, jax_final = jax_run
    assert len(perms) == 4
    engines = [Engine(_config(tmp_path / name, *PARITY, f"Global.pretrained_model={init_file}"),
                      mode="train", device="cpu") for name in ("f32", "f64")]
    e, e64 = engines
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    _to_f64(e64.model)
    init = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
    with torch.backends.mkldnn.flags(enabled=False), _handed_permutations(
            [p for p in perms for _ in engines]) as left:
        for b, want in zip(batches, jax_metrics):
            got = {k: float(v) for k, v in
                   e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
            got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
            assert set(got) == set(want) and {"loss", "acc1"} <= set(got)
            f32_res = abs(got["loss"] - float(got64["loss"]))
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + f32_res
            assert got["acc1"] == want["acc1"]
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], atol=1e-6)
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert not left and e.state.step == 4
    # the key encoder got no optimizer state
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert all((id(p) in stateful) != n.startswith("encoder_k.")
               for n, p in e.model.named_parameters())
    final, final64 = e.model.state_dict(), e64.model.state_dict()
    assert set(final) == set(jax_final)
    # 4 writes of 8 keys into K = 20: 0, 8, 16 clamped to 12, then 4
    assert int(final["queue_ptr"]) == int(jax_final["queue_ptr"]) == 12
    eps32 = float(np.finfo(np.float32).eps)
    for name, p in final.items():
        if name == "queue_ptr":
            continue
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # test_torch_byol.py's rule, each tensor's change within 1e-3 of its
        # norm beside 8 f32 roundings of the tensor itself, and beside the f32
        # resolution of that change, the port's f32 run from its f64 run
        f32_res = (d_port.double() - (final64[name] - init[name].double())).norm().item()
        tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + f32_res
        assert (d_port - d_jax).norm().item() <= tol, name
    for x in engines:
        x.close()


@pytest.fixture
def fp16_config(tmp_path):
    return _config(tmp_path, *TINY, "FP16.dtype=float16",
                   "FP16.GradScaler={'init_loss_scaling': 1.0e38}")


def test_a_non_finite_fp16_step_keeps_the_queue_and_the_pointer(fp16_config):
    e = Engine(fp16_config, mode="train", device="cpu")
    assert e.scaler is not None
    before = {k: v.clone() for k, v in e.model.state_dict().items()}
    batch = next(iter(e.train_dataloader))
    metrics = e.train_step(e.state, to_device(e.prepare_batch(batch), e.device))
    assert np.isfinite(float(metrics["loss"]))  # the loss is, its scaled gradients are not
    assert e.state.scaler_state.scale < 1.0e38 and e.state.step == 1
    after = e.model.state_dict()
    assert int(after["queue_ptr"]) == 0
    for k, v in before.items():  # parameters, BN statistics, queue and pointer
        assert torch.equal(after[k], v), k
    e.close()


def test_checkpoint_resumes_with_the_queue_and_the_pointer(tmp_path):
    run = tmp_path / "run"
    e = Engine(_config(run, *TINY, "Global.max_train_step=2"), mode="train", device="cpu")
    e.train()
    saved = {k: e.model.state_dict()[k].clone() for k in ("queue", "queue_ptr")}
    assert int(saved["queue_ptr"]) == 16
    r = Engine(_config(tmp_path / "again", *TINY), mode="train", device="cpu")
    port_io.load_checkpoint(str(run / "latest.pt"), r.state)
    assert r.state.step == 2
    for k, v in saved.items():
        assert torch.equal(r.model.state_dict()[k], v), k
    r.close()
    c = Engine(_config(tmp_path / "resume", *TINY, f"Global.checkpoint={run / 'latest.pt'}",
                       "Global.max_train_step=3", "Global.print_batch_step=1"), mode="train",
               device="cpu")
    c.train()
    hist = c.train_loop.history
    assert len(hist) == 1 and hist[0]["step"] == 3 and np.isfinite(hist[0]["loss"])
    assert int(c.model.queue_ptr) == 4  # 16 clamped to 12, then (16 + 8) % 20


# MoCo v1: its own LinearNeck and no bn_splits, the tiny backbone and data
V1 = ["Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
      "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}", *TINY[3:]]


@pytest.mark.parametrize("cfg, overrides", [("mocov1_r18_synthetic.yaml", V1),
                                            ("mocov2_r18_synthetic.yaml", TINY)],
                         ids=["mocov1", "mocov2"])
def test_tiny_moco_trains_through_the_cli_on_the_cpu(tmp_path, cfg, overrides):
    from passl_tpu_torch.tools import train

    argv = ["-c", os.path.join(REPO, "configs", "moco", cfg), "--device", "cpu",
            "-o", f"Global.output_dir={tmp_path}", "-o", "Global.max_train_step=2",
            "-o", "Global.print_batch_step=1"]
    for o in overrides:
        argv += ["-o", o]
    e = train.main(argv)
    hist = e.train_loop.history
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and 0 <= h["acc1"] <= 1 for h in hist)
    assert e.policy.compute_dtype == torch.bfloat16 and int(e.model.queue_ptr) == 16


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_mocov2_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert e.model.queue.device.type == "cuda" and int(e.model.queue_ptr) == 16
