"""MoCo-BYOL of the PyTorch port against the JAX package.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, 16 x 16 images): three train-mode forwards and backwards from a
converted init on the JAX queue (the converter's `ssl` collection): both
loss parts, the total, the online tower's and the predictor's gradients,
the queue, the pointer and both towers' BatchNorm statistics, with a write
that JAX's `dynamic_update_slice` clamps to K - N; no enqueue in eval; a non-finite fp16 step that keeps the
queue and the pointer; resume; and the slice as a whole: the tiny MoCo-BYOL
of configs/moco_byol/moco_byol_r18_synthetic.yaml takes each of the JAX
engine's first 3 steps from JAX's state on the JAX loader's batch; the
learning check's extract step into the probe's model. A census builds every
MoCo-BYOL config's model on the meta device. A test marked `cuda`
trains the tiny MoCo-BYOL on the card and skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.pixpro import MoCoBYOL
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils import io as port_io
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "moco_byol", "moco_byol_r18_synthetic.yaml")
# f32 forward against XLA's: the same f32 math summed in another order
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


def _assert_grads_agree(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """Within atol 1e-6, or at cosine >= 0.99999 where the tensor is large."""
    if np.allclose(got, want, rtol=0, atol=1e-6):
        return
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    assert cos >= 0.99999, f"{name}: cosine {cos}, max diff {np.abs(got - want).max()}"


def _port_state(model, variables) -> dict:
    return flax_to_torch(variables["params"], model, variables["batch_stats"],
                         collections={"ssl": variables["ssl"]})


def _tiny_kw(K: int) -> dict:
    return dict(backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1],
                          "num_classes": 0, "with_pool": False, "cifar_stem": True},
                neck={"name": "NonLinearNeckV3", "hid_channels": 32, "out_channels": 16},
                predictor={"name": "NonLinearNeckV3", "hid_channels": 32, "out_channels": 16,
                           "with_avg_pool": False},
                dim=16, K=K, m=0.99, T=0.2, byol_weight=0.7, contrast_weight=1.3)


def test_mocobyol_steps_match_jax_on_its_queue():
    """Three train-mode forwards and backwards of 8 images from one converted
    init (the target tower randomized apart from the online one): both loss
    parts and their weighted sum, the gradients, the queue and pointer, both
    towers' statistics. With K = 12 the second write starts at ptr 8 and JAX
    clamps it to K - N = 4; the third starts at 4."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.pixpro import MoCoBYOL as JaxMoCoBYOL

    rng = np.random.RandomState(7)
    kw = _tiny_kw(12)
    jm, pm = JaxMoCoBYOL(**kw), MoCoBYOL(**kw)
    x0 = jnp.zeros((8, 16, 16, 3))
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b))((x0, x0)))
    variables = _randomize(variables, 8)
    pm.load_state_dict(_port_state(pm, variables))
    pm.train()
    params, state = variables["params"], {k: v for k, v in variables.items() if k != "params"}

    @jax.jit
    def jax_step(params, state, x1, x2):
        def loss(p):
            out, mut = jm.apply({"params": p, **state}, (x1, x2), train=True,
                                mutable=["batch_stats", "ssl"])
            return out["loss"], (out, mut)

        return jax.value_and_grad(loss, has_aux=True)(params)

    ptrs = []
    for step in range(3):
        x1 = rng.randn(8, 16, 16, 3).astype(np.float32)
        x2 = (x1 + 0.5 * rng.randn(8, 16, 16, 3)).astype(np.float32)
        (_, (want, mut)), grads = jax_step(params, state, x1, x2)
        state = jax.device_get(dict(mut))
        for p in pm.parameters():
            p.grad = None
        got = pm((torch.from_numpy(x1), torch.from_numpy(x2)))
        assert set(got) == {"loss", "byol_loss", "contrast_loss"}
        for k in got:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=F32_TOL, err_msg=k)
        torch.testing.assert_close(got["loss"], 0.7 * got["byol_loss"] + 1.3 * got["contrast_loss"])
        got["loss"].backward()
        want_g = dict(_torch_name(p, a) for p, a in _flatten(jax.device_get(grads)).items())
        for name, p in pm.named_parameters():
            if name.startswith("target."):  # the target takes no gradient
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
    assert ptrs == [8, 4, 0]


def test_mocobyol_eval_does_not_enqueue():
    m = init_module(MoCoBYOL(**_tiny_kw(12)), torch.Generator().manual_seed(0)).eval()
    queue = m.queue.clone()
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    out = m((x, x))
    assert set(out) == {"loss", "byol_loss", "contrast_loss"}
    assert all(torch.isfinite(v) for v in out.values())
    assert torch.equal(m.queue, queue) and int(m.queue_ptr) == 0
    m.train()((x, x))
    assert int(m.queue_ptr) == 4 and not torch.equal(m.queue, queue)


def test_mocobyol_queue_hooks_and_registration():
    a = init_module(MoCoBYOL(**_tiny_kw(12)), torch.Generator().manual_seed(3))
    b = init_module(MoCoBYOL(**_tiny_kw(12)), torch.Generator().manual_seed(3))
    assert torch.equal(a.queue, b.queue) and a.queue.dtype == torch.float32
    torch.testing.assert_close(a.queue.norm(dim=0), torch.ones(12), rtol=1e-6, atol=1e-6)
    assert a.queue_ptr.dtype == torch.long and int(a.queue_ptr) == 0
    assert a.ema_map() == [("online", "target", {"momentum": 0.99, "schedule": "cosine"})]
    assert a.frozen_patterns() == [r"^target\."]
    assert not any(n.startswith("target.predictor") for n, _ in a.named_parameters())
    assert build_model({"name": "MoCoBYOL", **_tiny_kw(12)}).K == 12


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'NonLinearNeckV3', 'hid_channels': 64, 'out_channels': 32}",
    "Model.predictor={'name': 'NonLinearNeckV3', 'hid_channels': 64, 'out_channels': 32, "
    "'with_avg_pool': False}",
    "Model.K=20",
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


def _port_buffers(opt_state, dtype=np.float32) -> dict:
    """The JAX rule's momentum buffers as the port's, by parameter name."""
    out = {}
    for path, leaf in _flatten(opt_state).items():
        if path.endswith("/buf"):
            name, arr = _torch_name(path[:-len("/buf")], leaf)
            out[name] = torch.from_numpy(np.array(arr, dtype))
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's first 3 loader batches, its metrics on them, and its
    state (parameters, statistics, queue, momentum buffers) before each of its
    3 train steps and after the last, in the port's names and layouts; and
    the momentum buffers after each of those steps taken in f64 from the same
    state (the model at float64 under `jax.enable_x64(True)`, a context,
    so no later test of the worker sees x64): JAX's own f32 rounding of each
    buffer is its distance from them."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    port = build_model(dict(_config(tmp, *PARITY)["Model"]))

    def port_state(state):
        state = jax.device_get(state)
        return (_port_state(port, {"params": state.params, **state.model_state}),
                _port_buffers(state.opt_state))

    je = JaxEngine(_config(tmp, *PARITY), mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == 3:
            break
    metrics, states, raw = [], [port_state(je.state)], [jax.device_get(je.state)]
    for b in batches:
        je.state, m = je.train_step(je.state, je.shard_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(port_state(je.state))
        raw.append(jax.device_get(je.state))
    je.train_dataloader.close()

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)

    bufs64 = []
    with jax.enable_x64(True):  # the context of jax 0.9 (jax.experimental's is gone)
        je64 = JaxEngine(_config(tmp_path_factory.mktemp("jax64"), *PARITY, "Model.dtype=float64"),
                         mode="train")
        for t, b in enumerate(batches):
            start = raw[t]
            # the queue stays f32 (the JAX model writes its f32 keys into it), its
            # pointer goes to int64 beside the x64 literal start index of its write
            ssl = {"queue": start.model_state["ssl"]["queue"],
                   "queue_ptr": np.asarray(start.model_state["ssl"]["queue_ptr"], np.int64)}
            model_state = {k: ssl if k == "ssl" else f64(v) for k, v in start.model_state.items()}
            state = je64.state.replace(step=start.step, rng=start.rng, params=f64(start.params),
                                       model_state=model_state, opt_state=f64(start.opt_state))
            state, _ = je64.train_step(state, je64.shard_batch(b))
            bufs64.append(_port_buffers(jax.device_get(state.opt_state), np.float64))
        je64.train_dataloader.close()
    return batches, metrics, states, bufs64


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


def test_tiny_mocobyol_steps_along_the_jax_engine(tmp_path, jax_run):
    """Each of the JAX engine's 3 train steps, from JAX's state before it: the
    metrics, and every parameter, statistic, the queue, its pointer and every
    momentum buffer after it. The port in f64 from the same state is the
    yardstick of how far f32 resolves each change (test_torch_moco.py's rule,
    on PyTorch's own convolutions: oneDNN's f32 ones round coarser). A free
    run would measure rounding, not the port: at 8 images the f32 and f64
    trajectories of the port alone part by 4% in some BatchNorm biases
    after 4 steps, as a BatchNorm bias's gradient is a small remainder of
    large sums."""
    batches, jax_metrics, states, jax_bufs64 = jax_run
    engines = [Engine(_config(tmp_path / name, *PARITY), mode="train", device="cpu")
               for name in ("f32", "f64")]
    e, e64 = engines
    _to_f64(e64.model)
    eps32 = float(np.finfo(np.float32).eps)
    ptrs = []
    with torch.backends.mkldnn.flags(enabled=False):
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            for x in engines:
                _force(x, states[t], t)
            got = {k: float(v) for k, v in
                   e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
            got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
            assert set(got) == set(want) and {"loss", "byol_loss", "contrast_loss"} <= set(got)
            for k in ("loss", "byol_loss", "contrast_loss"):
                f32_res = abs(got[k] - float(got64[k]))
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) + f32_res, (t, k)
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
            before, (after, bufs_after) = states[t][0], states[t + 1]
            final, final64 = e.model.state_dict(), e64.model.state_dict()
            assert set(final) == set(after)
            ptrs.append(int(final["queue_ptr"]))
            assert ptrs[-1] == int(after["queue_ptr"])
            for name, p in final.items():
                if name == "queue_ptr":
                    continue
                d_port, d_jax = p - before[name], after[name] - before[name]
                # test_torch_byol.py's rule: each tensor's change within 1e-3 of its
                # norm, beside 8 f32 roundings of the tensor, and beside the f32
                # resolution of that change, the port's f32 step from its f64 step
                # (counted for each side: the predictor's first BatchNorm sees the
                # projector's batch-normalized output through a Dense layer, so its
                # running mean holds only f32 rounding, 0 in f64, which JAX's f32
                # carries as much of as the port's)
                f32_res = (d_port.double() - (final64[name] - before[name].double())).norm().item()
                tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + 2 * f32_res
                assert (d_port - d_jax).norm().item() <= tol, (t, name)
            # the momentum buffers, each within 1e-3 of its norm beside twice JAX's
            # own f32 resolution of it, its f32 step's distance from its f64 step
            # from the same state (a Dense bias before a BatchNorm has a gradient
            # of f32 rounding alone, 0 in f64: JAX's rounding of it measures how
            # far two f32 steps may part there, whatever the port's threads)
            bufs = _buffers(e)
            assert set(bufs) == set(bufs_after) == set(jax_bufs64[t])
            assert not any(n.startswith("target.") for n in bufs_after)  # frozen: no state
            for name, buf in bufs_after.items():
                jax_res = (buf.double() - jax_bufs64[t][name]).norm().item()
                tol = 1e-3 * buf.norm().item() + 1e-8 + 2 * jax_res
                assert (bufs[name] - buf).norm().item() <= tol, (t, name)
    # 3 writes of 8 keys into K = 20: 0, 8, then 16 clamped to 12
    assert ptrs == [8, 16, 4]
    for x in engines:
        x.close()


def test_a_non_finite_fp16_step_keeps_the_queue_and_the_pointer(tmp_path):
    e = Engine(_config(tmp_path, *TINY, "FP16.dtype=float16",
                       "FP16.GradScaler={'init_loss_scaling': 1.0e38}"), mode="train", device="cpu")
    assert e.scaler is not None
    before = {k: v.clone() for k, v in e.model.state_dict().items()}
    batch = next(iter(e.train_dataloader))
    metrics = e.train_step(e.state, to_device(e.prepare_batch(batch), e.device))
    assert np.isfinite(float(metrics["loss"]))  # the loss is, its scaled gradients are not
    assert e.state.scaler_state.scale < 1.0e38 and e.state.step == 1
    after = e.model.state_dict()
    for k, v in before.items():  # parameters, BN statistics, queue and pointer
        assert torch.equal(after[k], v), k
    assert not e.optimizer.torch_optimizer.state  # no momentum buffer was made
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
    assert {"byol_loss", "contrast_loss"} <= set(hist[0])
    assert int(c.model.queue_ptr) == 4  # 16 clamped to 12, then (16 + 8) % 20


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "moco_byol", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "mocobyol_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_mocobyol_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == model_cfg["name"]
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_weights_fills_the_structured_probe(tmp_path):
    """The learning check's extract step: the backbone of
    tests/e2e/mocobyol_structured.yaml's model under `online.backbone` fills every
    backbone entry of tests/e2e/probe_structured.yaml's model."""
    from passl_tpu_torch.nn.init import init_module
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "mocobyol_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "online.backbone", "--rename",
                                   "backbone", "--output", str(tmp_path / "backbone.pt"),
                                   "--check-config",
                                   os.path.join(REPO, "tests", "e2e", "probe_structured.yaml")])
    want = model.get_submodule("online.backbone").state_dict()
    assert set(picked) == {f"backbone.{k}" for k in want}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_mocobyol_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert e.model.queue.device.type == "cuda" and int(e.model.queue_ptr) == 16
