"""SimSiam of the PyTorch port against the JAX package.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, 16 x 16 images): the loss, every gradient and the BatchNorm
statistics after one train-mode forward from a converted init (the encoder
runs on each view in a call of its own, so its running statistics move
twice); the negative cosine on bf16 inputs and its stop-gradient; and the
slice as a whole: the tiny SimSiam of configs/simsiam/simsiam_r18_synthetic.yaml
tracks the JAX engine for 3 steps from the converted init on the JAX
loader's batches; the learning check's extract step into the probe's model.
A census builds every SimSiam config's model on the meta device. A test marked `cuda` trains the tiny SimSiam on the card and skips
elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.byol import SimSiam, neg_cosine
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "simsiam", "simsiam_r18_synthetic.yaml")
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


def _assert_grads_agree(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """Within atol 1e-6, or at cosine >= 0.99999 where the tensor is large."""
    if np.allclose(got, want, rtol=0, atol=1e-6):
        return
    cos = float(np.dot(got.ravel(), want.ravel())
                / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
    assert cos >= 0.99999, f"{name}: cosine {cos}, max diff {np.abs(got - want).max()}"


TINY_MODEL = dict(
    backbone={"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1], "num_classes": 0,
              "with_pool": False, "cifar_stem": True},
    neck={"name": "NonLinearNeckfc3", "hid_channels": 32, "out_channels": 16},
    predictor={"name": "NonLinearNeckV2", "hid_channels": 8, "out_channels": 16,
               "with_avg_pool": False})


def test_tiny_simsiam_loss_gradients_and_statistics_match_jax():
    """One train-mode forward and backward from a converted init: the loss,
    every gradient (z detached: the encoder learns through the predictor
    only), and the running statistics after the encoder's two calls."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.byol import SimSiam as JaxSimSiam

    rng = np.random.RandomState(3)
    x1 = rng.randn(8, 16, 16, 3).astype(np.float32)
    x2 = (x1 + 0.5 * rng.randn(8, 16, 16, 3)).astype(np.float32)
    batch = (jnp.asarray(x1), jnp.asarray(x2))
    jm, pm = JaxSimSiam(**TINY_MODEL), SimSiam(**TINY_MODEL)
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b))(batch))
    variables = _randomize(variables, 4)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                            train=True, mutable=["batch_stats"])
        return out["loss"], mut["batch_stats"]

    (want, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    got = pm.train()((torch.from_numpy(x1), torch.from_numpy(x2)))
    assert set(got) == {"loss"} and got["loss"].dtype == torch.float32
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=F32_TOL, atol=1e-7)
    got["loss"].backward()
    want_g = dict(_torch_name(p, a) for p, a in _flatten(jax.device_get(grads)).items())
    assert set(want_g) == {n for n, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _assert_grads_agree(p.grad.numpy(), want_g[name], name)
    moved = 0
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        moved += not np.allclose(arr, _flatten(variables["batch_stats"])[path])
    assert moved == len(_flatten(variables["batch_stats"]))


def test_encoder_statistics_move_once_per_view():
    """Two calls, view 1 first: each running statistic is two chained
    momentum updates, not one over the concatenated views."""
    from passl_tpu_torch.nn.init import init_module

    pm = init_module(SimSiam(**TINY_MODEL), torch.Generator().manual_seed(0)).train()
    bn = pm.encoder.neck.bn3
    seen = []
    bn.register_forward_hook(lambda m, inp, out: seen.append(inp[0].detach().clone()))
    g = torch.Generator().manual_seed(1)
    x1, x2 = torch.randn(2, 6, 16, 16, 3, generator=g)
    pm((x1, x2))
    assert len(seen) == 2
    want = torch.zeros(16)
    for h in seen:
        want = 0.9 * want + 0.1 * h.mean(dim=0)
    torch.testing.assert_close(bn.running_mean, want, rtol=1e-5, atol=1e-7)


def test_neg_cosine_takes_bf16_in_f32_and_detaches_its_target():
    g = torch.Generator().manual_seed(2)
    p = torch.randn(6, 8, generator=g).bfloat16().requires_grad_()
    z = torch.randn(6, 8, generator=g).bfloat16().requires_grad_()
    loss = neg_cosine(p, z)
    assert loss.dtype == torch.float32
    want = -torch.nn.functional.cosine_similarity(p.float(), z.float(), dim=-1).mean()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    loss.backward()
    assert p.grad is not None and z.grad is None


# ----------------------------------------------------- the slice as a whole

TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'NonLinearNeckfc3', 'hid_channels': 64, 'out_channels': 32}",
    "Model.predictor={'name': 'NonLinearNeckV2', 'hid_channels': 16, 'out_channels': 32, "
    "'with_avg_pool': False}",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
    "{'RandomResizedCrop': {'size': 16, 'scale': [0.2, 1.0]}}, "
    "{'ColorJitter': {'brightness': 0.4, 'contrast': 0.4, 'saturation': 0.4, 'hue': 0.1, "
    "'prob': 0.8}}, {'RandomGrayscale': {'prob': 0.2}}, {'RandFlipImage': {'prob': 0.5}}, "
    "{'NormalizeImage': {'scale': 0.00392157}}]}}]",
    "DataLoader.Train.sampler.batch_size=8",
]


def _config(tmp_path, *overrides):
    return cfg_util.get_config(TINY_CFG, overrides=[f"Global.output_dir={tmp_path}", *overrides])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's init (as a torch state_dict file), its first 3 loader
    batches, and its metrics and state after 3 train steps on them."""
    import jax

    from passl_tpu.engine import Engine as JaxEngine

    tmp = tmp_path_factory.mktemp("jax")
    je = JaxEngine(_config(tmp, *TINY), mode="train")
    port = build_model(dict(_config(tmp, *TINY)["Model"]))

    def port_state(params, model_state):
        return flax_to_torch(params, port, model_state["batch_stats"])

    init_file = os.path.join(str(tmp), "init.pt")
    torch.save(port_state(*jax.device_get((je.state.params, je.state.model_state))), init_file)
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == 3:
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


def test_tiny_simsiam_tracks_the_jax_train_step(tmp_path, jax_run):
    """Momentum SGD with L2 weight decay, the config's f32 (no FP16 block):
    the port in f32 beside JAX's f32 engine, and the port in f64 as the
    yardstick of how far f32 resolves each tensor's change (test_torch_simclr.py's
    rule)."""
    init_file, batches, jax_metrics, jax_final = jax_run
    engines = [Engine(_config(tmp_path / name, *TINY, f"Global.pretrained_model={init_file}"),
                      mode="train", device="cpu") for name in ("f32", "f64")]
    e, e64 = engines
    assert e.pretrained_report["loaded"] == set(e.model.state_dict())
    assert type(e.train_loop).__name__ == "ContrastiveLearningTrainingEpochLoop"
    _to_f64(e64.model)
    init = {k: v.detach().clone() for k, v in e.model.state_dict().items()}
    for b, want in zip(batches, jax_metrics):
        got = {k: float(v) for k, v in
               e.train_step(e.state, to_device(e.prepare_batch(b), e.device)).items()}
        got64 = e64.train_step(e64.state, to_device(e64.prepare_batch(b), e64.device))
        assert set(got) == set(want) and "loss" in got and -1.0 <= got["loss"] <= 1.0
        # the loss is a mean of cosines in [-1, 1] that nearly cancel (0.0085 at
        # the first step), which f32 resolves to about 1e-7 of the unit scale, not
        # of the mean: there JAX's f32 lands 2.1e-7 from the port's f64, the
        # port's f32 2.0e-7
        f32_res = abs(got["loss"] - float(got64["loss"]))
        assert abs(got["loss"] - want["loss"]) <= 1e-6 + f32_res
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert e.state.step == 3
    final, final64 = e.model.state_dict(), e64.model.state_dict()
    assert set(final) == set(jax_final)
    eps32 = float(np.finfo(np.float32).eps)
    for name, p in final.items():
        d_port, d_jax = p - init[name], jax_final[name] - init[name]
        # f32's resolution of the change counted for each side: the predictor's
        # first BatchNorm sees the projector's batch-normalized output through a
        # Dense layer, so its running mean holds only f32 rounding (5e-8 after 4
        # steps, 0 in f64), which JAX's f32 carries as much of as the port's
        f32_res = (d_port.double() - (final64[name] - init[name].double())).norm().item()
        tol = 1e-3 * d_jax.norm().item() + 8 * eps32 * p.norm().item() + 1e-8 + 2 * f32_res
        assert (d_port - d_jax).norm().item() <= tol, name
        assert d_jax.abs().max() > 0, name  # every entry of the state moved
    for x in engines:
        x.close()


def test_tiny_simsiam_trains_through_the_cli_on_the_cpu(tmp_path):
    from passl_tpu_torch.tools import train

    argv = ["-c", TINY_CFG, "--device", "cpu", "-o", f"Global.output_dir={tmp_path}",
            "-o", "Global.max_train_step=2", "-o", "Global.print_batch_step=1"]
    for o in TINY:
        argv += ["-o", o]
    e = train.main(argv)
    losses = [h["loss"] for h in e.train_loop.history]
    assert len(losses) == 2 and all(-1.0 <= v <= 1.0 for v in losses)
    assert os.path.exists(os.path.join(str(tmp_path), "latest.pt"))


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(REPO, "configs", "simsiam", "*.yaml"))) + [
    os.path.join(REPO, "tests", "e2e", "simsiam_structured.yaml")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_simsiam_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == model_cfg["name"]
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_weights_fills_the_structured_probe(tmp_path):
    """The learning check's extract step: the backbone of
    tests/e2e/simsiam_structured.yaml's model under `encoder.backbone` fills every
    backbone entry of tests/e2e/probe_structured.yaml's model."""
    from passl_tpu_torch.nn.init import init_module
    from passl_tpu_torch.tools import extract_weights

    structured = os.path.join(REPO, "tests", "e2e", "simsiam_structured.yaml")
    model = init_module(build_model(dict(cfg_util.get_config(structured)["Model"])),
                        torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "latest.pt")
    torch.save({"model": model.state_dict(), "step": 0}, ckpt)
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "encoder.backbone", "--rename",
                                   "backbone", "--output", str(tmp_path / "backbone.pt"),
                                   "--check-config",
                                   os.path.join(REPO, "tests", "e2e", "probe_structured.yaml")])
    want = model.get_submodule("encoder.backbone").state_dict()
    assert set(picked) == {f"backbone.{k}" for k in want}


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_simsiam_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(_config(tmp_path, *TINY, "Global.max_train_step=2", "Global.print_batch_step=1"),
               mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert next(e.model.parameters()).device.type == "cuda"
