"""SwAV of the PyTorch port against the JAX engine: the slice as a whole, and
the engine's config-regex grouping.

On the CPU, at tiny sizes (a basic ResNet with one block a stage and the
CIFAR stem, crops of 16 and 8 px): unit-norm prototypes at init and after
every step through the engine, frozen for `freeze_prototypes_iter` steps;
the data path's crop lists; the tiny SwAV of
configs/swav/swav_r18_synthetic.yaml takes each of the JAX engine's first 3
steps, across its prototype freeze of 2, from JAX's state on the JAX
loader's batch; the optimizer groups of a config's regexes (flax paths such
as `^prototypes/`) against the JAX builder's on nine configs; the learning
check's extract step into the probe's model. A census builds every SwAV
config's model on the meta device. A test marked `cuda` trains the tiny
SwAV on the card and skips elsewhere. The model-level tests (sinkhorn,
`SwAVNeck`, the loss, gradients and statistics, the hooks) are in
tests/test_torch_swav.py: the two files run on two workers.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_path, flax_to_torch
from test_torch_moco import _one_openmp_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "swav", "swav_r18_synthetic.yaml")


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
