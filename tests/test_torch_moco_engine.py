"""MoCo v1/v2 of the PyTorch port against the JAX engine: the slice as a whole.

On the CPU, at tiny sizes: the tiny MoCo v2 of
configs/moco/mocov2_r18_synthetic.yaml tracks the JAX engine for 4 steps on
the same permutations; a non-finite fp16 step that keeps the queue and the
pointer; resume; and MoCo v1 and v2 through `tools/train`. A test marked
`cuda` trains the tiny MoCo v2 on the card and skips elsewhere. The
model-level tests (SplitBatchNorm, MoCo's steps on JAX's permutations, the
queue, the converter) are in tests/test_torch_moco.py, whose helpers this
file shares: the two files run on two workers.
"""
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import to_device
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils import io as port_io
from test_torch_moco import (_handed_permutations, _one_openmp_thread,  # noqa: F401 (autouse)
                             _port_state, _recorded_permutations)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "moco", "mocov2_r18_synthetic.yaml")


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
