"""The linear probe of the PyTorch port: `Classification` and `LinearProbe`
against the JAX package, `tools/extract_weights`, and the configs that use
them.

On the CPU, at tiny sizes: `Classification` and `LinearProbe` logits (and,
unfrozen, gradients and BatchNorm statistics) from a converted init; a probe
train step leaves the frozen backbone's parameters and BatchNorm buffers
bitwise as they were, and only `fc` gets optimizer state; `fc`'s init; the
round trip of a tiny SimCLR checkpoint through `extract_weights` into a
`LinearProbe` config, which takes every backbone entry and gives the SimCLR
backbone's features; two CLI steps of
configs/moco/mocov2_r18_linearprobe_synthetic.yaml over a tiny MoCo's
extracted backbone; the export of that probe served by `Predictor`; and a
census: every SimCLR, MoCo and LinearProbe config builds on the meta device.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.engine.inference import Predictor
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models.classification import Classification, LinearProbe
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.tools import export, extract_weights
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_CFG = os.path.join(REPO, "configs", "moco", "mocov2_r18_linearprobe_synthetic.yaml")
SIMCLR_CFG = os.path.join(REPO, "configs", "simclr", "simclr_r18_synthetic.yaml")
MOCO_CFG = os.path.join(REPO, "configs", "moco", "mocov2_r18_synthetic.yaml")
F32_TOL = 1e-5

TINY_BACKBONE = {"name": "ResNet", "block": "basic", "layers": [1, 1, 1, 1], "num_classes": 0,
                 "cifar_stem": True}


def _randomize(tree, seed):
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


# -------------------------------------------------------------- the models


@pytest.mark.parametrize("freeze", [True, False], ids=["LinearProbe", "Classification"])
def test_probe_logits_match_jax(freeze):
    """Train-mode logits; a frozen backbone normalizes with its running
    statistics and leaves them, an unfrozen one trains as usual."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.classification import Classification as JaxClassification
    from passl_tpu.models.classification import LinearProbe as JaxLinearProbe

    kw = dict(backbone=TINY_BACKBONE, num_classes=5)
    jm = (JaxLinearProbe if freeze else JaxClassification)(**kw)
    pm = (LinearProbe if freeze else Classification)(**kw)
    assert pm.freeze_backbone == freeze
    x = np.random.RandomState(1).randn(8, 16, 16, 3).astype(np.float32)
    variables = jax.device_get(jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x))(
        jnp.asarray(x)))
    variables = _randomize(variables, 2)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables["batch_stats"]))
    w = np.random.RandomState(3).randn(8, 5).astype(np.float32)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    got = pm.train()(torch.from_numpy(x))
    assert pm.training and pm.backbone.training != freeze
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = dict(_torch_name(p, a) for p, a in _flatten(jax.device_get(grads)).items())
    for name, p in pm.named_parameters():
        if freeze and name.startswith("backbone."):
            assert p.grad is None and not np.any(want_g[name]), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=1e-4,
                                       atol=1e-4 * np.abs(want_g[name]).max(), err_msg=name)
    for path, arr in _flatten(jax.device_get(stats)).items():
        key, arr = _torch_name(path, arr, stats=True)
        np.testing.assert_allclose(pm.state_dict()[key].numpy(), arr, rtol=1e-5, atol=1e-6)
        assert torch.equal(pm.state_dict()[key], before[key]) == freeze, key
    assert pm.frozen_patterns() == ([r"^backbone\."] if freeze else [])


def test_fc_starts_normal_at_head_init_std_with_a_zero_bias():
    pm = init_module(LinearProbe(backbone={"name": "resnet18", "num_classes": 0},
                                 num_classes=1000), torch.Generator().manual_seed(0))
    w = pm.fc.weight.detach()
    assert tuple(w.shape) == (1000, 512) and not pm.fc.bias.any()
    assert abs(w.std().item() - 0.01) < 2e-4 and abs(w.mean().item()) < 2e-4
    assert w.abs().max().item() > 3.5 * 0.01  # a normal, not the truncated lecun default
    q = init_module(LinearProbe(backbone={"name": "resnet18", "num_classes": 0},
                                num_classes=1000, head_init_std=0.1),
                    torch.Generator().manual_seed(0))
    assert abs(q.fc.weight.std().item() - 0.1) < 2e-3


# ------------------------------------------------------------ the probe step

TINY_PROBE = [
    f"Model.backbone={dict(TINY_BACKBONE, bn_splits=8)}",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'RandomResizedCrop': {'size': 16}}, "
    "{'RandFlipImage': {'prob': 0.5}}, {'NormalizeImage': {'scale': 0.00392157}}]",
    "DataLoader.Train.sampler.batch_size=8",
    "DataLoader.Eval.dataset.image_size=16", "DataLoader.Eval.dataset.size=16",
    "DataLoader.Eval.sampler.batch_size=8",
]


def _probe_config(tmp_path, *overrides):
    return cfg_util.get_config(PROBE_CFG, overrides=[f"Global.output_dir={tmp_path}",
                                                     "Global.pretrained_model=None",
                                                     *TINY_PROBE, *overrides])


def test_a_probe_step_leaves_the_frozen_backbone_bitwise(tmp_path):
    e = Engine(_probe_config(tmp_path), mode="train", device="cpu")
    before = {k: v.clone() for k, v in e.model.state_dict().items()}
    e.train_loop.train_one_epoch(1)  # every batch of the epoch, the model in train mode
    assert e.state.step == len(e.train_dataloader) >= 2
    after = e.model.state_dict()
    for k, v in before.items():  # parameters and BatchNorm buffers alike
        assert torch.equal(after[k], v) != k.startswith("fc."), k
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert {n for n, p in e.model.named_parameters() if id(p) in stateful} == {"fc.weight",
                                                                             "fc.bias"}
    e.close()


# ------------------------------------------------------------ extract_weights

SIMCLR_TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True}",
    "Model.neck={'name': 'NonLinearNeckfc3', 'hid_channels': 32, 'out_channels': 16}",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
    "{'RandomResizedCrop': {'size': 16}}, {'NormalizeImage': {'scale': 0.00392157}}]}}]",
    "DataLoader.Train.sampler.batch_size=8", "FP16.enable=False",
    "Global.max_train_step=2",
]


@pytest.fixture
def tiny_probe_yaml(tmp_path):
    """mocov2_r18_linearprobe_synthetic.yaml over the tiny backbone, as a file."""
    import yaml

    with open(PROBE_CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"]["backbone"] = dict(TINY_BACKBONE, bn_splits=8)
    path = tmp_path / "probe_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def simclr_run(tmp_path_factory):
    """A tiny SimCLR trained 2 steps on the CPU: its engine and checkpoint."""
    tmp = tmp_path_factory.mktemp("simclr")
    e = Engine(cfg_util.get_config(SIMCLR_CFG, overrides=[f"Global.output_dir={tmp}",
                                                          *SIMCLR_TINY]),
               mode="train", device="cpu")
    e.train()
    return e, os.path.join(str(tmp), "latest.pt")


def test_extract_weights_round_trip_into_a_linear_probe(tmp_path, simclr_run, tiny_probe_yaml):
    simclr, ckpt = simclr_run
    out = str(tmp_path / "backbone.pt")
    picked = extract_weights.main(["--checkpoint", ckpt, "--prefix", "backbone", "--rename",
                                   "backbone", "--output", out, "--check-config",
                                   tiny_probe_yaml])
    want = {f"backbone.{k}": v for k, v in simclr.model.backbone.state_dict().items()}
    assert set(picked) == set(want) and all(torch.equal(picked[k], v) for k, v in want.items())
    assert sum(k.endswith("running_var") for k in picked) == 1 + 2 * 4 + 3  # BN stats travel
    e = Engine(_probe_config(tmp_path / "probe", f"Global.pretrained_model={out}",
                             f"Model.backbone={dict(TINY_BACKBONE)}"), mode="eval",
               device="cpu")
    assert e.pretrained_report["loaded"] == {k for k in e.model.state_dict()
                                             if k.startswith("backbone.")}
    assert sorted(e.pretrained_report["missing"]) == ["fc.bias", "fc.weight"]
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = e.model.eval().backbone(x)
        want_feats = simclr.model.eval().backbone(x).mean(dim=(1, 2))  # SimCLR's has no pool
    torch.testing.assert_close(got, want_feats, rtol=1e-6, atol=1e-6)
    e.close()


def test_extract_weights_keeps_the_prefix_and_names_what_exists(tmp_path, simclr_run,
                                                                tiny_probe_yaml):
    _, ckpt = simclr_run
    kept = extract_weights.main(["--checkpoint", ckpt, "--prefix", "neck/", "--no-strip-prefix",
                                 "--output", str(tmp_path / "neck.pt")])
    assert kept and all(k.startswith("neck.") for k in kept)
    assert set(torch.load(str(tmp_path / "neck.pt"), weights_only=True)) == set(kept)
    with pytest.raises(SystemExit, match=r"top-level names: \['backbone', 'neck'\]"):
        extract_weights.main(["--checkpoint", ckpt, "--prefix", "encoder_q.backbone",
                              "--output", str(tmp_path / "none.pt")])
    # a file that does not fill the probe: another module, or another depth
    for prefix, cfg in (("neck", tiny_probe_yaml), ("backbone", PROBE_CFG)):
        with pytest.raises(SystemExit, match=r"unfilled: \['backbone\."):
            extract_weights.main(["--checkpoint", ckpt, "--prefix", prefix, "--rename",
                                  "backbone", "--output", str(tmp_path / "wrong.pt"),
                                  "--check-config", cfg])


MOCO_TINY = [
    "Model.backbone={'name': 'ResNet', 'block': 'basic', 'layers': [1, 1, 1, 1], "
    "'num_classes': 0, 'with_pool': False, 'cifar_stem': True, 'bn_splits': 4}",
    "Model.neck={'name': 'NonLinearNeckV1', 'hid_channels': 32, 'out_channels': 16}",
    "Model.dim=16", "Model.K=32",
    "DataLoader.Train.dataset.image_size=16",
    "DataLoader.Train.dataset.transform=[{'TwoViewsTransform': {'base_transform1': ["
    "{'RandomResizedCrop': {'size': 16}}, {'NormalizeImage': {'scale': 0.00392157}}]}}]",
    "DataLoader.Train.sampler.batch_size=8", "Global.max_train_step=1",
]


@pytest.fixture(scope="module")
def moco_backbone(tmp_path_factory):
    """A tiny MoCo v2 trained one step, its query backbone extracted."""
    tmp = tmp_path_factory.mktemp("moco")
    e = Engine(cfg_util.get_config(MOCO_CFG, overrides=[f"Global.output_dir={tmp}", *MOCO_TINY]),
               mode="train", device="cpu")
    e.train()
    out = os.path.join(str(tmp), "backbone.pt")
    extract_weights.main(["--checkpoint", os.path.join(str(tmp), "latest.pt"), "--prefix",
                          "encoder_q.backbone", "--rename", "backbone", "--output", out])
    return out


def test_linear_probe_config_trains_through_the_cli(tmp_path, moco_backbone):
    from passl_tpu_torch.tools import train

    argv = ["-c", PROBE_CFG, "--device", "cpu", "-o", f"Global.output_dir={tmp_path}",
            "-o", f"Global.pretrained_model={moco_backbone}", "-o", "Global.max_train_step=2",
            "-o", "Global.print_batch_step=1"]
    for o in TINY_PROBE:
        argv += ["-o", o]
    e = train.main(argv)
    assert e.pretrained_report["loaded"] == {k for k in e.model.state_dict()
                                             if k.startswith("backbone.")}
    assert len(e.train_loop.history) == 2 and all(np.isfinite(h["loss"])
                                                  for h in e.train_loop.history)
    m = e.eval_loop.last_metrics  # eval_during_train: the epoch's eval ran at the stop
    assert set(m) == {"top1", "top5"} and all(0.0 <= v <= 1.0 for v in m.values())


def test_export_of_a_linear_probe_serves_its_logits(tmp_path, moco_backbone):
    cfg = [f"Global.pretrained_model={moco_backbone}", *TINY_PROBE]
    argv = ["-c", PROBE_CFG, "-o", f"Global.output_dir={tmp_path / 'art'}"]
    for o in cfg:
        argv += ["-o", o]
    pt = export.main(argv)
    assert pt == str(tmp_path / "art" / "LinearProbe.pt")
    pred = Predictor(str(tmp_path / "art"), name="LinearProbe", device="cpu")
    assert pred.spec["input"]["shape"] == [None, 16, 16, 3]
    x = np.random.RandomState(0).rand(4, 16, 16, 3).astype(np.float32)
    logits = pred.predict(x)
    assert logits.shape == (4, 10) and np.isfinite(logits).all()
    e = Engine(_probe_config(tmp_path / "eng", *cfg), mode="eval", device="cpu")
    with torch.no_grad():
        want = e.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(logits, want)  # the same seed's fc, the same backbone
    assert len(pred(list(x), topk=3)) == 4
    e.close()


def test_export_refusal_names_the_ports_extract_weights(tmp_path):
    with pytest.raises(ValueError, match=r"passl_tpu_torch\.tools\.extract_weights"):
        export.main(["-c", SIMCLR_CFG, "-o", f"Global.output_dir={tmp_path}"])


# ------------------------------------------------------------------ census

CENSUS = sorted(
    p for p in glob.glob(os.path.join(REPO, "configs", "simclr", "*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "moco", "*.yaml"))
    if cfg_util.get_config(p)["Model"]["name"] in ("SimCLR", "MoCo", "MoCoV2", "LinearProbe")
) + [os.path.join(REPO, "tests", "e2e", f"{m}_structured.yaml")
     for m in ("simclr", "mocov2", "probe")]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_simclr_moco_and_probe_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert type(model).__name__ == model_cfg["name"]
    assert sum(p.numel() for p in model.parameters()) > 0
