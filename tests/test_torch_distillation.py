"""DistillationWrapper of the PyTorch port (passl_tpu_torch/models/distillation.py)
against the JAX package.

On the CPU, at tiny sizes (a CIFAR-stem ResNet-18 or a tiny RegNetY teacher,
a 2-block distilled ViT student), from the JAX parameters converted, on the
same numpy batch: the soft loss at T = 2 and the hard loss, their parts,
acc1 and every gradient (1e-5 relative on the losses, 1e-4 of the largest
gradient entry), the teacher taking none; the teacher frozen in the engine:
no gradient, no optimizer state, its parameters and BatchNorm buffers
bitwise unchanged under `model.train()`; 3 steps of
configs/distill/distill_tiny_synthetic.yaml through the JAX engine and the
port's from JAX's state; the JAX wrapper's failure in eval (the images alone)
beside the port's student logits, and the eval loop of
`deit_base_distilled_in1k` (at tiny widths) returning them; the JAX engine's
failure at its init with `Loss.Train` beside the port's refusal. Then the
census: both configs under configs/distill/ build. A test marked `cuda`
trains the tiny config on the card and skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import distillation as port_distillation
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_to_torch
from test_torch_beit import SMALL, STEPS, assert_grads_match, engine_config, jax_engine_run
from test_torch_deit import assert_step_tracks
from test_torch_moco import _one_openmp_thread, _randomize  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISTILL = os.path.join(REPO, "configs", "distill")
TINY_CFG = os.path.join(DISTILL, "distill_tiny_synthetic.yaml")
STUDENT = dict(name="DistilledVisionTransformer", img_size=32, patch_size=8, embed_dim=64,
               depth=2, num_heads=4, num_classes=10)
TEACHERS = {"resnet18": dict(name="resnet18", num_classes=10, cifar_stem=True),
            "regnety": dict(name="RegNet", w_a=24.48, w_0=24, w_m=2.54, depth=6, group_width=8,
                            se_ratio=0.25, num_classes=10)}


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 32, 32, 3).astype(np.float32), rng.randint(0, 10, n).astype(np.int32)


def _pair(teacher, seed, **kw):
    """The JAX wrapper with numpy-drawn variables, and the port's with them."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.distillation import DistillationWrapper as JaxWrapper

    cfg = dict(teacher=TEACHERS[teacher], student=STUDENT, **kw)
    jm = JaxWrapper(**cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), (jnp.zeros((2, 32, 32, 3)), jnp.zeros((2,), jnp.int32)),
        train=False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                  dict(shapes)), seed)
    pm = port_distillation.DistillationWrapper(**cfg)
    pm.load_state_dict(flax_to_torch(variables["params"], pm, variables.get("batch_stats")))
    return jm, variables, pm


@pytest.mark.parametrize("teacher, kw", [
    ("resnet18", dict(temperature=2.0, alpha=0.5)),
    ("regnety", dict(temperature=2.0, alpha=0.3)),
    ("resnet18", dict(hard_distill=True, alpha=0.5)),
], ids=["soft-T2-resnet18", "soft-T2-regnety", "hard"])
def test_losses_and_gradients_match_jax(teacher, kw):
    """The loss, its parts and acc1 (1e-5 relative) and every student
    gradient (1e-4 of the largest entry); the teacher takes no gradient and
    its statistics stay as they were in both packages."""
    import jax

    jm, variables, pm = _pair(teacher, 3, **kw)
    images, labels = _batch(8, 4)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            (images, labels), train=True, mutable=["batch_stats"])
        return out["loss"], (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    want, stats, grads = jax.device_get((want, stats, grads))
    assert set(want) == {"loss", "ce_loss", "distill_loss", "acc1"}
    assert not any(np.any(g) for g in jax.tree_util.tree_leaves(grads["teacher"]))
    buffers0 = {k: v.clone() for k, v in pm.state_dict().items() if k.startswith("teacher.")}
    pm.train()
    assert pm.training and pm.student.training and not pm.teacher.training
    got = pm((torch.from_numpy(images), torch.from_numpy(labels)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-5, atol=1e-7, err_msg=k)
    got["loss"].backward()
    assert_grads_match(pm, {"student": grads["student"]}, skip=("teacher.",))
    assert all(torch.equal(pm.state_dict()[k], v) for k, v in buffers0.items())
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(stats),
                                                    jax.tree_util.tree_leaves(
                                                        variables["batch_stats"])))
    ce = torch.nn.functional.cross_entropy(pm.student(torch.from_numpy(images)).float(),
                                           torch.from_numpy(labels).long())
    np.testing.assert_allclose(got["ce_loss"].item(), ce.item(), rtol=1e-6)


def test_eval_the_jax_wrapper_fails_on_the_images_and_the_port_returns_the_students_logits():
    """JAX's eval step hands the wrapper the images alone, which it unpacks as
    (images, labels) (`distillation.py:36`); on a batch it returns the
    student's logits, which the port returns on the images."""
    jm, variables, pm = _pair("resnet18", 5)
    images, labels = _batch(6, 6)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jm.apply(variables, images, train=False)
    want = np.asarray(jm.apply(variables, (images, labels), train=False))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(images))
        student = pm.student(torch.from_numpy(images))
    assert torch.equal(got, student)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------- the slice as a whole


def test_tiny_distill_steps_along_the_jax_engine(tmp_path):
    """configs/distill/distill_tiny_synthetic.yaml (soft, T = 2, AdamW) on the
    label-free loop: each of the JAX engine's first 3 steps from JAX's state,
    the loss parts, acc1, every parameter's change and AdamW moment; the
    teacher frozen in both engines."""
    batches, jax_metrics, states, _ = jax_engine_run(TINY_CFG, SMALL, tmp_path / "jax")
    teacher = [k for k in states[0][0] if k.startswith("teacher.")]
    assert teacher and not any(k.startswith("teacher.") for k in states[0][1])
    assert all(torch.equal(s[0][k], states[0][0][k]) for s in states for k in teacher)
    e = Engine(engine_config(TINY_CFG, tmp_path, *SMALL), mode="train", device="cpu")
    assert isinstance(e.model, port_distillation.DistillationWrapper) and e.criterion is None
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert set(want) >= {"loss", "ce_loss", "distill_loss", "acc1"}
        assert len(b) == 2 and b[0].shape == (8, 32, 32, 3)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    final = e.model.state_dict()
    assert all(torch.equal(final[k], states[0][0][k]) for k in teacher)
    e.close()


def test_the_teacher_is_frozen_through_the_engine(tmp_path):
    """Two steps of the tiny config: the teacher's parameters and BatchNorm
    buffers bitwise unchanged though the train step calls `model.train()`,
    no teacher parameter in the optimizer's state, every student one in it."""
    e = Engine(engine_config(TINY_CFG, tmp_path, *SMALL, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cpu")
    assert e.model.frozen_patterns() == [r"^teacher\."]
    before = {k: v.clone() for k, v in e.model.state_dict().items() if k.startswith("teacher.")}
    assert any(".running_" in k for k in before)
    e.train()
    hist = e.train_loop.history
    assert len(hist) == 2 and {"loss", "ce_loss", "distill_loss", "acc1"} <= set(hist[0])
    after = e.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert all((id(p) in stateful) != n.startswith("teacher.")
               for n, p in e.model.named_parameters())
    e.model.train()
    assert not e.model.teacher.training and e.model.student.training


def test_deit_base_distilled_eval_loop_returns_the_students_logits(tmp_path):
    """configs/distill/deit_base_distilled_in1k.yaml at tiny widths (its
    hard distillation and alpha; a tiny RegNetY teacher, the 2-block student)
    on synthetic images: one pass of the eval loop takes the student's logits."""
    cfg = engine_config(os.path.join(DISTILL, "deit_base_distilled_in1k.yaml"), tmp_path,
                        f"Model.teacher={TEACHERS['regnety']}", f"Model.student={STUDENT}",
                        "FP16.enable=False")
    for mode in ("Train", "Eval"):
        dl = cfg["DataLoader"][mode]
        dl["dataset"] = {"name": "SyntheticDataset", "size": 12, "image_size": 32,
                         "num_classes": 10, "transform": [{"NormalizeImage": {"scale": 1 / 255}}]}
        dl["sampler"] = {"batch_size": 4, "shuffle": False, "drop_last": False}
        dl["loader"] = {"num_workers": 0}
    e = Engine(cfg, mode="eval", device="cpu")
    assert e.model.hard_distill and e.model.alpha == 0.5
    seen = []
    handle = e.model.student.register_forward_hook(lambda m, args, out: seen.append(out))
    top1 = e.eval()
    handle.remove()
    assert len(seen) == 3 and all(s.shape == (4, 10) for s in seen)
    assert 0.0 <= top1 <= 1.0 and e.eval_loop.last_metrics["top1"] == top1


def test_loss_train_the_jax_engine_fails_at_init_and_the_port_refuses(tmp_path):
    """With a `Loss.Train` block (as every configs/xcit/*_dist_in1k.yaml has)
    the JAX engine hands the wrapper the images alone and fails at its init;
    the port's engine refuses the config, naming that failure."""
    from passl_tpu.engine import Engine as JaxEngine

    overrides = [*SMALL, "Loss.Train=[{'CELoss': {'label_smoothing': 0.1}}]"]
    with pytest.raises(ValueError, match=r"not enough values to unpack \(expected 4, got 3\)"):
        JaxEngine(engine_config(TINY_CFG, tmp_path / "jax", *overrides), mode="train")
    with pytest.raises(NotImplementedError, match=r"Loss\.Train.*fails at its init.*"
                                                  r"not enough values to unpack"):
        Engine(engine_config(TINY_CFG, tmp_path, *overrides), mode="train", device="cpu")


# ------------------------------------------------------------------ census

CENSUS = sorted(glob.glob(os.path.join(DISTILL, "*.yaml")))


def test_the_census_holds_two_configs():
    assert [os.path.basename(p) for p in CENSUS] == ["deit_base_distilled_in1k.yaml",
                                                     "distill_tiny_synthetic.yaml"]


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_distill_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert isinstance(model, port_distillation.DistillationWrapper)
    assert sum(p.numel() for p in model.teacher.parameters()) > 0
    assert sum(p.numel() for p in model.student.parameters()) > 0


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_distill_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(TINY_CFG, tmp_path, *SMALL, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    before = {k: v.clone() for k, v in e.model.state_dict().items() if k.startswith("teacher.")}
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    after = e.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
