"""DINOv2 of the PyTorch port (passl_tpu_torch/models/dino.py) against the JAX
package.

On the CPU, at the JAX tests' tiny sizes (tests/test_ssl_methods.py: a ViT of
2 blocks, 64 wide, over 32 x 32 global crops in 8 x 8 patches, 16 patches a
crop, and 16 x 16 local crops, heads of 64 -> 32 -> 128), from the JAX
weights carried across by `flax_to_torch` (the teacher's `mask_token`, which
flax never creates, filled from the student's, and no other gap filled), with
the masks on the uniforms JAX drew handed to `masking_noise`: the loss and
its DINO, iBOT and KoLeo parts (f32, 1e-5 relative), every student gradient
(max abs error at most 1e-4 of the JAX gradient's norm), both centers after
the step; the masks and the eval masks' fixed seed; LayerScale at 1.0 unless
the config sets it, and a probe config without it builds none (what the JAX
code does, not its docstring); and the slice as a whole: each of the JAX
engine's first 3 steps of tests/e2e/dinov2_structured.yaml (8 images of 2 +
4 crops, f32) from JAX's state on its draws, the teacher's mask token moved
by the EMA alone. The optimizer groups of dinov2_vit_s14_pretrain_in1k
against the JAX package's `build_optimizer` (its `layerwise_decay` warns and decays nothing,
as in JAX), every DINOv2 config built on the meta device, and the learning
check's extract into the probe. A test marked `cuda` trains the tiny DINOv2
on the card.
"""
import contextlib
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine import engine as port_engine
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import dino as port_dino
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_to_torch
from test_torch_deit import assert_step_tracks
from test_torch_dino import (BACKBONE, E2E, assert_grads, assert_groups_match_jax, crops,
                             engine_config, jax_engine_run, jax_variables, port_state)
from test_torch_mae import recorded_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = dict(out_dim=128, hidden_dim=64, bottleneck_dim=32, global_crops=2, mask_ratio=0.3,
            base_momentum=0.9)
PARTS = ("loss", "dino_loss", "ibot_loss", "koleo_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """The port's tiny CPU steps on one OpenMP thread, put back after
    (test_torch_densecl.py says why threadpoolctl and not set_num_threads)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # a speed setting only
        yield
        return
    with threadpool_limits(1, user_api="openmp"):
        yield


class handed_noise:
    """The port's DINOv2 masks draw the given uniforms, in order."""

    def __init__(self, draws):
        self.queue = list(draws)

    def __enter__(self):
        def masking_noise(n, l, generator, device):
            u = self.queue.pop(0)
            assert u.shape == (n, l)
            return torch.from_numpy(np.array(u, np.float32)).to(device)

        self.mp = pytest.MonkeyPatch()
        self.mp.setattr(port_dino, "masking_noise", masking_noise)
        return self.queue

    def __exit__(self, *exc):
        self.mp.undo()


def _jax_step(jm, variables, batch, key):
    """One train-mode forward and backward on the `masking` key: the loss
    parts, the gradients, the updated `ssl` collection."""
    import jax
    import jax.numpy as jnp

    rest = {k: v for k, v in variables.items() if k != "params"}
    jb = [jnp.asarray(c) for c in batch]

    def loss(p):
        out, new = jm.apply({"params": p, **rest}, jb, train=True, mutable=["ssl"],
                            rngs={"masking": key})
        return out["loss"], (out, new)

    (_, (out, new)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return {k: float(v) for k, v in out.items()}, jax.device_get(grads), jax.device_get(new)


def _pair(seed):
    from passl_tpu.models.dino import DINOv2Pretrain as JaxDINOv2

    jm = JaxDINOv2(backbone=BACKBONE, **HEAD)
    variables = jax_variables(jm, crops(2, 0, (32, 32, 16)), seed, train=True)
    pm = port_dino.DINOv2Pretrain(backbone=BACKBONE, **HEAD).train()
    pm.load_state_dict(port_state(pm, variables))
    return jm, variables, pm


def test_pretrain_loss_parts_gradients_and_centers_match_jax_on_its_draws():
    """Two train-mode steps of 6 images over 2 global and 4 local crops, from
    nonzero centers, the masks on the uniforms JAX drew: the four loss parts,
    every student gradient (the teacher takes none; the mask token takes one),
    both centers after each step."""
    import jax

    jm, variables, pm = _pair(3)
    for t in range(2):
        batch = crops(6, 10 + t)
        with recorded_noise() as noise:
            want, grads, new = _jax_step(jm, variables, batch, jax.random.PRNGKey(20 + t))
            jax.effects_barrier()
        assert len(noise) == 1 and noise[0].shape == (12, 16)
        for p in pm.parameters():
            p.grad = None
        with handed_noise(noise) as left:
            out = pm([torch.from_numpy(c) for c in batch], generator=torch.Generator())
        assert not left and set(out) == set(PARTS)
        for k in PARTS:
            assert out[k].dtype == torch.float32
            np.testing.assert_allclose(out[k].item(), want[k], rtol=1e-5, err_msg=k)
        torch.testing.assert_close(out["loss"], out["dino_loss"] + out["ibot_loss"]
                                   + 0.1 * out["koleo_loss"], rtol=1e-6, atol=0)
        out["loss"].backward()
        assert all(p.grad is None for p in pm.teacher.parameters())
        assert pm.student.backbone.mask_token.grad.abs().max() > 0
        # flax's gradient tree lacks the teacher's mask token: compare the rest
        grads["teacher"]["backbone"]["mask_token"] = np.zeros((1, 1, 64), np.float32)
        assert_grads(pm, grads)
        for name in ("cls_center", "patch_center"):
            np.testing.assert_allclose(getattr(pm, name).numpy(), np.asarray(new["ssl"][name]),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        variables = {**variables, "ssl": new["ssl"]}


def test_the_converter_fills_the_teachers_mask_token_and_nothing_else():
    """flax never creates teacher/backbone/mask_token: the converter takes the
    student's, as the JAX engine copies the student in; a leaf missing anywhere
    else raises."""
    jm, variables, pm = _pair(4)
    assert "mask_token" not in variables["params"]["teacher"]["backbone"]
    state = port_state(pm, variables)
    assert torch.equal(state["teacher.backbone.mask_token"], state["student.backbone.mask_token"])
    assert pm.flax_absent() == ["teacher.backbone.mask_token"]
    params = {k: dict(v) for k, v in variables["params"].items()}
    params["teacher"]["backbone"] = {k: v for k, v in params["teacher"]["backbone"].items()
                                     if k != "cls_token"}
    with pytest.raises(KeyError, match=r"no flax leaf fills \['teacher\.backbone\.cls_token'\]"):
        flax_to_torch(params, pm, collections={"ssl": variables["ssl"]})


def test_masks_and_the_fixed_eval_masks():
    """Each global crop's patches masked where its draw is below 0.3, the
    student's patch tokens replaced by `mask_token` there (the teacher's
    never); training needs the step's generator; eval masks come from a
    generator seeded with 0, whatever is given."""
    pm = init_module(port_dino.DINOv2Pretrain(backbone=BACKBONE, **HEAD),
                     torch.Generator().manual_seed(0))
    seen = []
    for tower in ("student", "teacher"):
        getattr(pm, tower).backbone.register_forward_hook(
            lambda mod, args, out, tower=tower: seen.append(
                (tower, None if len(args) < 2 or args[1] is None else args[1].clone())))
    batch = [torch.from_numpy(c) for c in crops(3, 5, (32, 32, 16))]
    pm.train()
    with pytest.raises(ValueError, match="generator"):
        pm(batch)
    u = torch.rand(6, 16, generator=torch.Generator().manual_seed(3))
    with handed_noise([u.numpy()]):
        pm(batch, generator=torch.Generator())
    (s_tower, mask), (t_tower, t_mask), (_, local) = seen
    assert (s_tower, t_tower) == ("student", "teacher") and t_mask is None and local is None
    assert mask.dtype == torch.int32 and torch.equal(mask, (u < 0.3).to(torch.int32))
    pm.eval()
    seen.clear()
    with torch.no_grad():
        a = pm(batch)["loss"]
        b = pm(batch, generator=torch.Generator().manual_seed(9))["loss"]
    assert torch.equal(a, b) and torch.equal(seen[0][1], seen[3][1])
    want = torch.rand(6, 16, generator=torch.Generator().manual_seed(0)) < 0.3
    assert torch.equal(seen[0][1], want.to(torch.int32))


def test_layerscale_is_on_unless_the_config_sets_it():
    """The pretrain towers `setdefault` init_values to 1.0 (JAX :293-294); a
    config's 1e-5 stays; the bare encoder and the probes pass theirs through."""
    on = init_module(port_dino.DINOv2Pretrain(backbone=BACKBONE, **HEAD),
                     torch.Generator().manual_seed(0))
    assert torch.equal(on.student.backbone.blocks[0].gamma_1, torch.ones(64))
    cfg = cfg_util.get_config(os.path.join(REPO, "configs", "dinov2",
                                           "dinov2_vit_s14_pretrain_in1k.yaml"), show=False)
    with torch.device("meta"):
        small = build_model(dict(cfg["Model"]))
    assert small.student.backbone.blocks[0].init_values == 1e-5
    assert small.teacher.backbone.blocks[11].init_values == 1e-5


@pytest.mark.parametrize("config, layerscale", [
    ("dinov2_vit_l14_lp_in1k.yaml", False), ("dinov2_vit_g2_14_lp_in1k.yaml", False),
    ("dinov2_vit_s14_lp_in1k.yaml", True)])
def test_a_probe_without_init_values_builds_no_layerscale_as_the_jax_code_does(config,
                                                                              layerscale):
    """The JAX docstring says the DINOv2 probe's encoder defaults to LayerScale;
    its code passes the config's encoder through, so the ViT-L and ViT-g probe
    configs build none. The port's parameter names equal the JAX model's."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu_torch.utils.convert import _flatten, flax_path

    cfg = dict(cfg_util.get_config(os.path.join(REPO, "configs", "dinov2", config),
                                   show=False)["Model"])
    with torch.device("meta"):
        pm = build_model(dict(cfg))
    assert isinstance(pm, port_dino.DINOv2LinearProbe)
    assert hasattr(pm.encoder.blocks[0], "gamma_1") == layerscale
    jm = jax_build_model(dict(cfg))
    size = cfg["encoder"]["img_size"]
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, size, size, 3))))["params"]
    paths = {flax_path(n, p.dim()) for n, p in pm.named_parameters()}
    assert paths == set(_flatten(jax.tree_util.tree_map(lambda s: np.empty(0), params)))


# ----------------------------------------------------- the slice as a whole

DINOV2_CFG = os.path.join(E2E, "dinov2_structured.yaml")
PARITY = ["FP16.enable=False", "DataLoader.Train.sampler.batch_size=8",
          "DataLoader.Train.dataset.dataset.size=64"]
STEPS = 3


def test_tiny_dinov2_steps_along_the_jax_engine(tmp_path):
    """Each of the JAX engine's first 3 steps (AdamW, clip 3.0, the cosine EMA,
    both centers) from JAX's state on its draws: the loss parts, every
    parameter's and center's change, the AdamW moments; the teacher's mask
    token moves by the EMA rule alone."""
    import jax

    noise = []

    @contextlib.contextmanager
    def recording():  # the one trace records every step's draw
        with recorded_noise() as record:
            yield
            jax.effects_barrier()
        noise.extend(record)

    batches, jax_metrics, states = jax_engine_run(DINOV2_CFG, tmp_path / "jax", PARITY,
                                                  during=recording)
    assert len(noise) == STEPS and noise[0].shape == (16, 64)
    e = Engine(engine_config(DINOV2_CFG, tmp_path, *PARITY), mode="train", device="cpu")
    assert isinstance(e.model, port_dino.DINOv2Pretrain)
    (_, _, m_fn), = e.train_step.ema_pairs
    with handed_noise(noise) as left:
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            assert set(PARTS) <= set(want)
            assert_step_tracks(e, b, want, states[t], states[t + 1], t)
            s, mt = (e.model.state_dict()[f"{k}.backbone.mask_token"] for k in ("student",
                                                                               "teacher"))
            m = m_fn(t)
            prev = states[t][0]["teacher.backbone.mask_token"]
            torch.testing.assert_close(mt, m * prev + (1 - m) * s, rtol=0, atol=1e-7)
    assert not left and e.state.step == STEPS
    e.close()


def test_pretrain_config_groups_as_jax_build_optimizer_does_and_layerwise_decay_is_a_noop(
        monkeypatch):
    """dinov2_vit_s14_pretrain_in1k asks for layerwise_decay 0.9; the JAX engine
    reads the depth from the model config or the model, finds neither on
    DINOv2Pretrain, warns and decays nothing: so does the port."""
    warned = []
    monkeypatch.setattr(port_engine.logger, "warning", warned.append)
    popt, named = assert_groups_match_jax(
        os.path.join(REPO, "configs", "dinov2", "dinov2_vit_s14_pretrain_in1k.yaml"))
    assert any("layerwise_decay" in w and "no-op" in w for w in warned)
    assert {popt.group_of(n).lr_scale for n in named} == {1.0}


CENSUS = (sorted(glob.glob(os.path.join(REPO, "configs", "dinov2", "*.yaml")))
          + [DINOV2_CFG, os.path.join(E2E, "probe_dinov2_structured.yaml")])


@pytest.mark.parametrize("path", CENSUS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_dinov2_config_builds(path):
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_extract_fills_the_structured_probe(tmp_path):
    """`student.backbone` under `encoder` fills every encoder entry of the
    probe's model; its mask token is one entry the probe does not take."""
    from passl_tpu_torch.tools import extract_weights

    model = init_module(build_model(dict(cfg_util.get_config(DINOV2_CFG)["Model"])),
                        torch.Generator().manual_seed(0))
    picked = extract_weights.extract(model.state_dict(), "student.backbone", rename="encoder")
    assert "encoder.mask_token" in picked
    out = str(tmp_path / "backbone.pt")
    torch.save(picked, out)
    probe = os.path.join(E2E, "probe_dinov2_structured.yaml")
    assert extract_weights.unfilled(probe, out, "encoder") == []


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_dinov2_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e = Engine(engine_config(DINOV2_CFG, tmp_path, "Global.max_train_step=3",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    e.train()
    hist = e.train_loop.history
    assert len(hist) == 3 and all(np.isfinite(h[k]) for h in hist for k in PARTS)
