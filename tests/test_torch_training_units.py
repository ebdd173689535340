"""The PyTorch port's training pieces against their JAX functions, one by one.

Loss (hard, soft, smoothed), TopkAcc, every scheduler over a range of steps,
the global-norm clip with `no_clip_list`, `GradScaler.update` sequences,
optimizer grouping and AdamW updates, and the repaired DropPath. Inputs come
from numpy seeds and go to both sides; tolerances are stated beside each
comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import passl_tpu.core.amp as jax_amp
import passl_tpu.core.grad_clip as jax_clip
import passl_tpu.loss as jax_loss
import passl_tpu.metrics as jax_metrics
import passl_tpu.optimizer as jax_opt
import passl_tpu.scheduler as jax_sched
from passl_tpu_torch import loss, metrics, optimizer, scheduler
from passl_tpu_torch.core.amp import GradScaler, ScalerState
from passl_tpu_torch.core.grad_clip import ClipGradByGlobalNorm
from passl_tpu_torch.core.train_state import TrainState
from passl_tpu_torch.engine.steps import TrainStep
from passl_tpu_torch.models.cait import CaiT
from passl_tpu_torch.nn.layers import DropPath
from passl_tpu_torch.utils.convert import _torch_name

RS = np.random.RandomState


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy_matches_jax(smoothing, soft):
    rs = RS(int(soft) * 10 + int(smoothing * 10))
    logits = (rs.randn(8, 10) * 3).astype(np.float32)
    if soft:  # mixup-style targets, already smoothed once by the batch transform
        labels = rs.dirichlet(np.ones(10), 8).astype(np.float32)
    else:
        labels = rs.randint(0, 10, 8).astype(np.int64)
    want = float(jax_loss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = loss.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)  # f32 log-softmax, another order


def test_soft_targets_are_smoothed_again():
    """As `passl_tpu/loss/__init__.py:38-43`: soft labels get the smoothing on top."""
    logits = torch.from_numpy(RS(0).randn(4, 5).astype(np.float32))
    soft = torch.eye(5)[:4] * 0.9 + 0.02  # what Mixup's own label_smoothing=0.1 gives
    twice = soft * (1 - 0.1) + 0.1 / 5
    assert torch.equal(loss.cross_entropy(logits, soft, 0.1), loss.soft_cross_entropy(logits, twice))
    assert not torch.equal(loss.cross_entropy(logits, soft, 0.1), loss.cross_entropy(logits, soft))


def test_build_loss_and_bf16_logits():
    cfg = [{"CELoss": {"label_smoothing": 0.1}}, {"name": "SoftTargetCrossEntropy", "weight": 0.5}]
    rs = RS(1)
    logits = rs.randn(6, 7).astype(np.float32)
    soft = rs.dirichlet(np.ones(7), 6).astype(np.float32)
    want = jax_loss.build_loss(cfg)(jnp.asarray(logits), jnp.asarray(soft))
    got = loss.build_loss(cfg)(torch.from_numpy(logits).bfloat16().float(), torch.from_numpy(soft))
    assert set(got) == set(want) == {"CELoss", "SoftTargetCE", "loss"}
    bf = jax_loss.build_loss(cfg)(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32),
                                  jnp.asarray(soft))
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(bf[k]), rtol=1e-6)
    assert loss.build_loss(None) is None


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("soft", [False, True])
def test_topk_acc_matches_jax(soft):
    rs = RS(2)
    logits = rs.randn(32, 10).astype(np.float32)
    logits[0, :3] = 1.0  # a tie, broken by index on both sides
    labels = (rs.dirichlet(np.ones(10), 32).astype(np.float32) if soft
              else rs.randint(0, 10, 32).astype(np.int64))
    want = jax_metrics.TopkAcc((1, 5))(jnp.asarray(logits), jnp.asarray(labels))
    got = metrics.build_metrics([{"TopkAcc": {"topk": [1, 5]}}])[0](
        torch.from_numpy(logits), torch.from_numpy(labels))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


# ------------------------------------------------------------- schedulers

SCHEDULES = [
    {"name": "TimmCosine", "learning_rate": 2e-3, "eta_min": 1e-5, "warmup_epoch": 2,
     "warmup_start_lr": 1e-6},
    {"name": "TimmCosine", "learning_rate": 0.1, "warmup_epoch": 1, "warmup_prefix": True,
     "decay_unit": "epoch"},
    {"name": "ViTLRScheduler", "learning_rate": 3e-3, "warmup_epoch": 1},
    {"name": "ViTLRScheduler", "learning_rate": 3e-3, "warmup_epoch": 1, "decay_type": "linear"},
    {"name": "Step", "learning_rate": 0.1, "step_size": 2, "gamma": 0.5, "warmup_epoch": 1},
    {"name": "Poly", "learning_rate": 0.1, "power": 2.0, "end_lr": 1e-4, "warmup_epoch": 1},
    {"name": "MultiStepDecay", "learning_rate": 0.1, "milestones": [2, 4], "gamma": 0.1},
    {"name": "Cosine", "learning_rate": 0.05},
    {"name": "CosineWarmup", "learning_rate": 0.3, "warmup_epochs": 1, "lr_scaling": "sqrt"},
    {"name": "simclrCosineWarmup", "learning_rate": 0.3, "warmup_epochs": 1},
    {"name": "Constant", "learning_rate": 0.01},
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=lambda c: c["name"])
def test_scheduler_matches_jax(cfg):
    epochs, spe, bs = 6, 10, 512
    want_fn = jax_sched.build_lr_scheduler(dict(cfg), epochs, spe, bs)
    got_fn = scheduler.build_lr_scheduler(dict(cfg), epochs, spe, bs)
    steps = range(0, epochs * spe + 5)
    want = np.asarray([float(want_fn(jnp.asarray(s))) for s in steps])
    got = np.asarray([got_fn(s) for s in steps])
    assert all(isinstance(got_fn(s), float) for s in (0, 7))
    # JAX evaluates in f32, the port in f64: near the end of a cosine, 1 + cos
    # cancels, so the f32 error is a few ulps of the peak lr, not of the value
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6 * want.max())


# -------------------------------------------------------------- grad clip


@pytest.mark.parametrize("kw", [
    {"clip_norm": 1.0},
    {"clip_norm": 1.0, "no_clip_list": ["pos_embed"]},
    {"clip_norm": 1.0, "no_clip_list": ["pos_embed"], "always_clip": True},
    {"clip_norm": 5.0, "clip_norm_max": 0.5},
    {"clip_norm": 100.0},  # no clipping
])
def test_clip_matches_jax(kw):
    rs = RS(3)
    tree = {"blocks_0": {"fc": {"kernel": rs.randn(4, 6).astype(np.float32)}},
            "pos_embed": (rs.randn(1, 5, 6) * 3).astype(np.float32),
            "head": {"bias": rs.randn(6).astype(np.float32)}}
    jg, jnorm = jax_clip.ClipGradByGlobalNorm(**kw)(
        traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in
                                      traverse_util.flatten_dict(tree, sep="/").items()}, sep="/"))
    flat = traverse_util.flatten_dict(tree, sep="/")
    grads = {k.replace("/", "."): torch.from_numpy(v.copy()) for k, v in flat.items()}
    norm = ClipGradByGlobalNorm(**kw)(grads)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k, v in traverse_util.flatten_dict(jg, sep="/").items():
        np.testing.assert_allclose(grads[k.replace("/", ".")].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------------------ loss scaler


def test_grad_scaler_update_sequence_matches_jax():
    kw = dict(init_loss_scaling=2.0**4, incr_every_n_steps=3, max_loss_scaling=2.0**6)
    js, jstate = jax_amp.GradScaler(**kw), jax_amp.GradScaler(**kw).init()
    ps = GradScaler(**kw)
    state = ps.init()
    flags = [True] * 7 + [False, True, False, False, False, False, False, True, True, True]
    for f in flags:
        jstate = js.update(jstate, jnp.bool_(f))
        state = ps.update(state, f)
        assert (state.scale, state.growth_tracker) == (float(jstate.scale),
                                                       int(jstate.growth_tracker))
    assert state.scale == 2.0  # halved five times from the 2^6 cap


def test_grad_scaler_unscale_and_check():
    sc = GradScaler()
    st = ScalerState(4.0, 0)
    grads = [torch.full((3,), 8.0), torch.full((2, 2), -4.0)]
    assert sc.unscale_and_check(grads, st)
    assert torch.equal(grads[0], torch.full((3,), 2.0)) and torch.equal(grads[1], -torch.ones(2, 2))
    assert not sc.unscale_and_check([torch.tensor([1.0, float("inf")])], st)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x, generator=None):
        return self.fc(x)


def test_scaled_step_skips_a_non_finite_gradient():
    """As the JAX step under loss scaling: params and moments kept, the scale
    halved, the step counted; a finite step then updates and reports the scale."""
    torch.manual_seed(0)
    model = _Linear()
    opt = optimizer.build_optimizer({"name": "AdamW"}, dict(model.named_parameters()))
    scaler = GradScaler(init_loss_scaling=2.0**4, incr_every_n_steps=2)
    state = TrainState(model, opt, torch.Generator(), scaler_state=scaler.init())
    poison = {"on": True}

    def criterion(logits, labels):
        ce = loss.cross_entropy(logits, labels)
        return {"loss": ce * float("inf") if poison["on"] else ce}

    step = TrainStep(lambda s: 0.1, criterion=criterion, scaler=scaler)
    batch = (torch.randn(8, 4), torch.randint(0, 3, (8,)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = step(state, batch)
    assert state.step == 1 and m["loss_scale"] == 8.0 and state.scaler_state.growth_tracker == 0
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert opt.state_dict()["state"] == {}  # no moments yet
    poison["on"] = False
    m = step(state, batch)
    assert state.step == 2 and m["loss_scale"] == 8.0 and state.scaler_state.growth_tracker == 1
    assert not torch.equal(before["fc.weight"], model.fc.weight)
    step(state, batch)
    assert state.scaler_state.scale == 16.0  # two finite steps in a row


def test_build_dataloader_takes_rank_and_world_from_torch_distributed(monkeypatch):
    import passl_tpu_torch.data as pdata

    cfg = {"dataset": {"name": "SyntheticDataset", "size": 40, "image_size": 8, "num_classes": 3,
                       "transform": [{"NormalizeImage": {"scale": 1 / 255}}]},
           "sampler": {"batch_size": 8}, "loader": {"num_workers": 0, "prefetch": 0}}
    single = pdata.build_dataloader(cfg, "Train", seed=3)
    assert (single.batch_sampler.rank, single.batch_sampler.num_replicas) == (0, 1)
    monkeypatch.setattr(pdata.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pdata.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(pdata.dist, "get_world_size", lambda: 2)
    loader = pdata.build_dataloader(cfg, "Train", seed=3)
    assert (loader.batch_sampler.rank, loader.batch_sampler.num_replicas) == (1, 2)
    assert loader.batch_sampler.batch_size == 4  # the global batch split over 2 processes
    images, labels = pdata.to_device(next(iter(loader)), torch.device("cpu"))
    assert images.shape == (4, 8, 8, 3) and images.dtype == torch.float32
    assert not labels.dtype.is_floating_point
    with pytest.raises(ValueError, match="does not divide"):
        pdata.build_dataloader(dict(cfg, sampler={"batch_size": 7}), "Train")


# --------------------------------------------------------------- optimizer

TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=4, depth_token_only=1,
            num_classes=10)
OPT_CFG = {"name": "AdamW", "betas": [0.9, 0.99], "eps": 1e-7, "weight_decay": 0.05,
           "one_dim_param_no_weight_decay": True, "no_weight_decay_name": ["cls_token", "pos_embed"],
           "layerwise_decay": 0.75,
           "param_group": [{"name": "head", "lr_scale": 2.0, "weight_decay": 0.1},
                           {"name": "blocks_token_only", "freeze_steps": 2}]}


def _jax_and_port_params():
    import jax

    import passl_tpu.models.cait as jax_cait

    jm = jax_cait.CaiT(**TINY, th_impl="einsum")
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    train=False)["params"])
    model = CaiT(**TINY)
    named = dict(model.named_parameters())
    names = {p: _torch_name(p, np.asarray(v))[0]
             for p, v in traverse_util.flatten_dict(params, sep="/").items()}
    return params, model, named, names


def test_grouping_matches_jax():
    params, model, named, names = _jax_and_port_params()
    jopt = jax_opt.build_optimizer(dict(OPT_CFG), params, num_layers=2)
    popt = optimizer.build_optimizer(dict(OPT_CFG), named, num_layers=2)
    assert set(names.values()) == set(named)
    for path, name in names.items():
        jg, pg = jopt.group_of(path), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale, pg.freeze_steps) == \
            (jg.name, jg.weight_decay, jg.lr_scale, jg.freeze_steps), name
    assert popt.group_of("blocks.1.attn.qkv.weight").name == "default|layer2"  # blocks.1 -> 2
    assert popt.group_of("head.weight").name.startswith("head")


def test_adamw_updates_match_jax():
    params, model, named, names = _jax_and_port_params()
    rs = RS(4)
    jopt = jax_opt.build_optimizer(dict(OPT_CFG), params, num_layers=2)
    popt = optimizer.build_optimizer(dict(OPT_CFG), named, num_layers=2)
    flat = traverse_util.flatten_dict(params, sep="/")
    with torch.no_grad():  # the same start on both sides, in the torch layouts
        for path, name in names.items():
            named[name].copy_(torch.from_numpy(_torch_name(path, np.asarray(flat[path]))[1].copy()))
    jparams, jstate = params, jopt.init(params)
    for step, lr in enumerate([1e-2, 5e-3, 2e-3, 1e-3]):
        grads = {path: rs.randn(*np.shape(v)).astype(np.float32) for path, v in flat.items()}
        jparams, jstate = jopt.apply(jparams, traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in grads.items()}, sep="/"), jstate,
            jnp.float32(lr), jnp.asarray(step))
        for path, name in names.items():
            named[name].grad = torch.from_numpy(_torch_name(path, grads[path])[1].copy())
        popt.step(lr, step)
    for path, v in traverse_util.flatten_dict(jparams, sep="/").items():
        name = names[path]
        _, want = _torch_name(path, np.asarray(v))
        # f32 updates with f64 scalars here, f32 in JAX: a few ulps over 4 steps
        np.testing.assert_allclose(named[name].detach().numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_optimizer_refuses_unported_rules():
    with pytest.raises(NotImplementedError, match="MomentumLARC"):
        optimizer.build_optimizer({"name": "MomentumLARC"}, {"w": torch.nn.Parameter(torch.ones(2))})


def test_frozen_group_is_left_as_it_is():
    w = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.build_optimizer({"name": "AdamW"}, {"enc.w": w, "head.b": b},
                                    frozen_patterns=["enc"])
    w.grad, b.grad = torch.ones(3), torch.ones(3)
    opt.step(0.1, 0)
    assert torch.equal(w, torch.ones(3)) and not torch.equal(b, torch.ones(3))
    assert opt.group_of("enc.w").rule == "Frozen"


# ---------------------------------------------------------------- DropPath


def test_drop_path_draws_only_from_its_generator():
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3, 4)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    torch.manual_seed(1)
    a = dp(x, g)
    g.set_state(state)
    torch.manual_seed(2)  # another global seed: no effect
    b = dp(x, g)
    assert torch.equal(a, b)
    c = dp(x, g)  # the generator has moved on
    assert not torch.equal(a, c)
    # JAX semantics: one keep-coin per sample, kept rows scaled by 1 / keep
    rows = a.reshape(64, -1)
    kept = (rows == 2.0).all(-1)
    assert torch.all(kept | (rows == 0).all(-1)) and 10 < int(kept.sum()) < 54


def test_drop_path_identity_in_eval_and_needs_a_generator_in_training():
    dp = DropPath(0.3)
    x = torch.randn(4, 5)
    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Generator"):
        dp.train()(x)
