"""ConvMAE of the PyTorch port (passl_tpu_torch/models/convmae.py) against
the JAX package, and the masked-image-modeling family's configs and
extracts.

On the CPU, at tiny sizes (32 x 32 images, patch sizes 2, 2, 2 to a 4 x 4
stage-3 grid, widths 16, 32, 64, depths 1, 1, 2, a decoder of 1 block), from
the JAX parameters converted, on the same numpy inputs and JAX's draws: the
depthwise 5 x 5 kernels through the converter ([5, 5, 1, c] -> [c, 1, 5,
5]); the loss (f32, 1e-5 relative) and every gradient (1e-4 of the largest
entry) on the noise JAX drew, with 12 of the 16 patches masked and the
masked positions zero at every `CBlock`'s depthwise input; the ConvViT
logits with the port's stochastic-depth draws handed to JAX and its
features at `num_classes: 0`; 3 steps of the tiny ConvMAE through the JAX
engine and the port's from JAX's state. Then the family's census: 18 of the
19 configs build, `beit_large_patch16_224_in1k` raises naming `remat` as the
JAX init does, the four BEiT finetune configs leave `Model.remat` out as the
JAX registry does (silently), a factory given `remat` drops it with the JAX
engine's warning, and the layer-decay groups of the three finetune configs
equal the JAX builder's; and the learning checks' extracts fill
their probes. A test marked `cuda` trains the tiny ConvMAE on the card and
skips elsewhere.
"""
import glob
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine import engine as engine_mod
from passl_tpu_torch.engine.engine import Engine, build_model_dropping_remat, model_optimizer
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import convmae as port_convmae
from passl_tpu_torch.models import mae as port_mae
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import _flatten, _torch_name, flax_path, flax_to_torch
from test_torch_beit import (E2E, STEPS, assert_grads_match, engine_config,
                             finetune_logits_match, jax_engine_run)
from test_torch_deit import assert_step_tracks
from test_torch_mae import handed_noise, recorded_noise
from test_torch_moco import _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(img_size=32, patch_sizes=(2, 2, 2), embed_dims=(16, 32, 64), depths=(1, 1, 2),
          num_heads=4)
PRE = dict(KW, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=4, mask_ratio=0.75)


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


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _jax_params(jm, seed, *args, **kw):
    import jax

    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "masking": jax.random.PRNGKey(1)}, *args, **kw))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                             shapes["params"]), seed)


def test_depthwise_kernels_convert_to_oihw():
    model = port_convmae.ConvViT(**KW, num_classes=0)
    kernel = np.random.RandomState(0).randn(5, 5, 1, 16).astype(np.float32)
    key, got = _torch_name("blocks1_0/attn/kernel", kernel, names=model.state_dict())
    assert key == "blocks1.0.attn.weight" and got.shape == (16, 1, 5, 5)
    np.testing.assert_array_equal(got[3, 0], kernel[:, :, 0, 3])
    assert flax_path(key, 4) == "blocks1_0/attn/kernel"
    assert model.blocks1[0].attn.groups == 16


@pytest.fixture(scope="module")
def convmae_pair():
    import jax.numpy as jnp

    from passl_tpu.models.convmae import MaskedAutoencoderConvViT as JaxConvMAE

    jm = JaxConvMAE(**PRE)
    params = _jax_params(jm, 9, jnp.zeros((2, 32, 32, 3)))
    pm = port_convmae.MaskedAutoencoderConvViT(**PRE).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def test_convmae_loss_and_gradients_match_jax_on_its_noise(convmae_pair):
    """Two batches: the loss and every gradient on the noise JAX drew; every
    mask holds 12 of 16; at each CBlock's depthwise input the masked
    positions of the stage's grid (the stage-3 mask repeated 4 and 2 times)
    are zero, and some visible ones are not."""
    import jax

    jm, params, pm = convmae_pair

    @jax.jit
    def step(p, x, key):
        return jax.value_and_grad(lambda p: jm.apply({"params": p}, x, train=True,
                                                     rngs={"masking": key})["loss"])(p)

    seen = []
    hooks = [blk.attn.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach()))
             for blk in (*pm.blocks1, *pm.blocks2)]
    with recorded_noise() as noise:
        runs = []
        for t in range(2):
            x = _images(4, 70 + t)
            loss, grads = step(params, x, jax.random.PRNGKey(20 + t))
            jax.effects_barrier()
            runs.append((x, float(loss), jax.device_get(grads)))
    assert len(noise) == 2 and noise[0].shape == (4, 16)
    for (x, want, grads), u in zip(runs, noise):
        pm.zero_grad(set_to_none=True)
        seen.clear()
        with handed_noise([u]) as left:
            out = pm(torch.from_numpy(x), generator=torch.Generator())
        assert not left and set(out) == {"loss"}
        np.testing.assert_allclose(out["loss"].item(), want, rtol=1e-5)
        out["loss"].backward()
        assert_grads_match(pm, grads)
        masked3 = np.zeros((4, 16), bool)
        np.put_along_axis(masked3, np.argsort(u, axis=1, kind="stable")[:, 4:], True, axis=1)
        for y, rep in zip(seen, (4, 2)):  # NCHW: stage 1 at 16 x 16, stage 2 at 8 x 8
            grid = masked3.reshape(4, 4, 4).repeat(rep, 1).repeat(rep, 2)
            y = y.permute(0, 2, 3, 1).numpy()
            assert np.all(y[grid] == 0) and np.abs(y[~grid]).max() > 0
    for h in hooks:
        h.remove()


@pytest.mark.parametrize("global_pool", [True, False])
def test_convvit_logits_match_jax_with_drop_path(global_pool):
    import jax.numpy as jnp

    from passl_tpu.models.convmae import ConvViT as JaxConvViT

    kw = dict(KW, drop_path_rate=0.5, num_classes=10, global_pool=global_pool)
    jm = JaxConvViT(**kw)
    params = _jax_params(jm, 10, jnp.zeros((1, 32, 32, 3)), train=False)
    pm = port_convmae.ConvViT(**kw)
    pm.load_state_dict(flax_to_torch(params, pm))
    # linspace(0, 0.5, 4): the first CBlock draws nothing, the other three twice
    finetune_logits_match(jm, params, pm, _images(6, 11), 6)


def test_convvit_at_num_classes_0_returns_its_features():
    import jax.numpy as jnp

    from passl_tpu.models.convmae import ConvViT as JaxConvViT

    jm = JaxConvViT(**KW, num_classes=0)
    params = _jax_params(jm, 12, jnp.zeros((1, 32, 32, 3)), train=False)
    pm = port_convmae.ConvViT(**KW, num_classes=0)
    pm.load_state_dict(flax_to_torch(params, pm))
    x = _images(3, 12)
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 64) and pm.out_channels == 64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------- the slice as a whole

CONVMAE = (os.path.join(E2E, "convmae_structured.yaml"),
           ["FP16.enable=False", "DataLoader.Train.dataset.size=24",
            "DataLoader.Train.sampler.batch_size=8", "Model.img_size=32",
            "DataLoader.Train.dataset.image_size=32",
            "DataLoader.Train.dataset.transform.0.RandomResizedCrop.size=32"])


def test_tiny_convmae_steps_along_the_jax_engine(tmp_path):
    """tests/e2e/convmae_structured.yaml at 32 x 32: each of the JAX engine's
    first 3 steps (AdamW) from JAX's state on the noise it drew."""
    path, overrides = CONVMAE
    batches, jax_metrics, states, noise = jax_engine_run(path, overrides, tmp_path / "jax",
                                                         recorded_noise)
    assert len(noise) == STEPS and noise[0].shape == (8, 16)
    e = Engine(engine_config(path, tmp_path, *overrides), mode="train", device="cpu")
    assert isinstance(e.model, port_convmae.MaskedAutoencoderConvViT)
    with handed_noise(noise) as left:
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            assert b[0].shape == (8, 32, 32, 3)
            assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    assert not left and e.state.step == STEPS
    e.close()


def test_masks_draw_through_mae_and_eval_masks_are_fixed():
    m = init_module(port_convmae.MaskedAutoencoderConvViT(**PRE), torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(2, 13))
    calls = []
    orig = port_mae.masking_noise

    def spy(n, l, generator, device):
        calls.append((n, l))
        return orig(n, l, generator, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mae, "masking_noise", spy)
        with pytest.raises(ValueError, match="generator"):
            m.train()(x)
        m.eval()
        with torch.no_grad():
            a, b = m(x)["loss"], m(x, generator=torch.Generator().manual_seed(5))["loss"]
    assert calls == [(2, 16)] * 2 and torch.equal(a, b)


# ------------------------------------------------------------------ census

MIM_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "beit", "*.yaml"))
                     + glob.glob(os.path.join(REPO, "configs", "cae", "*.yaml"))
                     + glob.glob(os.path.join(REPO, "configs", "convmae", "*.yaml")))
REMAT_DROPPED = {"beit_base_384_ft_in1k.yaml", "beit_large_224_ft_in1k.yaml",
                 "beit_large_384_ft_in1k.yaml", "beit_large_512_ft_in1k.yaml"}


def test_the_census_holds_19_configs():
    assert len(MIM_CONFIGS) == 19


@pytest.mark.parametrize("path", MIM_CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_mim_config_builds(path):
    """As the engine builds them, on the meta device: BEiT-L's pretrain sets
    `encoder.remat`, which BEiTViT lacks, and raises naming it, as the JAX
    init does; the four BEiT finetune configs set a top-level `Model.remat`,
    which the registry leaves out of BEiTFinetune's keywords, silently, as
    the JAX registry's copy does (the JAX engine's warning is for a factory
    that passes it on: test_a_factory_drops_remat_with_the_jax_warning)."""
    name = os.path.basename(path)
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    assert ("remat" in model_cfg) == (name in REMAT_DROPPED)
    warned = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod.logger, "warning", warned.append)
        with torch.device("meta"):
            if name == "beit_large_patch16_224_in1k.yaml":
                with pytest.raises(TypeError, match=r"BEiTViT.*unexpected keyword argument "
                                                    r"'remat'"):
                    build_model_dropping_remat(model_cfg)
                return
            model = build_model_dropping_remat(model_cfg)
    assert sum(p.numel() for p in model.parameters()) > 0 and not warned


@pytest.mark.parametrize("name", ["convvit_base_patch16", "beit_base_patch16_224_pretrain"])
def test_a_factory_drops_remat_with_the_jax_warning(name):
    """A registered factory passes its keywords on, so the model rejects
    `remat`; the engine builds it again without, with the JAX engine's
    warning (`engine.py:251-266`)."""
    warned = []
    model_cfg = {"name": name, "remat": True}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod.logger, "warning", warned.append)
        with torch.device("meta"):
            build_model_dropping_remat(model_cfg)
    assert model_cfg == {"name": name}
    assert warned == [f"model {name} does not support remat; recompute ignored"]


@pytest.mark.parametrize("config, decays", [
    ("beit/beit_base_ft_in1k.yaml", False),
    ("cae/cae_base_ft_in1k.yaml", True),
    ("convmae/convmae_base_ft_in1k.yaml", False),
])
def test_finetune_layer_decay_groups_are_the_jax_builders(config, decays):
    """Each parameter's group (name, weight decay, lr scale) against the JAX
    builder's at the config's widths: JAX counts the config's or the model's
    `depth`, so BEiTFinetune and ConvViT decay nothing and CAEFinetune decays
    over its 12 blocks."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.models import build_model as jax_build_model
    from passl_tpu.optimizer import build_optimizer as jax_build_optimizer

    cfg = cfg_util.get_config(os.path.join(REPO, "configs", config), show=False)
    model_cfg = {k: v for k, v in dict(cfg["Model"]).items() if k != "remat"}
    opt_cfg = {k: v for k, v in dict(cfg["Optimizer"]).items() if k != "grad_clip"}
    jm = jax_build_model(dict(model_cfg))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                            train=False))["params"]
    num_layers = int(model_cfg.get("depth", 0) or getattr(jm, "depth", 0) or 0)
    jopt = jax_build_optimizer(dict(opt_cfg), params, num_layers=num_layers)
    with torch.device("meta"):
        pm = build_model(dict(model_cfg))
    popt = model_optimizer(pm, opt_cfg, model_cfg)
    paths = {flax_path(n, p.dim()): n for n, p in pm.named_parameters()}
    assert set(paths) == set(_flatten(jax.tree_util.tree_map(lambda s: np.empty(0), params)))
    scales = set()
    for jpath, name in paths.items():
        jg, pg = jopt.group_of(jpath), popt.group_of(name)
        assert (pg.name, pg.weight_decay, pg.lr_scale) == (jg.name, jg.weight_decay,
                                                          jg.lr_scale), name
        scales.add(pg.lr_scale)
    assert (len(scales) == 14) if decays else (scales == {1.0})


# ---------------------------------------------------------------- extracts


def _trained_state(path, seed=0):
    model = build_model(dict(cfg_util.get_config(path)["Model"]))
    return init_module(model, torch.Generator().manual_seed(seed)).state_dict()


def test_extracts_fill_the_structured_probes(tmp_path):
    """The learning checks' extracts (tests/e2e/run_learning_check.sh:85-183):
    a dVAE's entries under `tokenizer` fill BEiT's and CAE's tokenizers (its
    codebook and decoder are keys they ignore); BEiT's `encoder` fills its
    probe's, the pretrain's mask token left over; CAE's top-level
    `patch_embed`, `blocks` and `norm` fill its probe's encoder; ConvMAE's
    stages under `backbone`, with `fc_norm` at a LayerNorm's init, fill its
    probe's backbone."""
    from passl_tpu_torch.tools import extract_weights as ew

    dvae = _trained_state(os.path.join(E2E, "dvae_structured.yaml"))
    tok = ew.extract(dvae, "", rename="tokenizer")
    assert len(tok) == len(dvae) and "tokenizer.codebook.embedding" in tok
    out = str(tmp_path / "tokenizer.pt")
    torch.save(tok, out)
    for pre in ("beit_structured.yaml", "cae_structured.yaml"):
        assert ew.unfilled(os.path.join(E2E, pre), out, "tokenizer") == []

    beit = ew.extract(_trained_state(os.path.join(E2E, "beit_structured.yaml")), "encoder",
                      rename="encoder")
    assert "encoder.mask_token" in beit and not any(k.startswith("tokenizer") for k in beit)
    cae_state = _trained_state(os.path.join(E2E, "cae_structured.yaml"))
    with pytest.raises(SystemExit, match="no-strip-prefix"):
        ew.extract(cae_state, "patch_embed,blocks,norm")
    cae = ew.extract(cae_state, "patch_embed,blocks,norm", strip_prefix=False)
    assert "norm.weight" in cae and not any(k.startswith(("regressor", "head", "tokenizer",
                                                          "mask_token")) for k in cae)
    convmae = ew.convmae_encoder(_trained_state(os.path.join(E2E, "convmae_structured.yaml")))
    assert not any(k.startswith(("backbone.stage", "backbone.decoder", "backbone.norm",
                                 "backbone.mask")) for k in convmae)
    for picked, probe, root in ((beit, "probe_beit_structured.yaml", "encoder"),
                                (cae, "probe_cae_structured.yaml", "patch_embed,blocks,norm"),
                                (convmae, "probe_convmae_structured.yaml", "backbone")):
        out = str(tmp_path / "backbone.pt")
        torch.save(picked, out)
        assert ew.unfilled(os.path.join(E2E, probe), out, root) == [], probe
        ew.require_filled(os.path.join(E2E, probe), out, root)


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_convmae_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path, overrides = CONVMAE
    e = Engine(engine_config(path, tmp_path, *overrides, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
