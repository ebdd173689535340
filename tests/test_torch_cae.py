"""CAE of the PyTorch port (passl_tpu_torch/models/cae.py) against the JAX
package.

On the CPU, at tiny sizes (32 x 32 images in 8 x 8 patches, an encoder of 2
blocks of width 64, a regressor of 1 cross-attention block, the tokenizer of
test_torch_beit.py), from the JAX parameters converted, on the same numpy
inputs: the visible-first split bitwise, a short mask's included (90 of the
98 patches of configs/cae/cae_base_patch16_224_in1k.yaml, where the last
visible patches in raster order fill `ids_mask`, as in JAX); `token_loss`,
`align_loss`, `loss` and `acc1` (f32, 1e-5 relative) and every gradient
(1e-4 of the largest entry), none into the tokenizer or through the
teacher; the finetune logits; the probe fault of the JAX CAEFinetune at
`num_classes: 0` (its probe's logits do not depend on the image) and the
port's pooled features there; and 3 steps of the tiny CAE through the JAX
engine and the port's from JAX's state, short masks included. A test marked
`cuda` trains the tiny CAE on the card and skips elsewhere.
"""
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import build_model
from passl_tpu_torch.models import cae as port_cae
from passl_tpu_torch.utils.convert import flax_to_torch
from test_torch_beit import (E2E, SMALL, TOK, _images, _masks, assert_grads_match,
                             engine_config, jax_engine_run)
from test_torch_deit import assert_step_tracks
from test_torch_moco import _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
PRE = dict(KW, regressor_depth=1, vocab_size=64, tokenizer=TOK, num_masked=6)


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


def _jax_split(bool_mask, num_masked):
    """The JAX model's split (cae.py:98-100), on its own."""
    import jax.numpy as jnp

    l = bool_mask.shape[1]
    order = jnp.argsort(jnp.asarray(bool_mask).astype(jnp.int32) * l + jnp.arange(l)[None], axis=1)
    return np.asarray(order[:, :l - num_masked]), np.asarray(order[:, l - num_masked:])


def test_a_short_mask_splits_as_jax_splits_it():
    """configs/cae/cae_base_patch16_224_in1k.yaml's 98 of 196: a mask of 90
    puts its 90 patches and the 8 last visible ones in raster order into
    ids_mask, bitwise as JAX; a full mask holds exactly its own patches."""
    import random

    from passl_tpu_torch.data.masking import MaskingGenerator

    model = port_cae.CAEPretrain(img_size=224, patch_size=16, depth=0, regressor_depth=0,
                                 num_masked=98, tokenizer=TOK)
    random.seed(0)
    gen = MaskingGenerator(14, 98, 16)
    masks = [gen() for _ in range(64)]
    short = [m for m in masks if m.sum() < 98]
    assert short and [m for m in masks if m.sum() == 98]
    rs = np.random.RandomState(0)
    ninety = np.zeros(196, np.int32)
    ninety[rs.choice(196, 90, replace=False)] = 1
    batch = np.stack([ninety] + masks)
    ids_vis, ids_mask = model.split(torch.from_numpy(batch))
    want_vis, want_mask = _jax_split(batch, 98)
    np.testing.assert_array_equal(ids_vis.numpy(), want_vis)
    np.testing.assert_array_equal(ids_mask.numpy(), want_mask)
    assert ids_vis.shape == (65, 98) and ids_mask.shape == (65, 98)
    for v, m, b in zip(ids_vis.numpy(), ids_mask.numpy(), batch):
        assert sorted(np.concatenate([v, m])) == list(range(196))
        assert b[m].sum() == min(b.sum(), 98) and b[v].sum() == max(b.sum() - 98, 0)
    visible = np.flatnonzero(ninety == 0)
    assert set(ids_mask[0].numpy()) == set(np.flatnonzero(ninety)) | set(visible[-8:])


@pytest.fixture(scope="module")
def cae_pair():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.cae import CAEPretrain as JaxCAE

    jm = JaxCAE(**PRE)
    batch = (jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 32, 32, 3)),
             jnp.asarray(_masks(2, 0)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 7)
    pm = port_cae.CAEPretrain(**PRE).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def test_cae_losses_and_gradients_match_jax(cae_pair):
    """Two batches, one of them with a short mask: the four outputs (1e-5
    relative) and every gradient (1e-4 of the largest entry); the tokenizer
    takes none, and the teacher's pass adds none (JAX's stop_gradient)."""
    import jax

    jm, params, pm = cae_pair

    @jax.jit
    def step(p, batch):
        def loss(p):
            out = jm.apply({"params": p}, batch)
            return out["loss"], out

        return jax.grad(loss, has_aux=True)(p)

    for seed in (0, 4):
        masks = _masks(4, seed)
        if seed:
            masks[0] = 0
            masks[0, [1, 5, 6, 9]] = 1  # 4 of the 6: two visible patches join ids_mask
        batch = (_images(4, 40 + seed), _images(4, 50 + seed), masks)
        grads, want = step(params, batch)
        pm.zero_grad(set_to_none=True)
        out = pm(tuple(torch.from_numpy(b) for b in batch), generator=torch.Generator())
        assert set(out) == {"loss", "token_loss", "align_loss", "acc1"}
        for k in out:
            np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        out["loss"].backward()
        assert_grads_match(pm, jax.device_get(grads), skip=("tokenizer.",))
        assert pm.mask_token.grad.abs().max() > 0


def test_weights_scale_the_two_losses():
    pm = port_cae.CAEPretrain(**dict(PRE, align_weight=0.5, token_weight=3.0))
    from passl_tpu_torch.nn.init import init_module

    init_module(pm, torch.Generator().manual_seed(0))
    batch = (torch.from_numpy(_images(2, 1)), torch.from_numpy(_images(2, 2)),
             torch.from_numpy(_masks(2, 1)))
    with torch.no_grad():
        out = pm(batch)
    torch.testing.assert_close(out["loss"], 3.0 * out["token_loss"] + 0.5 * out["align_loss"])
    assert 0.0 <= out["acc1"].item() <= 1.0


def test_cae_finetune_logits_match_jax():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.cae import CAEFinetune as JaxFT

    jm = JaxFT(**KW, num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 8)
    pm = port_cae.CAEFinetune(**KW, num_classes=10)
    pm.load_state_dict(flax_to_torch(params, pm))
    x = _images(4, 9)
    want = np.asarray(jm.apply({"params": params}, x, train=True))
    got = pm.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert port_cae.CAEFinetune(**KW, freeze_encoder=True).frozen_patterns() == [
        r"^(patch_embed|blocks\.|norm)"]


def test_the_jax_probe_at_num_classes_0_sees_no_image_and_the_ports_does():
    """configs/cae/cae_base_lp_in1k.yaml's probe: the JAX CAEFinetune at
    num_classes 0 ends in a Dense(0), so the LinearProbe's head has a (0, 10)
    kernel and its logits are the same for every image. The port's
    CAEFinetune returns the pooled features there, as ConvViT does, and its
    probe's logits move with the image."""
    import jax

    from passl_tpu.models.classification import LinearProbe as JaxProbe

    backbone = dict(name="CAEFinetune", **KW, num_classes=0, global_pool=True)
    jm = JaxProbe(backbone=backbone, num_classes=10, freeze_backbone=True, with_pool=False)
    x = np.stack([_images(1, 60)[0], _images(1, 61)[0]])
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(x)
    assert variables["params"]["fc"]["kernel"].shape == (0, 10)
    logits = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    assert np.abs(logits[0] - logits[1]).max() == 0.0
    pm = build_model({"name": "LinearProbe", "backbone": backbone, "num_classes": 10,
                      "with_pool": False})
    assert pm.backbone.out_channels == 64 and pm.fc.weight.shape == (10, 64)
    from passl_tpu_torch.nn.init import init_module

    init_module(pm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    assert (got[0] - got[1]).abs().max() > 1e-4


# ----------------------------------------------------- the slice as a whole

CAE = (os.path.join(E2E, "cae_structured.yaml"),
       SMALL + ["Global.pretrained_model=None", "Model.depth=2", "Model.embed_dim=64",
                "Model.regressor_depth=1", "Model.tokenizer.vocab_size=64",
                "Model.tokenizer.hidden_dim=32", "Model.vocab_size=64"])


def test_tiny_cae_steps_along_the_jax_engine(tmp_path):
    """tests/e2e/cae_structured.yaml at 2 blocks of width 64: each of the JAX
    engine's first 3 steps (AdamW, clip 3) from JAX's state on its batches,
    whose block masks of up to 8 of 16 patches fall short in some images; the
    tokenizer does not move."""
    path, overrides = CAE
    batches, jax_metrics, states, _ = jax_engine_run(path, overrides, tmp_path / "jax")
    e = Engine(engine_config(path, tmp_path, *overrides), mode="train", device="cpu")
    assert isinstance(e.model, port_cae.CAEPretrain) and e.model.num_masked == 8
    counts = np.concatenate([b[2].sum(1) for b in batches])
    assert counts.max() <= 8
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert set(want) >= {"loss", "token_loss", "align_loss", "acc1"}
        # the regressor's key bias: a gradient of 0 but for rounding, which
        # AdamW scales up to the lr (test_torch_deit.py holds the ViT's the same way)
        assert_step_tracks(e, b, want, states[t], states[t + 1], t,
                           skip=lambda name: name.endswith(".k.bias"))
    tok = [k for k in states[0][0] if k.startswith("tokenizer.")]
    final = e.model.state_dict()
    assert tok and all(torch.equal(final[k], states[0][0][k]) for k in tok)
    assert all(torch.equal(states[-1][0][k], states[0][0][k]) for k in tok)
    e.close()


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_cae_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path, overrides = CAE
    e = Engine(engine_config(path, tmp_path, *overrides, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
