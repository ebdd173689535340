"""BEiT and its dVAE tokenizer in the PyTorch port
(passl_tpu_torch/models/beit.py, discrete_vae.py, data/masking.py) against
the JAX package.

On the CPU, at tiny sizes (32 x 32 images; a dVAE of vocabulary 64, width 32,
one resblock and two downsamplings, so its 8 x 8 token grid is pooled to
the 4 x 4 patch grid; a BEiT of 2 blocks of width 64 in 8 x 8 patches), from
the JAX parameters converted, on the same numpy inputs and JAX's draws:
the relative position index, the masks and the target ids bitwise; the
dVAE's transposed convs through the converter (flipped, HWIO -> IOHW) and
back; the dVAE's loss, `recon_loss` and `kl` (f32, 1e-5 relative) and its
gradients (1e-4 of each tensor's largest entry) on the gumbel uniforms JAX
drew, straight-through and soft; BEiT's `loss` and `acc1` over the masked
patches and its gradients, none reaching the frozen tokenizer; the finetune
logits with the port's stochastic-depth draws handed to JAX; and the slice
as a whole: 3 steps each of the tiny dVAE and BEiT pretrain through the
JAX engine and the port's from JAX's state, the tokenizer unchanged in
both. A test marked `cuda` trains the tiny BEiT on the card and skips
elsewhere.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from passl_tpu_torch.data import masking as port_masking
from passl_tpu_torch.engine.engine import Engine
from passl_tpu_torch.models import beit as port_beit
from passl_tpu_torch.models import discrete_vae as port_dvae
from passl_tpu_torch.nn.layers import DropPath
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import (_flatten, _torch_name, conv_transpose_to_flax,
                                           conv_transpose_to_torch, flax_path, flax_to_torch,
                                           transposed_convs)
from test_torch_deit import _adamw_moments, assert_step_tracks, jax_states
from test_torch_moco import _randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = os.path.join(REPO, "tests", "e2e")
TOK = dict(vocab_size=64, hidden_dim=32, num_resblocks=1, downsamples=2)
ENC = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, init_values=0.1)


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
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


def _masks(n, seed, input_size=4, count=6, min_patches=2):
    """Block masks of the port's generator copy, from a seeded `random`."""
    import random

    random.seed(seed)
    gen = port_masking.MaskingGenerator(input_size, count, min_patches)
    return np.stack([gen() for _ in range(n)])


def _grads_of(jax_grads, model):
    """A flax gradient tree in the port's names and layouts."""
    names, transposed = model.state_dict(), transposed_convs(model)
    return dict(_torch_name(p, a, names=names, transposed=transposed)
                for p, a in _flatten(jax_grads).items())


def assert_grads_match(model, jax_grads, skip=()):
    """Every gradient within 1e-4 of its JAX tensor's largest entry; the
    parameters under `skip` take none. A key projection's bias adds one
    constant to every score of a row, which the softmax cancels: its gradient
    is 0 but for rounding on both sides, held under 1e-6 of the largest
    gradient entry of the model."""
    want = _grads_of(jax_grads, model)
    top = max(np.abs(w).max() for w in want.values())
    for name, p in model.named_parameters():
        if name.startswith(skip):
            assert p.grad is None, name
            continue
        w = want[name]
        if name.endswith(".k.bias"):
            assert max(np.abs(w).max(), p.grad.abs().max().item()) <= 1e-6 * top, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@contextlib.contextmanager
def recorded_uniforms(ndim):
    """jax.random.uniform records each draw of `ndim` dimensions (also under
    jit, through a debug callback) into the yielded list."""
    import jax

    record = []
    orig = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        u = orig(key, shape, *args, **kwargs)
        if len(tuple(shape)) == ndim:
            jax.debug.callback(lambda v: record.append(np.asarray(v)), u)
        return u

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        yield record


@contextlib.contextmanager
def handed_uniforms(draws):
    """The port's gumbel noise takes the given uniforms, in order."""
    queue = list(draws)

    def gumbel_uniforms(shape, generator, device):
        u = queue.pop(0)
        assert tuple(u.shape) == tuple(shape)
        return torch.from_numpy(np.array(u, np.float32)).to(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_dvae, "gumbel_uniforms", gumbel_uniforms)
        yield queue


# -------------------------------------------------- tables and conversions


@pytest.mark.parametrize("grid", [2, 4, 14, 24])
def test_rel_pos_index_is_the_jax_one_bitwise(grid):
    from passl_tpu.models.beit import _beit_rel_pos_index

    want = _beit_rel_pos_index(grid)
    got = port_beit._beit_rel_pos_index(grid)
    assert got.dtype == want.dtype and got.shape == (grid * grid + 1,) * 2
    np.testing.assert_array_equal(got, want)
    assert got.max() == (2 * grid - 1) ** 2 + 2


def test_transposed_conv_maps_flipped_both_ways():
    """flax `ConvTranspose((4, 4), strides=2, padding="SAME")` is torch's
    `conv_transpose2d(stride=2, padding=1)` on the kernel flipped in H and W
    and laid out IOHW; the inverse gives the flax kernel back bitwise, and
    without the flip the outputs are far apart."""
    import flax.linen as fnn
    import jax

    from passl_tpu_torch.nn.layers import ConvTranspose

    x = np.random.RandomState(0).randn(2, 7, 5, 6).astype(np.float32)
    m = fnn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME")
    params = m.init(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(m.apply({"params": params}, x))
    kernel = np.asarray(params["kernel"])
    weight = conv_transpose_to_torch(kernel)
    assert weight.shape == (6, 4, 4, 4)
    np.testing.assert_array_equal(conv_transpose_to_flax(weight), kernel)
    layer = ConvTranspose(6, 4)
    layer.load_state_dict({"weight": torch.from_numpy(weight),
                           "bias": torch.from_numpy(np.array(params["bias"]))})
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 14, 10, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    unflipped = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    layer.weight.data.copy_(unflipped)
    far = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(far - want).max() > 0.1


def test_converter_names_of_the_mim_leaves():
    """The codebook's embedding, BEiT's bias table and LayerScale keep their
    leaf names and layouts; a transposed conv's kernel is flipped, a conv's
    is not; `flax_path` gives each flax path back. BEiT's tokenizer has no
    codebook or decoder, as its flax variables have none."""
    dvae = port_dvae.DiscreteVAE(**TOK)
    beit = port_beit.BEiTPretrain(encoder=ENC, tokenizer=TOK, vocab_size=64)
    assert transposed_convs(dvae) == {"dec_up0", "dec_up1"} and not transposed_convs(beit)
    assert not any(k.startswith(("tokenizer.codebook", "tokenizer.dec_", "tokenizer.to_pixels"))
                   for k in beit.state_dict())
    rs = np.random.RandomState(1)
    cases = [
        (dvae, "codebook/embedding", (64, 32), "codebook.embedding", None),
        (dvae, "dec_up1/kernel", (4, 4, 64, 64), "dec_up1.weight", conv_transpose_to_torch),
        (dvae, "enc_down0/kernel", (4, 4, 3, 8), "enc_down0.weight",
         lambda a: a.transpose(3, 2, 0, 1)),
        (beit, "encoder/blocks_1/attn/relative_position_bias_table", (52, 4),
         "encoder.blocks.1.attn.relative_position_bias_table", None),
        (beit, "encoder/blocks_0/gamma_2", (64,), "encoder.blocks.0.gamma_2", None),
        (beit, "tokenizer/to_logits/kernel", (1, 1, 16, 64), "tokenizer.to_logits.weight",
         lambda a: a.transpose(3, 2, 0, 1)),
    ]
    for model, path, shape, name, layout in cases:
        names, transposed = model.state_dict(), transposed_convs(model)
        arr = rs.randn(*shape).astype(np.float32)
        key, got = _torch_name(path, arr, names=names, transposed=transposed)
        assert key == name and tuple(names[key].shape) == got.shape, path
        np.testing.assert_array_equal(got, layout(arr) if layout else arr)
        assert flax_path(key, len(shape)) == path


# -------------------------------------------------------------- the dVAE


@pytest.fixture(scope="module")
def dvae_pair():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.discrete_vae import DiscreteVAE as JaxDVAE

    jm = JaxDVAE(**TOK, kl_weight=0.1, gumbel_temperature=0.5)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "masking": jax.random.PRNGKey(1)},
                                            jnp.zeros((2, 32, 32, 3))))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 3)
    pm = port_dvae.DiscreteVAE(**TOK, kl_weight=0.1, gumbel_temperature=0.5)
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def test_dvae_tokens_and_decode_match_jax(dvae_pair):
    jm, params, pm = dvae_pair
    x = _images(3, 4)
    want = np.asarray(jm.apply({"params": params}, x, method=jm.tokenize))
    got = pm.tokenize(torch.from_numpy(x))
    assert got.dtype == torch.int64 and got.shape == (3, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8
    img_want = np.asarray(jm.apply({"params": params}, want, 8, method=jm.decode))
    img = pm.decode(got, 8).detach().numpy()
    assert img.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(img, img_want, rtol=1e-5, atol=1e-5 * np.abs(img_want).max())


@pytest.mark.parametrize("hard", [True, False])
def test_dvae_loss_and_gradients_match_jax_on_its_gumbel_draws(dvae_pair, hard):
    import jax

    jm, params, pm = dvae_pair
    jm, pm.hard = jm.clone(hard=hard), hard
    x = _images(4, 5)

    def loss_fn(p):
        out = jm.apply({"params": p}, x, train=True, rngs={"masking": jax.random.PRNGKey(7)})
        return out["loss"], out

    with recorded_uniforms(4) as draws:
        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    assert len(draws) == 1 and draws[0].shape == (4, 8, 8, 64)
    pm.train().zero_grad(set_to_none=True)
    with handed_uniforms(draws) as left:
        out = pm(torch.from_numpy(x), generator=torch.Generator())
    assert not left and set(out) == {"loss", "recon_loss", "kl"}
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    out["loss"].backward()
    assert_grads_match(pm, jax.device_get(grads))
    assert pm.codebook.embedding.grad.abs().max() > 0
    pm.eval()
    with torch.no_grad():  # eval: the argmax code, no draw
        ev = pm(torch.from_numpy(x))
    want_ev = jm.apply({"params": params}, x, train=False)
    np.testing.assert_allclose(ev["loss"].item(), float(want_ev["loss"]), rtol=1e-5)


# ---------------------------------------------------------------- BEiT


@pytest.fixture(scope="module")
def beit_pair():
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.beit import BEiTPretrain as JaxBEiT

    jm = JaxBEiT(encoder=ENC, tokenizer=TOK, vocab_size=64)
    batch = (jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 16), jnp.int32))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 5)
    pm = port_beit.BEiTPretrain(encoder=ENC, tokenizer=TOK, vocab_size=64).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


def test_beit_loss_acc_and_gradients_match_jax(beit_pair):
    """Two batches: the target ids (the tokenizer's 8 x 8 grid pooled to the
    4 x 4 patches) bitwise, `loss` and `acc1` over the masked patches only
    (1e-5 relative), every gradient (1e-4 of the largest entry), none into
    the tokenizer."""
    import jax

    jm, params, pm = beit_pair

    @jax.jit
    def step(p, batch):
        def loss(p):
            out = jm.apply({"params": p}, batch)
            return out["loss"], out

        return jax.grad(loss, has_aux=True)(p)

    for seed in (0, 1):
        batch = (_images(4, 10 + seed), _images(4, 20 + seed), _masks(4, seed))
        assert all(1 <= m.sum() <= 6 for m in batch[2])
        grads, want = step(params, batch)
        pm.zero_grad(set_to_none=True)
        out = pm(tuple(torch.from_numpy(np.asarray(b)) for b in batch),
                 generator=torch.Generator())
        for k in ("loss", "acc1"):
            np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        out["loss"].backward()
        assert_grads_match(pm, jax.device_get(grads), skip=("tokenizer.",))


def test_beit_targets_are_jaxs_bitwise_and_only_masked_patches_count(beit_pair):
    from passl_tpu.models.discrete_vae import DiscreteVAE as JaxDVAE

    jm, params, pm = beit_pair
    tok_view = _images(4, 30)
    want = np.asarray(JaxDVAE(**TOK).apply({"params": params["tokenizer"]}, tok_view,
                                           method=JaxDVAE.tokenize))
    got = pm.tokenizer.tokenize(torch.from_numpy(tok_view))
    np.testing.assert_array_equal(got.numpy(), want)
    pooled = port_beit._pool_targets(got, 16)
    np.testing.assert_array_equal(pooled.numpy(),
                                  want.reshape(4, 4, 2, 4, 2)[:, :, 0, :, 0].reshape(4, 16))
    # the cross-entropy and acc1 are the masked patches' alone
    view, mask = torch.from_numpy(_images(4, 31)), torch.from_numpy(_masks(4, 3))
    with torch.no_grad():
        out = pm((view, torch.from_numpy(tok_view), mask), generator=torch.Generator())
        logits = pm.head(pm.encoder(view, bool_mask=mask)[:, 1:])
    nll = -torch.log_softmax(logits, -1).gather(-1, pooled[:, :, None])[:, :, 0]
    at = mask.bool()
    torch.testing.assert_close(out["loss"], nll[at].mean(), rtol=1e-6, atol=0)
    torch.testing.assert_close(out["acc1"], (logits.argmax(-1) == pooled)[at].float().mean())


# ------------------------------------------------------------ the finetune


@contextlib.contextmanager
def recorded_drop_path_draws():
    """The port's DropPath uniforms, in the order the forward draws them."""
    record = []
    orig = DropPath.draw

    def draw(self, x, generator):
        u = orig(self, x, generator)
        if u is not None:
            record.append((u, self.rate))
        return u

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DropPath, "draw", draw)
        yield record


@contextlib.contextmanager
def handed_bernoulli(masks):
    """jax.random.bernoulli gives the masks given, in the order it is traced."""
    import jax
    import jax.numpy as jnp

    calls = []

    def bernoulli(key, p, shape):
        m = masks[len(calls)]
        calls.append(1)
        assert tuple(m.shape) == tuple(shape)
        return jnp.asarray(m)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        yield calls


def finetune_logits_match(jm, params, pm, x, draws_expected):
    """The port's train-mode logits on its own drop-path draws against JAX's
    on the same keep masks, and the eval logits; 1e-5 of the largest."""
    pm.train()
    with recorded_drop_path_draws() as draws:
        got = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    assert len(draws) == draws_expected
    masks = [(u < 1.0 - rate).numpy() for u, rate in draws]
    assert any(m.all() for m in masks) or any(not m.all() for m in masks)
    with handed_bernoulli(masks) as calls:
        import jax

        want = np.asarray(jm.apply({"params": params}, x, train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)}))
    assert len(calls) == draws_expected
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("global_pool", [True, False])
def test_beit_finetune_logits_match_jax_with_drop_path(global_pool):
    import jax
    import jax.numpy as jnp

    from passl_tpu.models.beit import BEiTFinetune as JaxFT

    enc = dict(ENC, drop_path_rate=0.5)
    jm = JaxFT(encoder=enc, num_classes=10, global_pool=global_pool)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), 6)
    assert "mask_token" not in params["encoder"]
    pm = port_beit.BEiTFinetune(encoder=enc, num_classes=10, global_pool=global_pool)
    pm.load_state_dict(flax_to_torch(params, pm))
    assert pm.encoder.mask_token is None and pm.frozen_patterns() == []
    # the rates are linspace(0, 0.5, 2): block 0 draws nothing, block 1 twice
    finetune_logits_match(jm, params, pm, _images(6, 8), 2)
    assert port_beit.BEiTFinetune(encoder=ENC, freeze_encoder=True).frozen_patterns() == [
        r"^encoder\."]


# ----------------------------------------------------- the slice as a whole

STEPS = 3
SMALL = ["DataLoader.Train.dataset.size=24", "DataLoader.Train.sampler.batch_size=8"]
DVAE = (os.path.join(E2E, "dvae_structured.yaml"),
        SMALL + ["Model.vocab_size=64", "Model.hidden_dim=32"])
BEIT = (os.path.join(E2E, "beit_structured.yaml"),
        SMALL + ["Global.pretrained_model=None", "Model.encoder.depth=2",
                 "Model.encoder.embed_dim=64", "Model.tokenizer.vocab_size=64",
                 "Model.tokenizer.hidden_dim=32", "Model.vocab_size=64"])


def engine_config(path, tmp_path, *overrides):
    return cfg_util.get_config(path, overrides=[f"Global.output_dir={tmp_path}", *overrides])


def jax_engine_run(path, overrides, tmp, during=contextlib.nullcontext):
    """The JAX engine's first STEPS loader batches, its metrics on them and its
    state before each step and after the last (parameters and BatchNorm
    statistics, AdamW moments) in the port's names and layouts; the steps run
    inside `during()`."""
    from passl_tpu.engine import Engine as JaxEngine
    from passl_tpu_torch.models import build_model

    port = build_model(dict(engine_config(path, tmp, *overrides)["Model"]))
    je = JaxEngine(engine_config(path, tmp, *overrides), mode="train")
    je.train_dataloader.set_epoch(1)
    batches = []
    for b in je.train_dataloader:
        batches.append(b)
        if len(batches) == STEPS:
            break

    def convert(model, state):
        return (flax_to_torch(state.params, model, state.model_state.get("batch_stats")),
                _adamw_moments(state.opt_state, model.state_dict(), transposed_convs(model)))

    with during() as record:
        metrics, states = jax_states(je, batches, port, convert)
        import jax

        jax.effects_barrier()
    je.train_dataloader.close()
    return batches, metrics, states, record


def test_tiny_dvae_steps_along_the_jax_engine(tmp_path):
    """tests/e2e/dvae_structured.yaml (straight-through, KL 0.02, temperature
    0.5) at vocabulary 64 and width 32: each of the JAX engine's first 3
    steps from JAX's state on the gumbel uniforms it drew."""
    path, overrides = DVAE
    batches, jax_metrics, states, draws = jax_engine_run(
        path, overrides, tmp_path / "jax", lambda: recorded_uniforms(4))
    assert len(draws) == STEPS and draws[0].shape == (8, 4, 4, 64)
    e = Engine(engine_config(path, tmp_path, *overrides), mode="train", device="cpu")
    assert isinstance(e.model, port_dvae.DiscreteVAE) and e.model.hard
    with handed_uniforms(draws) as left:
        for t, (b, want) in enumerate(zip(batches, jax_metrics)):
            assert set(want) >= {"loss", "recon_loss", "kl"}
            assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    assert not left and e.state.step == STEPS
    e.close()


def test_tiny_beit_steps_along_the_jax_engine_with_the_tokenizer_frozen(tmp_path):
    """tests/e2e/beit_structured.yaml at 2 blocks of width 64 and a tokenizer
    of vocabulary 64: each of the JAX engine's first 3 steps (AdamW, clip 3)
    from JAX's state on its batches (the two views and the block masks); the
    tokenizer does not move in either engine and holds no optimizer state in
    the port's."""
    path, overrides = BEIT
    batches, jax_metrics, states, _ = jax_engine_run(path, overrides, tmp_path / "jax")
    tok = [k for k in states[0][0] if k.startswith("tokenizer.")]
    assert tok and all(torch.equal(s[0][k], states[0][0][k]) for s in states for k in tok)
    e = Engine(engine_config(path, tmp_path, *overrides), mode="train", device="cpu")
    assert isinstance(e.model, port_beit.BEiTPretrain)
    for t, (b, want) in enumerate(zip(batches, jax_metrics)):
        assert len(b) == 3 and b[2].shape == (8, 16) and b[2].sum(1).max() <= 6
        assert_step_tracks(e, b, want, states[t], states[t + 1], t)
    final = e.model.state_dict()
    assert all(torch.equal(final[k], states[0][0][k]) for k in tok)
    stateful = {id(p) for p in e.optimizer.torch_optimizer.state}
    assert all((id(p) in stateful) != n.startswith("tokenizer.")
               for n, p in e.model.named_parameters())
    e.close()


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_tiny_beit_trains_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path, overrides = BEIT
    e = Engine(engine_config(path, tmp_path, *overrides, "Global.max_train_step=2",
                             "Global.print_batch_step=1"), mode="train", device="cuda")
    tok0 = {k: v.clone() for k, v in e.model.state_dict().items() if k.startswith("tokenizer.")}
    e.train()
    assert [np.isfinite(h["loss"]) for h in e.train_loop.history] == [True, True]
    assert all(torch.equal(e.model.state_dict()[k], v) for k, v in tok0.items())
