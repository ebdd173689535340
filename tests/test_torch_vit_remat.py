"""ViT activation recompute (`remat`, `remat_policy`) of the PyTorch port
(passl_tpu_torch/models/vision_transformer.py) against no recompute and
against the JAX model's `nn.remat(Block)`.

The tiny ViT has 2 blocks over a 32 x 32 image in 4 x 4 patches (65 tokens,
the flash resolver's shortest) and stochastic depth at 0.3. On the CPU each
policy's gradients equal no recompute's bit for bit on the einsum and flash
paths, from one generator state, and leave the generator where no recompute
does; what the backward runs again is what the policy leaves unsaved (the
Dense products under `nothing`, the attention, flash forward included,
under `nothing` and `dots_no_batch`, neither under `dots`). Against the JAX
model with `remat: True`, the masks the port's generator draws are handed to
JAX's `jax.random.bernoulli`, and the gradients agree to f32 rounding. An
unknown policy raises as JAX's does; vit_large_patch16_384_ft_in1k.yaml
builds with its `dots_no_batch`. A test marked `cuda` checks the doubled
flash forward launches on the card and skips elsewhere.
"""
import contextlib
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import passl_tpu_torch.models.vision_transformer as port_vit
from passl_tpu_torch.models import build_model
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.ops import attention as port_attention
from passl_tpu_torch.utils import cfg_util
from passl_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, patch_size=4, embed_dim=64, depth=2, num_heads=2, num_classes=8,
            drop_path_rate=0.3)
POLICIES = ["nothing", "dots_no_batch", "dots"]


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


def _model(policy, impl="einsum", seed=0, **kw):
    m = port_vit.VisionTransformer(**{**TINY, **kw}, attn_impl=impl, remat=policy is not None,
                                   remat_policy=policy or "nothing")
    return init_module(m, torch.Generator().manual_seed(seed)).train()


def _images(n=4, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32))


def _step(model, x, gen_state):
    """Logits, every parameter's gradient of sum(logits * w), and the
    generator's state after the forward, from the generator state given."""
    gen = torch.Generator()
    gen.set_state(gen_state)
    w = torch.from_numpy(np.random.RandomState(2).randn(x.shape[0], 8).astype(np.float32))
    out = model(x, generator=gen)
    (out * w).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}, gen.get_state()


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_are_bitwise_the_ones_without(policy, impl):
    x = _images()
    state = torch.Generator().manual_seed(123).get_state()
    want = _step(_model(None, impl), x, state)
    got = _step(_model(policy, impl), x, state)
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for name, g in got[1].items():
        assert torch.equal(g, want[1][name]), name
    assert torch.equal(got[2], want[2])  # the recompute drew nothing more
    # the drop path did act: some sample of some block was dropped
    gen = torch.Generator()
    gen.set_state(state)
    assert (torch.rand(4 * TINY["depth"] * 2, generator=gen) < 0.3 / 2).any()


class _Count(TorchDispatchMode):
    """Counts the products run while active, by overload packet."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket).split(".")[-1]
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", [None, *POLICIES])
def test_the_backward_recomputes_what_the_policy_leaves(policy, monkeypatch):
    """What the backward runs beyond the backward without remat: under
    `nothing` the Dense products (`addmm`) and the attention (its two batched
    products, and the flash forward on the flash path); under `dots_no_batch`
    the attention alone; under `dots` no product, and the flash forward, which
    is no product, again."""
    forwards = []
    fwd_ref = port_attention.flash_attention_fwd_ref
    monkeypatch.setattr(port_attention, "flash_attention_fwd_ref",
                        lambda *a: forwards.append(1) or fwd_ref(*a))
    x = _images()
    for impl in ("einsum", "flash"):
        counts = []
        for p in (None, policy):
            out = _model(p, impl)(x, generator=torch.Generator().manual_seed(1))
            forwards.clear()
            with _Count() as count:
                out.sum().backward()
            counts.append((count.counts, len(forwards)))
        (base, _), (got, again) = counts
        extra = {k: got.get(k, 0) - base.get(k, 0) for k in ("addmm", "bmm")}
        # 2 blocks of 4 Dense layers: the recompute stops once it has every
        # tensor the backward needs, so the last block's fc2 (whose output the
        # backward does not read) runs no more: 7 products
        want = {None: (0, 0), "nothing": (7, 4), "dots_no_batch": (0, 4), "dots": (0, 0)}[policy]
        assert (extra["addmm"], extra["bmm"]) == want, (impl, got, base)
        assert again == (2 if impl == "flash" and policy else 0), impl


def _jax_pair(policy, seed=3):
    """The flax ViT with remat (and drop path) and its redrawn parameters, and
    the port's ViT with the same weights."""
    import jax
    import jax.numpy as jnp

    import passl_tpu.models.vision_transformer as jax_vit
    from test_torch_vit import _randomize

    jm = jax_vit.VisionTransformer(**TINY, remat=True, remat_policy=policy)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    params = _randomize(shapes, seed)
    pm = port_vit.VisionTransformer(**TINY, remat=True, remat_policy=policy).train()
    pm.load_state_dict(flax_to_torch(params, pm))
    return jm, params, pm


@contextlib.contextmanager
def _handed_masks(masks):
    """jax.random.bernoulli gives the masks given, in the order it is traced
    (each DropPath, block by block), and counts its calls."""
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


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_with_drop_path_matches_the_jax_remat(policy):
    """The JAX model with `remat: True` and the policy, on the masks the port's
    generator draws from the state given: every parameter's gradient."""
    import jax
    import jax.numpy as jnp

    jm, params, pm = _jax_pair(policy)
    x = _images(4, seed=4)
    state = torch.Generator().manual_seed(1).get_state()  # drops 2 and 2 of 4 samples
    gen = torch.Generator()
    gen.set_state(state)
    # block 0's rate is 0 (drawing nothing in either package), block 1's 0.3
    masks = [(torch.rand(4, 1, 1, generator=gen) < 0.7).numpy() for _ in range(2)]
    assert not all(m.all() for m in masks)  # some sample dropped
    w = np.random.RandomState(2).randn(4, 8).astype(np.float32)  # as `_step` weighs the logits

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x.numpy()), train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * w)

    with _handed_masks(masks) as calls:
        grads = jax.device_get(jax.jit(jax.grad(loss))(params))
    assert len(calls) == 2
    want = flax_to_torch(grads, pm)
    out, got, _ = _step(pm, x, state)
    for name, g in got.items():
        wv = want[name].numpy()
        # f32, sums in another order: 1e-4 of the tensor's largest entry
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-4 * np.abs(wv).max(),
                                   err_msg=name)


def test_remat_draws_the_masks_the_jax_rule_keeps():
    """A block at rate 0 draws nothing (JAX's DropPath returns x at rate 0),
    so the generator's stream is the same with and without the first block."""
    m = _model("nothing")
    assert m.blocks[0].drop_path1.rate == 0.0
    gen = torch.Generator().manual_seed(0)
    tokens = torch.zeros(2, 65, 64)
    assert m.blocks[0].draw(tokens, gen) == (None, None)
    d1, d2 = m.blocks[1].draw(tokens, gen)
    assert d1.shape == d2.shape == (2, 1, 1) and not torch.equal(d1, d2)


def test_remat_in_eval_and_without_gradients_runs_plain():
    model, x = _model("dots_no_batch"), _images(2)
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(0))
    model.eval()
    with torch.inference_mode():
        b = model(x)
    assert a.shape == b.shape == (2, 8)


@pytest.mark.parametrize("remat", [True, False])
def test_an_unknown_remat_policy_raises_as_jax_does(remat):
    """With remat on, a policy outside the three raises ValueError naming them
    (JAX `resolve_remat_policy`); with remat off the policy is never read, as
    in JAX."""
    if not remat:
        m = port_vit.VisionTransformer(**TINY, remat=False, remat_policy="everything")
        assert m.remat_policy is None
        return
    with pytest.raises(ValueError, match=r"unknown remat_policy 'everything'; expected one of "
                                         r"\['dots', 'dots_no_batch', 'nothing'\]"):
        port_vit.VisionTransformer(**TINY, remat=True, remat_policy="everything")


def test_vit_large_384_builds_with_its_remat_policy():
    path = os.path.join(REPO, "configs", "classification", "vit_large_patch16_384_ft_in1k.yaml")
    model_cfg = dict(cfg_util.get_config(path, show=False)["Model"])
    assert model_cfg["remat"] is True and model_cfg["remat_policy"] == "dots_no_batch"
    with torch.device("meta"):
        model = build_model(model_cfg)
    assert model.remat_policy == "dots_no_batch" and len(model.blocks) == 24
    assert model.blocks[-1].drop_path1.rate == pytest.approx(0.1)


# ---------------------------------------------------------------- card only


@pytest.mark.cuda
def test_remat_on_the_card_runs_the_flash_forward_twice():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = _images(4).cuda()
    state = torch.Generator(device="cuda").manual_seed(3).get_state()
    grads = {}
    for policy in (None, *POLICIES):
        m = _model(policy, "flash").cuda()
        gen = torch.Generator(device="cuda")
        gen.set_state(state)
        port_attention.flash_attention.launches = 0
        m(x, generator=gen).sum().backward()
        want = 2 if policy is None else 4
        assert port_attention.flash_attention.launches == want, policy
        grads[policy] = torch.cat([p.grad.flatten() for p in m.parameters()])
    for policy in POLICIES:
        assert torch.equal(grads[policy], grads[None]), policy
