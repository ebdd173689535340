"""Device augmentation of the PyTorch port: the plain `ops/augment.py` and the
fused op `ops/augment_kernel.py`.

On the CPU: the plain twin `fused_augment_ref` against the JAX package's
`fused_augment` with its Pallas kernel in interpret mode, at settings where
the draws decide nothing (every blur and solarize coin at 0 or 1, one sigma),
taps 5, 9 and 23, images smaller than the taps (every position an edge),
one channel, and the radii where the card's fast kernel branches (taps 1,
3, 4 and 25) on rows of odd width; the port's `gaussian_blur` against JAX's
with per-sample sigmas; the core of `byol_device_augment` on the draws JAX
made against JAX's `byol_device_augment`; and the op's per-sample randomness
and coin rates, which the plain version reproduces on the CPU. Tests marked
`cuda` hold the kernels against their plain version on the card (each
case's kernel, fast or generic, named; aligned, 4-byte and misaligned rows;
the widest row the generic kernel takes), replay the op from a CUDA graph,
and skip elsewhere; they import no JAX, so
`python -m pytest --noconftest -m cuda <this file>` runs them on a machine
without it.
"""
import numpy as np
import pytest
import torch

from passl_tpu_torch.ops import augment as paug
from passl_tpu_torch.ops.augment_kernel import (fused_augment, fused_augment_draws,
                                                fused_augment_kernel_for, fused_augment_ref,
                                                fused_augment_with_draws)

# f32 plain ops against the JAX ops: the same f32 products summed in another order
F32_TOL = 1e-5
MEAN1, STD1 = (0.45,), (0.226,)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One unit in the last place of bf16 (8 significant bits) at |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _images(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _jax_fused(images, seed, **kw):
    import jax.numpy as jnp

    from passl_tpu.ops.pallas.augment_kernel import fused_augment as jax_fused_augment

    out = jax_fused_augment(jnp.asarray(images), jnp.int32(seed), interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _assert_within_one_ulp(got: np.ndarray, want: np.ndarray) -> None:
    # both round one f32 value to bf16; their f32 sums run in another order,
    # so a rounding may flip by one bf16 ulp of the larger value. Near zero
    # (x close to the mean) the bf16 grid is finer than the f32 values' own
    # error, a few f32 ulps of 1 scaled by 1 / std (the plain version was
    # 2.8e-6 from float64 on an H100): 1e-5 is the floor
    tol = np.maximum(_bf16_ulp(np.maximum(np.abs(got), np.abs(want))), 1e-5)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.sum()} entries beyond one bf16 ulp, max diff "
                           f"{np.abs(got - want).max()}: {list(zip(got[bad][:5], want[bad][:5]))}")


COINS = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)]


@pytest.mark.parametrize("taps", [5, 9, 23])
@pytest.mark.parametrize("blur_prob, solarize_prob", COINS)
def test_ref_matches_the_pallas_kernel(taps, blur_prob, solarize_prob):
    """[2, 16, 24, 3]: a non-square image, at 23 taps wider than its height."""
    imgs = _images((2, 16, 24, 3), seed=taps)
    kw = dict(blur_prob=blur_prob, solarize_prob=solarize_prob, taps=taps,
              sigma_range=(1.5, 1.5), solarize_threshold=0.5)
    want = _jax_fused(imgs, 3, **kw)
    got = fused_augment_ref(torch.from_numpy(imgs), torch.rand(2, 3), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 24, 3)
    _assert_within_one_ulp(got.float().numpy(), want)


@pytest.mark.parametrize("blur_prob, solarize_prob", COINS)
def test_ref_matches_the_pallas_kernel_every_position_an_edge(blur_prob, solarize_prob):
    """16 x 16 at 23 taps: every output's window crosses the border, so each
    position has its own edge denominator."""
    imgs = _images((2, 16, 16, 3), seed=30)
    kw = dict(blur_prob=blur_prob, solarize_prob=solarize_prob, taps=23, sigma_range=(2.0, 2.0))
    want = _jax_fused(imgs, 5, **kw)
    got = fused_augment_ref(torch.from_numpy(imgs), torch.rand(2, 3), **kw).float().numpy()
    _assert_within_one_ulp(got, want)
    if blur_prob:  # the corner sees fewer taps than the centre: renormalized, not darkened
        plain = fused_augment_ref(torch.from_numpy(imgs), torch.rand(2, 3),
                                  **{**kw, "blur_prob": 0.0}).float().numpy()
        assert abs(got[:, 0, 0].mean() - plain.mean()) < 1.0


@pytest.mark.parametrize("blur_prob, solarize_prob", [(1.0, 0.0), (1.0, 1.0)])
def test_ref_matches_the_pallas_kernel_one_channel(blur_prob, solarize_prob):
    imgs = _images((2, 16, 24, 1), seed=31)
    kw = dict(blur_prob=blur_prob, solarize_prob=solarize_prob, taps=9, sigma_range=(0.8, 0.8),
              solarize_threshold=0.3, mean=MEAN1, std=STD1)
    want = _jax_fused(imgs, 7, **kw)
    got = fused_augment_ref(torch.from_numpy(imgs), torch.rand(2, 3), **kw).float().numpy()
    _assert_within_one_ulp(got, want)


@pytest.mark.parametrize("taps", [1, 3, 4, 25])
@pytest.mark.parametrize("shape", [(2, 9, 7, 3), (2, 6, 11, 1)])
def test_ref_matches_the_pallas_kernel_at_the_fast_kernels_radii(shape, taps):
    """The radii where the card's fast kernel branches (taps 1 and 3; 4,
    whose radius 2 is that of taps 5; 25), on non-square images whose row
    width W C is odd (21 and 11), with blur and solarize on: the plain twin
    the card holds the kernel against is pinned to the Pallas kernel there."""
    imgs = _images(shape, seed=40 + taps)
    kw = dict(blur_prob=1.0, solarize_prob=1.0, taps=taps, sigma_range=(1.5, 1.5))
    if shape[-1] == 1:
        kw.update(mean=MEAN1, std=STD1)
    want = _jax_fused(imgs, 9, **kw)
    got = fused_augment_ref(torch.from_numpy(imgs), torch.rand(2, 3), **kw)
    assert got.shape == shape
    _assert_within_one_ulp(got.float().numpy(), want)


def test_gaussian_blur_matches_jax_per_sample_sigmas():
    import jax.numpy as jnp

    from passl_tpu.ops import augment as jaug

    x = np.random.RandomState(1).rand(3, 12, 20, 3).astype(np.float32)
    sig = np.asarray([0.1, 0.9, 2.0], np.float32)
    for taps in (5, 23):
        want = np.asarray(jaug.gaussian_blur(jnp.asarray(x), jnp.asarray(sig), taps))
        got = paug.gaussian_blur(torch.from_numpy(x), torch.from_numpy(sig), taps).numpy()
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # a square image reuses the row operator for the columns
    xs = x[:, :12, :12]
    want = np.asarray(jaug.gaussian_blur(jnp.asarray(xs), jnp.asarray(sig), 9))
    got = paug.gaussian_blur(torch.from_numpy(xs), torch.from_numpy(sig), 9).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _jax_byol_draws(rng, n):
    """The sigmas and coins `passl_tpu.ops.augment.byol_device_augment` draws
    from `rng`, by its key splits (`augment.py:173-178`, `:90-93`, `:44-45`)."""
    import jax

    k1, k2, k3, _ = jax.random.split(rng, 4)
    out = {}
    for i, (key, prob) in enumerate(((k1, 1.0), (k2, 0.1)), start=1):
        ks, km = jax.random.split(key)
        out[f"sigma{i}"] = np.asarray(jax.random.uniform(ks, (n,), minval=0.1, maxval=2.0))
        out[f"blur{i}"] = np.asarray(jax.random.bernoulli(km, prob, (n, 1, 1, 1))).reshape(n)
    out["solarize2"] = np.asarray(jax.random.bernoulli(k3, 0.2, (n, 1, 1, 1))).reshape(n)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 3])
def test_byol_device_augment_core_matches_jax(seed):
    import jax
    import jax.numpy as jnp

    from passl_tpu.ops import augment as jaug

    n = 16  # enough images that view 2's coins come up both ways for these seeds
    v1, v2 = _images((n, 12, 12, 3), seed=seed), _images((n, 12, 12, 3), seed=seed + 1)
    rng = jax.random.PRNGKey(seed)
    w1, w2 = (np.asarray(a) for a in jaug.byol_device_augment(jnp.asarray(v1), jnp.asarray(v2), rng))
    draws = _jax_byol_draws(rng, n)
    assert draws["blur1"].all() and draws["blur2"].any() != draws["blur2"].all()
    g1, g2 = paug.byol_device_augment_core(torch.from_numpy(v1), torch.from_numpy(v2), draws)
    assert g1.dtype == g2.dtype == torch.float32
    np.testing.assert_allclose(g1.numpy(), w1, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(g2.numpy(), w2, rtol=F32_TOL, atol=F32_TOL)


def test_byol_device_augment_draws_from_the_generator():
    v = torch.from_numpy(_images((8, 10, 10, 3), seed=4))
    a = paug.byol_device_augment(v, v, torch.Generator().manual_seed(1))
    b = paug.byol_device_augment(v, v, torch.Generator().manual_seed(1))
    c = paug.byol_device_augment(v, v, torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    # the draws are the core's: the same generator state gives the same views
    draws = paug.byol_draws(8, torch.Generator().manual_seed(1), v.device)
    assert all(torch.equal(x, y) for x, y in zip(a, paug.byol_device_augment_core(v, v, draws)))
    # and the random_* ops draw in the same order: sigmas, then coins
    x = paug.to_float(v)
    gen = torch.Generator().manual_seed(1)
    blurred = paug.random_solarize(paug.random_gaussian_blur(x, gen, prob=1.0), gen, prob=0.0)
    torch.testing.assert_close(paug.normalize(blurred), a[0], rtol=0, atol=0)


def test_solarize_and_normalize_match_jax():
    import jax.numpy as jnp

    from passl_tpu.ops import augment as jaug

    x = np.random.RandomState(2).rand(2, 5, 5, 3).astype(np.float32)
    x[0, 0, 0] = 0.5  # the threshold itself flips (>=)
    np.testing.assert_array_equal(paug.solarize(torch.from_numpy(x), 0.5).numpy(),
                                  np.asarray(jaug.solarize(jnp.asarray(x), 0.5)))
    np.testing.assert_allclose(paug.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jaug.normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    u8 = _images((2, 4, 4, 3))
    np.testing.assert_array_equal(paug.to_float(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jaug.to_float(jnp.asarray(u8))))


# ------------------------------------------- the op's draws, on the CPU


def test_op_is_a_function_of_the_seed_per_image():
    same = torch.from_numpy(np.repeat(_images((1, 16, 16, 3), seed=8), 4, axis=0))
    kw = dict(blur_prob=1.0, solarize_prob=0.0, taps=9, sigma_range=(0.1, 3.0))
    out = fused_augment(same, 7, **kw)
    assert torch.equal(out, fused_augment(same, 7, **kw))  # bitwise repeatable
    o = out.float()
    assert not torch.allclose(o[0], o[1], atol=1e-3)  # identical images, other draws
    assert not torch.equal(out, fused_augment(same, 8, **kw))
    torch.testing.assert_close(out, fused_augment_ref(same, fused_augment_draws(4, 7, same.device),
                                                      **kw), rtol=0, atol=0)


def test_op_coin_rates():
    """4,096 images of 4 x 4: the blurred and solarized shares sit within 4
    sigma of their probabilities."""
    n = 4096
    one = torch.from_numpy(_images((1, 4, 4, 1), seed=9))
    kw = dict(taps=3, sigma_range=(1.0, 1.0), mean=(0.0,), std=(1.0,))
    # the image under each (blur, solarize) outcome: four different results
    outcomes = {(b, s): fused_augment_ref(one, torch.zeros(1, 3), blur_prob=float(b),
                                          solarize_prob=float(s), **kw)[0]
                for b in (0, 1) for s in (0, 1)}
    assert len({tuple(v.flatten().tolist()) for v in outcomes.values()}) == 4
    for blur_prob, sol_prob in ((0.1, 0.2), (0.5, 0.8)):
        out = fused_augment(one.expand(n, -1, -1, -1).contiguous(), 11, blur_prob=blur_prob,
                            solarize_prob=sol_prob, **kw)
        which = {k: (out == v).flatten(1).all(1) for k, v in outcomes.items()}
        assert int(sum(w.sum() for w in which.values())) == n  # every image is one outcome
        blurred = (which[(1, 0)] | which[(1, 1)]).float().mean().item()
        solarized = (which[(0, 1)] | which[(1, 1)]).float().mean().item()
        for share, p in ((blurred, blur_prob), (solarized, sol_prob)):
            assert abs(share - p) <= 4 * np.sqrt(p * (1 - p) / n), (share, p)


def test_with_draws_runs_the_plain_version_on_the_cpu():
    imgs = torch.from_numpy(_images((3, 8, 8, 3), seed=12))
    u = torch.rand(3, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fused_augment_with_draws(imgs, u, taps=5),
                       fused_augment_ref(imgs, u, taps=5))
    with pytest.raises(ValueError, match="one per channel"):
        fused_augment_with_draws(imgs, u, mean=(0.5,), std=(0.2,))


# ---------------------------------------------------------------- card only


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


# (shape, settings); `offset` (popped before the call) reads the images as a
# contiguous view that starts `offset` bytes into a uint8 buffer
CARD_CASES = [
    ((8, 224, 224, 3), dict(blur_prob=1.0, solarize_prob=0.0)),
    ((8, 224, 224, 3), dict(blur_prob=0.1, solarize_prob=0.2)),
    ((64, 32, 32, 3), dict(blur_prob=0.5, solarize_prob=0.5)),
    ((4, 160, 224, 3), dict(blur_prob=1.0, solarize_prob=1.0)),
    ((4, 16, 16, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=23, sigma_range=(2.0, 2.0))),
    ((4, 17, 33, 1), dict(blur_prob=1.0, solarize_prob=1.0, mean=MEAN1, std=STD1)),
    # the fast kernel's other radii: taps 1, 3 (W C = 36: 4-byte staging), 4 and 25
    ((4, 40, 36, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=1)),
    ((4, 37, 12, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=3)),
    ((4, 48, 40, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=4)),
    ((4, 50, 44, 3), dict(blur_prob=1.0, solarize_prob=1.0, taps=25)),
    # an image lower than the radius, W C = 39 odd (byte staging, 2-byte stores)
    ((4, 5, 13, 3), dict(blur_prob=1.0, solarize_prob=0.5, taps=23)),
    # a misaligned contiguous view: byte staging, byte streaming
    ((8, 33, 40, 3), dict(blur_prob=0.5, solarize_prob=0.5, offset=1)),
    # one channel at compiled radii (taps 23 and 9); two channels, which the generic kernel takes
    ((4, 40, 36, 1), dict(blur_prob=1.0, solarize_prob=0.5, taps=23, mean=MEAN1, std=STD1)),
    ((4, 30, 26, 1), dict(blur_prob=1.0, solarize_prob=0.5, taps=9, mean=MEAN1, std=STD1)),
    ((4, 24, 20, 2), dict(blur_prob=0.5, solarize_prob=0.5, mean=(0.5, 0.4), std=(0.2, 0.25))),
    # the widest row the generic kernel takes at 23 taps (W C = 7,224, one row a block)
    ((2, 8, 2408, 3), dict(blur_prob=1.0, solarize_prob=0.0, taps=23)),
]
FAST_RADII = {0, 1, 2, 4, 11, 12}  # taps // 2 of the fast kernel's compiled instances


def _card_images(shape, offset: int, device) -> torch.Tensor:
    imgs = torch.from_numpy(_images(shape, seed=40)).to(device)
    if offset:
        buf = torch.zeros(imgs.numel() + offset, dtype=torch.uint8, device=device)
        imgs = buf[offset:offset + imgs.numel()].view(shape).copy_(imgs)
        assert imgs.is_contiguous() and imgs.data_ptr() % 16 == offset % 16
    return imgs


@pytest.mark.cuda
@pytest.mark.parametrize("shape, kw", CARD_CASES)
def test_kernel_matches_plain_version(cuda, shape, kw):
    kw = dict(kw)
    imgs = _card_images(shape, kw.pop("offset", 0), cuda)
    _, h, w, c = shape
    taps = kw.get("taps", 23)
    fast = taps // 2 in FAST_RADII and c in (1, 3) and w * c < 4096
    assert fused_augment_kernel_for(h, w, c, taps) == ("fast" if fast else "generic")
    u = fused_augment_draws(shape[0], 3, cuda)
    before = fused_augment.launches
    got = fused_augment_with_draws(imgs, u, **kw)
    assert fused_augment.launches == before + 1
    want = fused_augment_ref(imgs, u, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == imgs.shape
    _assert_within_one_ulp(got.float().cpu().numpy(), want.float().cpu().numpy())
    assert torch.equal(got, fused_augment_with_draws(imgs, u, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64, 48, 3), (8, 5, 13, 3)])
def test_kernel_replays_from_a_cuda_graph(cuda, shape):
    """Captured in a CUDA graph after one eager call, the op replays to the
    eager result bitwise, and to the new result after its input changes in place."""
    kw = dict(blur_prob=0.5, solarize_prob=0.5)
    imgs = torch.from_numpy(_images(shape, seed=41)).to(cuda)
    u = fused_augment_draws(shape[0], 4, cuda)
    eager = fused_augment_with_draws(imgs, u, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_augment_with_draws(imgs, u, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_augment_with_draws(imgs, u, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    imgs.copy_(torch.from_numpy(_images(shape, seed=42)).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fused_augment_with_draws(imgs, u, **kw))
    assert not torch.equal(out, eager)
