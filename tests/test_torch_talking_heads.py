"""Talking-heads softmax of the PyTorch port (passl_tpu_torch/ops/talking_heads.py).

On the CPU: the plain version against the JAX package's Pallas kernel in
interpret mode (run as tests/test_talking_heads_kernel.py runs it), the
wrapper's CPU path, and the th_impl resolver. Tests marked `cuda` hold the
CUDA kernel against the plain version on the card and skip elsewhere; they
import no JAX, so `python -m pytest --noconftest -m cuda <this file>` runs
them on a machine without it.
"""
import numpy as np
import pytest
import torch

from passl_tpu_torch.models.cait import resolve_th_impl
from passl_tpu_torch.ops.talking_heads import (talking_heads_fwd_kernel_for,
                                               talking_heads_fwd_resources, talking_heads_softmax,
                                               talking_heads_softmax_ref)

# The card's kernel against the plain version, (atol, rtol). f32: the same
# f32 terms summed in another order. bf16 / f16: both round one f32 value
# once, so they differ by at most one ulp of the stored type: 2^-7 of the
# value in bf16, 2^-10 in f16. The two f32 values before that rounding
# (__expf against expf, sums in another order) differ by under 1e-5; atol
# leaves ten times room, and stays under a probability's 1/k at every k here.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 2**-7),
       torch.float16: (1e-4, 2**-10)}


def _inputs(n, h, q, k, seed):
    rng = np.random.RandomState(seed)
    s = (rng.randn(n, h, q, k) * 3.0).astype(np.float32)
    wl = (rng.randn(h, h) * 0.2 + np.eye(h)).astype(np.float32)
    ww = (rng.randn(h, h) * 0.2 + np.eye(h)).astype(np.float32)
    return s, wl, ww


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """The JAX kernel in interpret mode with a 16-row q tile (49 pads q)."""
    import functools

    import passl_tpu.ops.pallas.talking_heads as jax_th

    monkeypatch.setattr(jax_th, "_pick_q_tile", lambda h, q, k: 16)
    return functools.partial(jax_th.talking_heads_softmax, interpret=True)


@pytest.mark.parametrize("q", [16, 49])
def test_ref_matches_pallas_kernel_f32(q, pallas_interpret):
    import jax.numpy as jnp

    s, wl, ww = _inputs(2, 4, q, q, seed=q)
    want = np.asarray(pallas_interpret(jnp.asarray(s), jnp.asarray(wl), jnp.asarray(ww)))
    got = talking_heads_softmax_ref(torch.from_numpy(s), torch.from_numpy(wl), torch.from_numpy(ww))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [16, 49])
def test_ref_matches_pallas_kernel_bf16(q, pallas_interpret):
    import jax.numpy as jnp

    s, wl, ww = _inputs(2, 4, q, q, seed=100 + q)
    want = pallas_interpret(jnp.asarray(s, jnp.bfloat16), jnp.asarray(wl), jnp.asarray(ww))
    assert want.dtype == jnp.bfloat16
    got = talking_heads_softmax_ref(torch.from_numpy(s).bfloat16(), torch.from_numpy(wl),
                                    torch.from_numpy(ww))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_ref_rows_are_mixed_probabilities():
    # with identity mixes the chain is a plain softmax over k
    s, _, _ = _inputs(2, 4, 8, 8, seed=0)
    eye = torch.eye(4)
    out = talking_heads_softmax_ref(torch.from_numpy(s), eye, eye)
    torch.testing.assert_close(out, torch.softmax(torch.from_numpy(s), dim=-1), rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    s, wl, ww = (torch.from_numpy(a) for a in _inputs(2, 4, 16, 16, seed=3))
    before = talking_heads_softmax.launches
    out = talking_heads_softmax(s, wl, ww)
    assert talking_heads_softmax.launches == before
    assert torch.equal(out, talking_heads_softmax_ref(s, wl, ww))


def test_resolver():
    assert resolve_th_impl("auto", "cpu") == "einsum"
    assert resolve_th_impl("auto", torch.device("cuda", 0)) == "fused"
    assert resolve_th_impl("einsum", "cpu") == "einsum"
    assert resolve_th_impl("einsum", "cuda") == "einsum"
    assert resolve_th_impl("fused", "cuda") == "fused"
    # an explicit kernel request on a CPU tensor raises; it does not fall back
    with pytest.raises(ValueError, match="fused needs CUDA"):
        resolve_th_impl("fused", "cpu")
    with pytest.raises(ValueError, match="unknown th_impl"):
        resolve_th_impl("nope", "cpu")


# ---------------------------------------------------------------- card only


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _on(device, dtype, *arrays):
    s, wl, ww = arrays
    return (torch.from_numpy(s).to(device, dtype), torch.from_numpy(wl).to(device),
            torch.from_numpy(ww).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 49, 49), (2, 8, 196, 196), (1, 6, 576, 576),
                                   (1, 16, 784, 784), (3, 4, 1, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    s, wl, ww = _on(cuda, dtype, *_inputs(*shape, seed=7))
    with torch.inference_mode():
        before = talking_heads_softmax.launches
        out = talking_heads_softmax(s, wl, ww)
        assert talking_heads_softmax.launches == before + 1
        ref = talking_heads_softmax_ref(s, wl, ww)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == s.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    s, wl, ww = _on(cuda, torch.float32, *_inputs(2, 4, 16, 16, seed=0))
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            talking_heads_softmax(s.transpose(2, 3), wl, ww)
        s5, w5, _ = _on(cuda, torch.float32, *_inputs(1, 5, 8, 8, seed=0))
        with pytest.raises(ValueError, match="h=5"):
            talking_heads_softmax(s5, w5, w5)
        with pytest.raises(TypeError, match="scores must be"):
            talking_heads_softmax(s.double(), wl, ww)
        with pytest.raises(ValueError, match="exceeds"):
            talking_heads_softmax(torch.zeros(1, 4, 1, 1025, device=cuda), wl, ww)


def _check_against_plain(s, wl, ww):
    """The kernel within TOL of the plain version, and bitwise the same on a second launch."""
    with torch.inference_mode():
        before = talking_heads_softmax.launches
        out = talking_heads_softmax(s, wl, ww)
        again = talking_heads_softmax(s, wl, ww)
        assert talking_heads_softmax.launches == before + 2
        ref = talking_heads_softmax_ref(s, wl, ww)
    torch.cuda.synchronize()
    assert out.dtype == s.dtype and out.shape == s.shape
    atol, rtol = TOL[s.dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    assert torch.equal(out, again)
    return out


# the warp-row kernel's columns: one group of four a lane (k <= 128) or two; k % 4 != 0
# takes 2-byte accesses; one column; a warp's width and either side of it; CaiT's 196
ROW_K = [1, 4, 31, 32, 33, 49, 127, 128, 129, 196, 252, 255, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("k", ROW_K)
@pytest.mark.parametrize("h", [4, 6, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_warp_row_kernel_every_k_matches_plain_version(cuda, k, h, dtype):
    assert talking_heads_fwd_kernel_for(h, k, dtype) == "warp-row"
    _check_against_plain(*_on(cuda, dtype, *_inputs(2, h, 3, k, seed=k + h)))


# rows (n q) against the grid of 2,112 warps in blocks of 4: one row; fewer rows
# than a block's warps; a last block part empty (14); more rows than one pass of
# the grid and not a multiple of it (2,404; 3,000; CaiT-S24's 12,544)
ROW_COUNTS = [(1, 8, 1, 196), (1, 8, 3, 196), (2, 8, 7, 196), (4, 4, 601, 64), (3, 6, 1000, 128),
              (64, 8, 196, 196)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROW_COUNTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_warp_row_kernel_row_counts_match_plain_version(cuda, shape, dtype):
    assert talking_heads_fwd_kernel_for(shape[1], shape[3], dtype) == "warp-row"
    _check_against_plain(*_on(cuda, dtype, *_inputs(*shape, seed=sum(shape))))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 5, 196), (2, 4, 3, 33)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_warp_row_kernel_scores_of_1e4_underflow_to_zero(cuda, shape, dtype):
    """Scores of about +-1e4 (a spread of 1e4, within f16's range): each mixed
    row's largest logit stands at least 30 above the next, so all but the
    largest exp of a row underflow, and no near tie leaves the result to the
    f32 rounding of 1e4-sized logits."""
    s, wl, ww = _inputs(*shape, seed=5)
    out = _check_against_plain(*_on(cuda, dtype, s / 3.0 * 1e4, wl, ww))
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_warp_row_kernel_unaligned_rows_take_scalar_accesses(cuda, dtype):
    """Scores that start 2 bytes past an 8-byte boundary (a contiguous view at
    an odd offset) take the 2-byte path, which gives the same bits."""
    s, wl, ww = _on(cuda, dtype, *_inputs(2, 8, 5, 196, seed=9))
    shifted = torch.empty(s.numel() + 1, dtype=dtype, device=cuda)[1:].view(s.shape)
    shifted.copy_(s)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 2
    assert torch.equal(_check_against_plain(shifted, wl, ww), _check_against_plain(s, wl, ww))


# either side of the boundary: k = 256 | 257, h = 8 | 16, bf16 | f32
FWD_BOUNDARY = [((2, 8, 6, 256), torch.bfloat16, "warp-row"), ((2, 8, 6, 257), torch.bfloat16, "block-row"),
                ((2, 8, 6, 256), torch.float16, "warp-row"), ((2, 8, 6, 257), torch.float16, "block-row"),
                ((2, 16, 9, 196), torch.bfloat16, "block-row"), ((2, 8, 9, 196), torch.float32, "block-row"),
                ((1, 16, 5, 49), torch.float16, "block-row"), ((1, 4, 5, 300), torch.bfloat16, "block-row")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, kernel", FWD_BOUNDARY)
def test_fwd_dispatch_boundary_both_kernels_match_plain_version(cuda, shape, dtype, kernel):
    assert talking_heads_fwd_kernel_for(shape[1], shape[3], dtype) == kernel
    _check_against_plain(*_on(cuda, dtype, *_inputs(*shape, seed=3 + shape[3])))


@pytest.mark.cuda
def test_warp_row_kernel_resources(cuda):
    """Within the launch bound of 128 registers; enough warps an SM to keep 7
    rows in flight; the weights its only shared memory. A shape the kernel
    does not take raises."""
    for dtype in (torch.bfloat16, torch.float16):
        for h in (4, 6, 8):
            for k in (49, 196, 256):
                r = talking_heads_fwd_resources(dtype, h, k)
                assert set(r) == {"registers", "shared_bytes", "blocks_per_sm", "spill_bytes",
                                  "warps"}
                assert 0 < r["registers"] <= 128, r
                assert r["blocks_per_sm"] * r["warps"] >= 7, r
                assert r["shared_bytes"] == 2 * h * h * 4, r
    with pytest.raises(RuntimeError, match="talking_heads_fwd_resources"):
        talking_heads_fwd_resources(torch.float32, 8, 196)
