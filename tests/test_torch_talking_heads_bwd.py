"""Talking-heads softmax backward of the PyTorch port (passl_tpu_torch/ops/talking_heads.py).

On the CPU: the plain backward `talking_heads_softmax_bwd_ref` against the
JAX package's custom VJP with its Pallas backward kernel in interpret mode
(run as tests/test_talking_heads_kernel.py runs it: a 16-row q tile, so q=49
is padded), in f32 and bf16, and against torch autograd of the plain
forward; and the autograd Function's CPU path. Tests marked `cuda` hold the
backward's two kernels (the warp-row kernel for bf16 / f16 with h <= 8 and
k <= 256, the block-row kernel otherwise, chosen in the C entry point)
against the plain backward on the card, at the warp-row kernel's edges and
either side of the boundary, check that their weight gradients are bitwise
the same on every launch, and skip elsewhere;
they import no JAX, so `python -m pytest --noconftest -m cuda <this file>`
runs them on a machine without it.
"""
import numpy as np
import pytest
import torch

from passl_tpu_torch.ops.talking_heads import (talking_heads_bwd_kernel_for,
                                               talking_heads_softmax,
                                               talking_heads_softmax_bwd,
                                               talking_heads_softmax_bwd_ref,
                                               talking_heads_softmax_ref)

# ds: f32, the same f32 terms in another order; bf16/f16, one rounding of
# the same f32 value to the stored type (one ulp: 2^-8 and 2^-11 relative,
# doubled), as the forward's tolerances. dproj: f32 sums of n*q*k products in
# another order, relative to the largest entry.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
WGRAD_RTOL = 1e-4


def _inputs(n, h, q, k, seed):
    rng = np.random.RandomState(seed)
    s = (rng.randn(n, h, q, k) * 3.0).astype(np.float32)
    dp = rng.randn(n, h, q, k).astype(np.float32)
    wl = (rng.randn(h, h) * 0.2 + np.eye(h)).astype(np.float32)
    ww = (rng.randn(h, h) * 0.2 + np.eye(h)).astype(np.float32)
    return s, dp, wl, ww


def _assert_wgrad_close(got, want, rtol=WGRAD_RTOL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=name)


@pytest.fixture()
def pallas_vjp(monkeypatch):
    """The JAX kernel's VJP in interpret mode with a 16-row q tile (49 pads q)."""
    import functools

    import jax

    import passl_tpu.ops.pallas.talking_heads as jax_th

    monkeypatch.setattr(jax_th, "_pick_q_tile", lambda h, q, k: 16)
    fused = functools.partial(jax_th.talking_heads_softmax, interpret=True)

    def vjp(s, dp, wl, ww):
        _, pull = jax.vjp(fused, s, wl, ww)
        return pull(dp)

    return vjp


@pytest.mark.parametrize("q", [16, 49])
def test_bwd_ref_matches_pallas_vjp_f32(q, pallas_vjp):
    import jax.numpy as jnp

    s, dp, wl, ww = _inputs(2, 4, q, q, seed=q)
    want = pallas_vjp(*(jnp.asarray(a) for a in (s, dp, wl, ww)))
    got = talking_heads_softmax_bwd_ref(*(torch.from_numpy(a) for a in (s, dp, wl, ww)))
    assert [g.dtype for g in got] == [torch.float32] * 3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for g, w, name in zip(got[1:], want[1:], ("dproj_l", "dproj_w")):
        _assert_wgrad_close(g.numpy(), w, name=name)


@pytest.mark.parametrize("q", [16, 49])
def test_bwd_ref_matches_pallas_vjp_bf16(q, pallas_vjp):
    import jax.numpy as jnp

    s, dp, wl, ww = _inputs(2, 4, q, q, seed=200 + q)
    want = pallas_vjp(jnp.asarray(s, jnp.bfloat16), jnp.asarray(dp, jnp.bfloat16),
                      jnp.asarray(wl), jnp.asarray(ww))
    assert want[0].dtype == jnp.bfloat16
    got = talking_heads_softmax_bwd_ref(torch.from_numpy(s).bfloat16(),
                                        torch.from_numpy(dp).bfloat16(),
                                        torch.from_numpy(wl), torch.from_numpy(ww))
    assert got[0].dtype == torch.bfloat16
    # both compute in f32 from the same bf16 inputs and round ds once
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    for g, w, name in zip(got[1:], want[1:], ("dproj_l", "dproj_w")):
        _assert_wgrad_close(g.numpy(), w, name=name)


@pytest.mark.parametrize("shape", [(2, 4, 16, 16), (1, 6, 9, 33), (1, 16, 3, 40)])
def test_bwd_ref_matches_autograd_of_plain_forward(shape):
    s, dp, wl, ww = (torch.from_numpy(a).double() for a in _inputs(*shape, seed=1))
    s.requires_grad_()
    wl.requires_grad_()
    ww.requires_grad_()
    talking_heads_softmax_ref(s, wl, ww).backward(dp)
    ds, dwl, dww = talking_heads_softmax_bwd_ref(s.detach(), dp, wl.detach(), ww.detach())
    # the plain backward works in f32; autograd here in f64
    torch.testing.assert_close(ds.double(), s.grad, rtol=1e-5, atol=1e-5)
    _assert_wgrad_close(dwl.numpy(), wl.grad.numpy(), rtol=1e-5, name="dproj_l")
    _assert_wgrad_close(dww.numpy(), ww.grad.numpy(), rtol=1e-5, name="dproj_w")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_cpu_path_runs_the_plain_versions(dtype):
    s, dp, wl, ww = (torch.from_numpy(a) for a in _inputs(2, 4, 8, 8, seed=5))
    s = s.to(dtype).requires_grad_()
    wl.requires_grad_()
    ww.requires_grad_()
    fwd, bwd = talking_heads_softmax.launches, talking_heads_softmax_bwd.launches
    out = talking_heads_softmax(s, wl, ww)
    assert out.dtype == dtype and out.grad_fn is not None
    assert torch.equal(out.detach(), talking_heads_softmax_ref(s.detach(), wl, ww))
    out.backward(dp.to(dtype))
    assert (talking_heads_softmax.launches, talking_heads_softmax_bwd.launches) == (fwd, bwd)
    ds, dwl, dww = talking_heads_softmax_bwd_ref(s.detach(), dp.to(dtype), wl.detach(), ww.detach())
    assert s.grad.dtype == dtype and wl.grad.dtype == ww.grad.dtype == torch.float32
    assert torch.equal(s.grad, ds) and torch.equal(wl.grad, dwl) and torch.equal(ww.grad, dww)


def test_function_grads_only_what_needs_them():
    s, dp, wl, ww = (torch.from_numpy(a) for a in _inputs(2, 4, 8, 8, seed=6))
    wl.requires_grad_()  # s and proj_w are constants
    talking_heads_softmax(s, wl, ww).backward(dp)
    assert s.grad is None and ww.grad is None
    assert torch.equal(wl.grad, talking_heads_softmax_bwd_ref(s, dp, wl.detach(), ww)[1])
    # only the scores
    s2 = s.clone().requires_grad_()
    talking_heads_softmax(s2, wl.detach(), ww).sum().backward()
    assert s2.grad.shape == s.shape and wl.grad is not None


def test_function_saves_only_the_inputs():
    s, _, wl, ww = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 4, seed=7))
    s.requires_grad_()
    out = talking_heads_softmax(s, wl, ww)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and torch.equal(saved[0], s.detach())
    assert [t.shape for t in saved] == [s.shape, wl.shape, ww.shape]


# ---------------------------------------------------------------- card only


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _on(device, dtype, *arrays):
    s, dp, wl, ww = arrays
    return (torch.from_numpy(s).to(device, dtype), torch.from_numpy(dp).to(device, dtype),
            torch.from_numpy(wl).to(device), torch.from_numpy(ww).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 49, 49), (2, 8, 196, 196), (1, 6, 576, 576),
                                   (1, 16, 784, 784), (3, 4, 1, 17), (2, 16, 5, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bwd_kernel_matches_plain_version(cuda, shape, dtype):
    s, dp, wl, ww = _on(cuda, dtype, *_inputs(*shape, seed=11))
    before = talking_heads_softmax_bwd.launches
    ds, dwl, dww = talking_heads_softmax_bwd(s, dp, wl, ww)
    assert talking_heads_softmax_bwd.launches == before + 1
    ref = talking_heads_softmax_bwd_ref(s, dp, wl, ww)
    torch.cuda.synchronize()
    assert ds.dtype == dtype and ds.shape == s.shape
    assert dwl.dtype == dww.dtype == torch.float32
    torch.testing.assert_close(ds.float(), ref[0].float(), rtol=TOL[dtype], atol=TOL[dtype])
    _assert_wgrad_close(dwl.cpu().numpy(), ref[1].cpu().numpy(), name="dproj_l")
    _assert_wgrad_close(dww.cpu().numpy(), ref[2].cpu().numpy(), name="dproj_w")


def _check_against_plain(device, shape, dtype, seed):
    s, dp, wl, ww = _on(device, dtype, *_inputs(*shape, seed=seed))
    ds, dwl, dww = talking_heads_softmax_bwd(s, dp, wl, ww)
    ref = talking_heads_softmax_bwd_ref(s, dp, wl, ww)
    torch.cuda.synchronize()
    assert ds.dtype == dtype and ds.shape == s.shape
    torch.testing.assert_close(ds.float(), ref[0].float(), rtol=TOL[dtype], atol=TOL[dtype])
    _assert_wgrad_close(dwl.cpu().numpy(), ref[1].cpu().numpy(), name="dproj_l")
    _assert_wgrad_close(dww.cpu().numpy(), ref[2].cpu().numpy(), name="dproj_w")


# the warp-row kernel's edges: k not a multiple of 32 or 16 (49, 196, 33) and
# each columns-a-lane count (1, 2, 4, 7, 8); fewer rows than a block's 4 warps
# (3, 1); rows that leave the last block's warps part empty (2 x 7 = 14); more
# rows than the grid's 1,584 warps, so that some warps take one row more than
# others (4 x 401 = 1,604; 64 x 196 = 12,544); h = 4, 6, 8
ROW_EDGES = [(2, 8, 49, 49), (64, 8, 196, 196), (3, 8, 11, 33), (1, 8, 3, 196), (1, 4, 1, 17),
             (2, 6, 7, 96), (4, 4, 401, 64), (2, 8, 5, 224), (2, 6, 9, 256), (3, 4, 5, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROW_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_warp_row_kernel_edges_match_plain_version(cuda, shape, dtype):
    assert talking_heads_bwd_kernel_for(shape[1], shape[3], dtype) == "warp-row"
    _check_against_plain(cuda, shape, dtype, seed=sum(shape))


# either side of the boundary: k = 256 | 257, h = 8 | 16, bf16 | f32
BOUNDARY = [((2, 8, 6, 256), torch.bfloat16, "warp-row"), ((2, 8, 6, 257), torch.bfloat16, "block-row"),
            ((2, 8, 6, 256), torch.float16, "warp-row"), ((2, 8, 6, 257), torch.float16, "block-row"),
            ((2, 16, 9, 196), torch.bfloat16, "block-row"), ((2, 8, 9, 196), torch.float32, "block-row"),
            ((1, 16, 5, 49), torch.float16, "block-row"), ((1, 4, 5, 300), torch.bfloat16, "block-row")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, kernel", BOUNDARY)
def test_dispatch_boundary_both_kernels_match_plain_version(cuda, shape, dtype, kernel):
    assert talking_heads_bwd_kernel_for(shape[1], shape[3], dtype) == kernel
    _check_against_plain(cuda, shape, dtype, seed=7 + shape[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_weight_grads_are_bitwise_repeatable(cuda, dtype):
    s, dp, wl, ww = _on(cuda, dtype, *_inputs(64, 8, 196, 196, seed=12))
    first = talking_heads_softmax_bwd(s, dp, wl, ww)
    for _ in range(3):
        again = talking_heads_softmax_bwd(s, dp, wl, ww)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [((64, 8, 196, 196), torch.float16),
                                          ((4, 16, 196, 196), torch.bfloat16),
                                          ((4, 4, 401, 64), torch.bfloat16)])
def test_both_kernels_are_bitwise_repeatable(cuda, shape, dtype):
    """h = 8 on the warp-row kernel, h = 16 on the block-row kernel, and a
    warp-row grid whose warps take unequal row counts."""
    s, dp, wl, ww = _on(cuda, dtype, *_inputs(*shape, seed=14))
    first = talking_heads_softmax_bwd(s, dp, wl, ww)
    again = talking_heads_softmax_bwd(s, dp, wl, ww)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_on_cuda_goes_through_both_kernels(cuda):
    s, dp, wl, ww = _on(cuda, torch.bfloat16, *_inputs(2, 8, 49, 49, seed=13))
    s.requires_grad_()
    wl.requires_grad_()
    ww.requires_grad_()
    fwd, bwd = talking_heads_softmax.launches, talking_heads_softmax_bwd.launches
    talking_heads_softmax(s, wl, ww).backward(dp)
    assert talking_heads_softmax.launches == fwd + 1
    assert talking_heads_softmax_bwd.launches == bwd + 1
    ds, dwl, dww = talking_heads_softmax_bwd_ref(s.detach(), dp, wl.detach(), ww.detach())
    torch.testing.assert_close(s.grad.float(), ds.float(), rtol=2e-2, atol=2e-2)
    _assert_wgrad_close(wl.grad.cpu().numpy(), dwl.cpu().numpy(), name="dproj_l")
    _assert_wgrad_close(ww.grad.cpu().numpy(), dww.cpu().numpy(), name="dproj_w")


@pytest.mark.cuda
def test_bwd_kernel_refuses_what_it_does_not_take(cuda):
    s, dp, wl, ww = _on(cuda, torch.float32, *_inputs(2, 4, 16, 16, seed=0))
    with pytest.raises(ValueError, match="dp must match"):
        talking_heads_softmax_bwd(s, dp.bfloat16(), wl, ww)
    with pytest.raises(ValueError, match="dp must be contiguous"):
        talking_heads_softmax_bwd(s, dp.transpose(2, 3), wl, ww)
    with pytest.raises(ValueError, match="h=5"):
        s5, dp5, w5, _ = _on(cuda, torch.float32, *_inputs(1, 5, 8, 8, seed=0))
        talking_heads_softmax_bwd(s5, dp5, w5, w5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        talking_heads_softmax_bwd(s.cpu(), dp.cpu(), wl.cpu(), ww.cpu())
