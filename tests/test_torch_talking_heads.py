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
from passl_tpu_torch.ops.talking_heads import talking_heads_softmax, talking_heads_softmax_ref

# f32: the same f32 terms summed in another order. bf16: both round one f32
# value to bf16, so they differ by at most one bf16 ulp (2^-8 relative), as in
# tests/test_talking_heads_kernel.py. f16: one f16 ulp (2^-11), doubled.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


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
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


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
