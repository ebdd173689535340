"""Fused window attention of the PyTorch port (passl_tpu_torch/ops/window_attention.py).

On the CPU: the plain forward `window_attention_ref` against the JAX
package's `fused_window_attention` with its Pallas kernel in interpret mode,
and the autograd Function's backward (the plain `window_attention_bwd_ref`)
against `jax.grad` through the kernel's custom VJP, at the shapes of
tests/test_window_attention_kernel.py: no mask, a cycling mask (nWm = 8,
B = 16), one mask for every group (nWm = 1), Swin's packed L = 98, and bf16
inputs; and, in exact arithmetic, that the tensor-core kernels' softmax
division gives the IEEE quotient. Tests marked `cuda` hold both kernels
against the plain versions on the card (Swin's shapes, and every
fragment-layout edge of the bf16 / f16 tensor-core kernels: L in {49, 98,
128}, d in {32, 59, 64}, with and without a mask, in bf16, f16 and f32,
and runs of groups that do not divide B), check that dbias is bitwise the
same on every launch, and skip elsewhere; they import no JAX, so `python
-m pytest --noconftest -m cuda <this file>` runs them on a machine without
it.
"""
import numpy as np
import pytest
import torch

from passl_tpu_torch.ops.window_attention import (fused_window_attention,
                                                  fused_window_attention_bwd,
                                                  window_attention_bwd_ref,
                                                  window_attention_ref)

# plain versions vs the Pallas kernel in interpret mode, f32: the same f32
# formulas summed in another order (as tests/test_window_attention_kernel.py
# holds the kernel to the einsum chain: 2e-5 forward, 3e-5 gradients)
F32_TOL = 2e-5
GRAD_TOL = 3e-5
# bf16 inputs: both compute in f32 from the same bf16 values and round p and
# the output once each; one bf16 ulp is 2^-8 relative, so 2e-2 (about five
# ulps) covers a flipped rounding of p feeding the p v sum
BF16_TOL = 2e-2
# kernel vs plain version on the card, as chip_smoke.py's TOL: f32 sums in
# another order; bf16/f16, one rounding of the same f32 value (2^-8 and 2^-11
# relative, doubled)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
DBIAS_RTOL = 1e-4  # f32 sums over B groups in another order, of the largest entry


def _mk(b=8, h=4, l=49, d=32, n_mask=None, seed=0):
    """numpy q, k, v [b, h, l, d], bias [h, l, l] and mask [n_mask, l, l] or None."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, l, d).astype(np.float32) for _ in range(3))
    bias = (rs.randn(h, l, l) * 0.1).astype(np.float32)
    mask = None
    if n_mask:
        mask = np.where(rs.rand(n_mask, l, l) > 0.7, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _pack_mask(l=98):
    """The Swin win_pack=2 block-diagonal mask, one for every group."""
    pack = np.full((1, l, l), -100.0, np.float32)
    pack[:, :l // 2, :l // 2] = 0.0
    pack[:, l // 2:, l // 2:] = 0.0
    return pack


CASES = {  # name -> (q, k, v, bias, mask)
    "no_mask": _mk(),
    "cycling_mask": _mk(b=16, n_mask=8, seed=1),
    "one_mask": _mk(b=8, h=2, n_mask=1, seed=2),
    "packed_pair": _mk(b=4, h=4, l=98, seed=3)[:4] + (_pack_mask(),),
}


def _torch(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _jax_fused(q, k, v, bias, mask, dtype=None):
    import jax.numpy as jnp

    from passl_tpu.ops.pallas.window_attention import fused_window_attention as jax_fused

    dt = dtype or jnp.float32
    return jax_fused(jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
                     jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                     interpret=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_ref_matches_pallas_interpret(case):
    q, k, v, bias, mask = CASES[case]
    want = np.asarray(_jax_fused(q, k, v, bias, mask))
    tq, tk, tv, tb = _torch(q, k, v, bias)
    got = window_attention_ref(tq, tk, tv, tb, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_forward_ref_bf16_matches_pallas_interpret():
    import jax.numpy as jnp

    q, k, v, bias, _ = _mk(seed=5)
    want = _jax_fused(q, k, v, bias, None, dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    got = window_attention_ref(tq, tk, tv, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


def _jax_grads(q, k, v, bias, mask, dout, dtype=None):
    """dq, dk, dv, dbias of sum(out * dout) through the Pallas kernel's VJP."""
    import jax
    import jax.numpy as jnp

    from passl_tpu.ops.pallas.window_attention import fused_window_attention as jax_fused

    dt = dtype or jnp.float32
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, bias):
        o = jax_fused(q, k, v, bias, m, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(dout))

    args = (jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt), jnp.asarray(bias))
    return jax.grad(loss, argnums=(0, 1, 2, 3))(*args)


def _torch_grads(q, k, v, bias, mask, dout, dtype=torch.float32):
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v, dtype=dtype))
    tb = torch.from_numpy(bias).requires_grad_()
    out = fused_window_attention(tq, tk, tv, tb, None if mask is None else torch.from_numpy(mask))
    (out.float() * torch.from_numpy(dout)).sum().backward()
    return tq.grad, tk.grad, tv.grad, tb.grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_backward_matches_pallas_vjp(case):
    q, k, v, bias, mask = CASES[case]
    dout = np.random.RandomState(10).randn(*q.shape).astype(np.float32)
    want = _jax_grads(q, k, v, bias, mask, dout)
    got = _torch_grads(q, k, v, bias, mask, dout)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "dbias")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_function_backward_bf16_matches_pallas_vjp():
    import jax.numpy as jnp

    q, k, v, bias, mask = _mk(b=8, h=2, n_mask=4, seed=4)
    dout = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    dout = np.asarray(torch.from_numpy(dout).bfloat16().float())  # what both sides see
    want = _jax_grads(q, k, v, bias, mask, dout, dtype=jnp.bfloat16)
    got = _torch_grads(q, k, v, bias, mask, dout, dtype=torch.bfloat16)
    for g, w, name in zip(got[:3], want[:3], ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        # f32 sums from the same bf16 values, each rounded once to bf16; a
        # flipped rounding of pd or dsd moves a sum by one bf16 ulp of a term
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    # dbias: the f32 sum over groups of ds, from the same bf16 inputs
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want[3])).max())


@pytest.mark.parametrize("with_mask", [False, True])
def test_bwd_ref_matches_autograd_of_plain_forward(with_mask):
    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a).double()
                           for a in _mk(b=4, h=2, l=18, d=8, n_mask=2 if with_mask else None,
                                        seed=6))
    dout = torch.from_numpy(np.random.RandomState(12).randn(*q.shape))
    for t in (q, k, v, bias):
        t.requires_grad_()
    window_attention_ref(q, k, v, bias, mask).backward(dout)
    got = window_attention_bwd_ref(q.detach(), k.detach(), v.detach(), bias.detach(), mask, dout)
    for g, t, name in zip(got, (q, k, v, bias), ("dq", "dk", "dv", "dbias")):
        # the plain backward works in f32; autograd here in f64
        torch.testing.assert_close(g.double(), t.grad, rtol=1e-5, atol=1e-5, msg=name)


def test_function_cpu_path_runs_the_plain_versions():
    q, k, v, bias, mask = _torch(*_mk(b=4, h=2, n_mask=2, seed=7))
    dout = torch.from_numpy(np.random.RandomState(13).randn(*q.shape).astype(np.float32))
    for t in (q, k, v, bias):
        t.requires_grad_()
    fwd, bwd = fused_window_attention.launches, fused_window_attention_bwd.launches
    out = fused_window_attention(q, k, v, bias, mask)
    assert torch.equal(out.detach(), window_attention_ref(q.detach(), k.detach(), v.detach(),
                                                          bias.detach(), mask))
    saved = out.grad_fn.saved_tensors  # the inputs only, as the custom VJP keeps
    assert len(saved) == 5 and torch.equal(saved[4], mask)
    out.backward(dout)
    assert (fused_window_attention.launches, fused_window_attention_bwd.launches) == (fwd, bwd)
    want = window_attention_bwd_ref(q.detach(), k.detach(), v.detach(), bias.detach(), mask, dout)
    for t, w in zip((q, k, v, bias), want):
        assert torch.equal(t.grad, w)


def _rn32(x) -> np.float32:
    """An exact rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))  # within one f32 ulp; pick the nearest exactly
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, dd in zip(cands, dist) if dd == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_softmax_division_is_correctly_rounded():
    """The tensor-core kernels' softmax divides e by the row sum as
    `div_normal` (csrc/window_attention.cuh): q = x rd, r = fma(-q, d, x),
    fma(r, rd, q) with rd = 1 / d correctly rounded. For x in [2^-60, 1]
    (smaller exps are taken as 0) and d in [1, 128] that is the IEEE
    quotient, which this holds in exact arithmetic."""
    from fractions import Fraction

    rs = np.random.RandomState(40)
    xs = [np.float32(2.0 ** e) for e in rs.uniform(-60, 0, 3000)] + [np.float32(2.0 ** -60),
                                                                     np.float32(1.0)]
    ds = [np.float32(d) for d in rs.uniform(1, 128, 3000)] + [np.float32(1.0), np.float32(128.0)]
    ds += [np.float32(d) for d in range(1, 129)]
    rs.shuffle(ds)
    for x, d in zip(xs * 2, ds):
        rd = np.float32(1.0) / d
        q = _rn32(Fraction(float(x)) * Fraction(float(rd)))
        r = _rn32(Fraction(float(x)) - Fraction(float(q)) * Fraction(float(d)))
        got = _rn32(Fraction(float(r)) * Fraction(float(rd)) + Fraction(float(q)))
        assert got == x / d, (x, d)


def test_mask_rule_is_b_mod_nwm():
    """Group b takes mask b % nWm (groups laid out [images, nWm] row-major)."""
    q, k, v, bias, mask = _torch(*_mk(b=6, h=2, l=9, d=4, n_mask=3, seed=8))
    out = window_attention_ref(q, k, v, bias, mask)
    for b in range(6):
        one = window_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], bias, mask[b % 3:b % 3 + 1])
        torch.testing.assert_close(out[b:b + 1], one, rtol=0, atol=0)
    with pytest.raises(ValueError, match="must divide"):
        window_attention_ref(q[:4], k[:4], v[:4], bias, mask)


# ---------------------------------------------------------------- card only


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _on(device, dtype, q, k, v, bias, mask):
    return ([torch.from_numpy(a).to(device, dtype) for a in (q, k, v)]
            + [torch.from_numpy(bias).to(device),
               None if mask is None else torch.from_numpy(mask).to(device)])


# (b, h, l, d, n_mask): Swin-T's stage shapes (2 images), no mask, one mask,
# d = 59 (swin_huge) and 64 (swin_giant), and the short edge cases; then the
# tensor-core kernels' fragment-layout edges: L pads to 64, 112 and 128
# query rows (4, 7 and 8 row blocks; the last of L = 49 and 98 holds 1 and
# 2 real rows), d = 32 and 64 fill whole 16-deep steps, d = 59 pads to 64
# and is staged element by element (rows of 118 bytes); with and without a
# mask
CARD_SHAPES = [(64, 3, 98, 32, 32), (16, 6, 98, 32, 8), (4, 12, 98, 32, 2), (2, 24, 49, 32, None),
               (8, 4, 98, 32, 1), (4, 6, 98, 59, 2), (2, 8, 49, 64, None), (3, 2, 17, 8, 3),
               (2, 2, 128, 64, 1)] + [(8, 2, l, d, n_mask) for l in (49, 98, 128)
                                      for d in (32, 59, 64) for n_mask in (None, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fwd_kernel_matches_plain_version(cuda, shape, dtype):
    b, h, l, d, n_mask = shape
    q, k, v, bias, mask = _on(cuda, dtype, *_mk(b, h, l, d, n_mask, seed=20))
    before = fused_window_attention.launches
    with torch.no_grad():
        out = fused_window_attention(q, k, v, bias, mask)
    assert fused_window_attention.launches == before + 1
    ref = window_attention_ref(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bwd_kernel_matches_plain_version(cuda, shape, dtype):
    b, h, l, d, n_mask = shape
    q, k, v, bias, mask = _on(cuda, dtype, *_mk(b, h, l, d, n_mask, seed=21))
    dout = torch.from_numpy(np.random.RandomState(22).randn(b, h, l, d)).to(cuda, dtype)
    before = fused_window_attention_bwd.launches
    got = fused_window_attention_bwd(q, k, v, bias, mask, dout)
    assert fused_window_attention_bwd.launches == before + 1
    want = window_attention_bwd_ref(q, k, v, bias, mask, dout)
    torch.cuda.synchronize()
    for g, w, name in zip(got[:3], want[:3], ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=name)
    assert got[3].dtype == torch.float32 and got[3].shape == (h, l, l)
    err = ((got[3] - want[3]).abs().max() / want[3].abs().max()).item()
    assert err <= DBIAS_RTOL, err
    again = fused_window_attention_bwd(q, k, v, bias, mask, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernels_on_runs_that_do_not_divide_the_groups(cuda, dtype):
    """B = 1000 groups of 3 heads: the backward's runs of 6 groups leave 4 for
    the last block of each head, and a run crosses from one of the 8 masks to
    the next (the groups go mask by mask)."""
    q, k, v, bias, mask = _on(cuda, dtype, *_mk(1000, 3, 98, 32, 8, seed=33))
    dout = torch.from_numpy(np.random.RandomState(34).randn(*q.shape)).to(cuda, dtype)
    with torch.no_grad():
        out = fused_window_attention(q, k, v, bias, mask)
    torch.testing.assert_close(out.float(), window_attention_ref(q, k, v, bias, mask).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    got = fused_window_attention_bwd(q, k, v, bias, mask, dout)
    want = window_attention_bwd_ref(q, k, v, bias, mask, dout)
    torch.cuda.synchronize()
    for g, w, name in zip(got[:3], want[:3], ("dq", "dk", "dv")):
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=name)
    assert ((got[3] - want[3]).abs().max() / want[3].abs().max()).item() <= DBIAS_RTOL
    again = fused_window_attention_bwd(q, k, v, bias, mask, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bwd_kernel_dbias_is_bitwise_repeatable(cuda, dtype):
    q, k, v, bias, mask = _on(cuda, dtype, *_mk(512, 3, 98, 32, 32, seed=23))
    dout = torch.from_numpy(np.random.RandomState(24).randn(*q.shape)).to(cuda, dtype)
    first = fused_window_attention_bwd(q, k, v, bias, mask, dout)
    for _ in range(3):
        again = fused_window_attention_bwd(q, k, v, bias, mask, dout)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_on_cuda_goes_through_both_kernels(cuda):
    q, k, v, bias, mask = _on(cuda, torch.bfloat16, *_mk(8, 4, 98, 32, 4, seed=25))
    dout = torch.from_numpy(np.random.RandomState(26).randn(*q.shape)).to(cuda, torch.bfloat16)
    for t in (q, k, v, bias):
        t.requires_grad_()
    fwd, bwd = fused_window_attention.launches, fused_window_attention_bwd.launches
    fused_window_attention(q, k, v, bias, mask).backward(dout)
    assert fused_window_attention.launches == fwd + 1
    assert fused_window_attention_bwd.launches == bwd + 1
    want = window_attention_bwd_ref(q.detach(), k.detach(), v.detach(), bias.detach(), mask, dout)
    for t, w in zip((q, k, v), want[:3]):
        torch.testing.assert_close(t.grad.float(), w.float(), rtol=2e-2, atol=2e-2)
    assert bias.grad.dtype == torch.float32
    assert ((bias.grad - want[3]).abs().max() / want[3].abs().max()).item() <= DBIAS_RTOL


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, bias, mask = _on(cuda, torch.float32, *_mk(4, 2, 16, 8, 2, seed=0))
    with pytest.raises(ValueError, match="L <= 128"):
        big = _on(cuda, torch.float32, *_mk(1, 1, 129, 8, None, seed=0))
        fused_window_attention(*big)
    with pytest.raises(ValueError, match="d <= 64"):
        wide = _on(cuda, torch.float32, *_mk(1, 1, 16, 65, None, seed=0))
        fused_window_attention(*wide)
    with pytest.raises(ValueError, match="contiguous"):
        fused_window_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, bias, mask)
    with pytest.raises(ValueError, match="must divide"):
        fused_window_attention(q[:3], k[:3], v[:3], bias, mask)
    with pytest.raises(ValueError, match="do must match"):
        fused_window_attention_bwd(q, k, v, bias, mask, q.bfloat16())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_window_attention_bwd(*(None if t is None else t.cpu() for t in (q, k, v, bias, mask)),
                                   q.cpu())
