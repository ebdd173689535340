"""Flash attention of the PyTorch port (passl_tpu_torch/ops/attention.py).

On the CPU: the plain forward `flash_attention_fwd_ref` against the JAX
package's `flash_attention` (the JAX library's Pallas kernels, run under
`pltpu.force_tpu_interpret_mode()`), and the autograd Function's backward
(the plain `flash_attention_bwd_ref`) against `jax.grad` through the
library's custom VJP, at l in {65, 197} and d in {32, 64}, in f32 and bf16;
the einsum path against the JAX einsum path; the resolver's rules against
the JAX package's (with its TPU check answered yes, as on a TPU); and the
wrappers' refusals. Tests marked `cuda` hold the three kernels against the
plain versions on the card, check that both backward kernels are bitwise the
same on every launch, and skip elsewhere; they import no JAX, so
`python -m pytest --noconftest -m cuda <this file>` runs them on a machine
without it.
"""
import warnings

import numpy as np
import pytest
import torch

from passl_tpu_torch.ops import attention as port_attention
from passl_tpu_torch.ops.attention import (einsum_attention, flash_attention,
                                           flash_attention_bwd_ref, flash_attention_dkv,
                                           flash_attention_dq, flash_attention_fwd,
                                           flash_attention_fwd_ref, resolve_attn_impl)

# plain versions vs the library kernels in interpret mode, f32: the same f32
# formulas summed in another order, over 65-197 keys
F32_TOL = 1e-5
GRAD_TOL = 3e-5
# bf16 inputs: both compute in f32 from the same bf16 values and round p (or
# ds) and the outputs once each; one bf16 ulp is 2^-8 relative, so 2e-2
# (about five ulps) covers a flipped rounding of p feeding a sum
BF16_TOL = 2e-2
# kernel vs plain version on the card, as chip_smoke.py's TOL: f32 sums in
# another order; bf16/f16, one rounding of the same f32 value (2^-8 and 2^-11
# relative, doubled)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
SHAPES = [(2, 65, 2, 32), (2, 65, 2, 64), (2, 197, 3, 32), (2, 197, 3, 64)]  # (n, l, h, d)


def _mk(n, l, h, d, seed=0):
    """numpy q, k, v [n, l, h, d] and the cotangent of the output [n, l, h*d]."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(n, l, h, d).astype(np.float32) for _ in range(3))
    return q, k, v, rs.randn(n, l, h * d).astype(np.float32)


def _jax_flash(q, k, v, dtype=None):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from passl_tpu.ops.attention import flash_attention as jax_flash

    dt = dtype or jnp.float32
    with pltpu.force_tpu_interpret_mode():
        return jax_flash(jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
                         q.shape[-1] ** -0.5, dt)


def _jax_grads(q, k, v, dout, dtype=None):
    """dq, dk, dv of sum(out * dout) through the library kernels' VJP."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from passl_tpu.ops.attention import flash_attention as jax_flash

    dt = dtype or jnp.float32

    def loss(q, k, v):
        o = jax_flash(q, k, v, q.shape[-1] ** -0.5, dt)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q, dt), jnp.asarray(k, dt),
                                                 jnp.asarray(v, dt))


def _torch_grads(q, k, v, dout, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, q.shape[-1] ** -0.5)
    (out.float() * torch.from_numpy(dout)).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_ref_matches_library_interpret(shape):
    q, k, v, _ = _mk(*shape)
    want = np.asarray(_jax_flash(q, k, v))
    o, m, lsum = flash_attention_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                         shape[-1] ** -0.5)
    n, l, h, d = shape
    assert o.dtype == torch.float32 and o.shape == shape
    assert m.shape == lsum.shape == (n, h, l) and m.dtype == lsum.dtype == torch.float32
    np.testing.assert_allclose(o.reshape(n, l, h * d).numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_backward_matches_library_vjp(shape):
    q, k, v, dout = _mk(*shape, seed=1)
    want = _jax_grads(q, k, v, dout)
    got = _torch_grads(q, k, v, dout)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("l", [65, 197])
def test_bf16_forward_and_backward_match_the_library(l):
    import jax.numpy as jnp

    q, k, v, dout = _mk(2, l, 2, 64, seed=2)
    dout = np.asarray(torch.from_numpy(dout).bfloat16().float())  # what both sides see
    want = _jax_flash(q, k, v, dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    got = flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 64**-0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)
    want_g = _jax_grads(q, k, v, dout, dtype=jnp.bfloat16)
    got_g = _torch_grads(q, k, v, dout, dtype=torch.bfloat16)
    for g, w, name in zip(got_g, want_g, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)


def test_bwd_ref_matches_autograd_of_plain_forward():
    q, k, v, _ = (torch.from_numpy(a).double() for a in _mk(2, 19, 2, 8, seed=3))
    dout = torch.from_numpy(np.random.RandomState(4).randn(2, 19, 2, 8))
    for t in (q, k, v):
        t.requires_grad_()
    o, m, lsum = flash_attention_fwd_ref(q, k, v, 0.3)
    o.backward(dout)
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), m, lsum,
                                  dout, 0.3)
    for g, t, name in zip(got, (q, k, v), ("dq", "dk", "dv")):
        # the plain backward works in f32; autograd here in f64
        torch.testing.assert_close(g.double(), t.grad, rtol=1e-5, atol=1e-5, msg=name)


def test_function_cpu_path_runs_the_plain_versions():
    q, k, v, dout = (torch.from_numpy(a) for a in _mk(2, 70, 2, 16, seed=5))
    for t in (q, k, v):
        t.requires_grad_()
    counts = (flash_attention.launches, flash_attention_dkv.launches, flash_attention_dq.launches)
    out = flash_attention(q, k, v, 0.25)
    assert out.shape == (2, 70, 32)
    o, m, lsum = flash_attention_fwd_ref(q.detach(), k.detach(), v.detach(), 0.25)
    assert torch.equal(out.detach(), o.reshape(2, 70, 32))
    saved = out.grad_fn.next_functions[0][0].saved_tensors  # q, k, v, o and the statistics
    assert len(saved) == 6 and torch.equal(saved[4], m) and torch.equal(saved[5], lsum)
    out.backward(dout)
    assert (flash_attention.launches, flash_attention_dkv.launches,
            flash_attention_dq.launches) == counts
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, m, lsum,
                                   dout.reshape(2, 70, 2, 16), 0.25)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


def test_function_reads_strided_qkv_views():
    """q, k, v as the Attention module hands them: views of one qkv tensor."""
    rs = np.random.RandomState(6)
    qkv = torch.from_numpy(rs.randn(2, 66, 3, 2, 8).astype(np.float32)).requires_grad_()
    q, k, v = qkv.unbind(2)
    out = flash_attention(q, k, v, 0.5)
    out.square().sum().backward()
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = (t.contiguous() for t in ref.unbind(2))
    want = flash_attention(rq, rk, rv, 0.5)
    want.square().sum().backward()
    assert torch.equal(out, want) and torch.equal(qkv.grad, ref.grad)


@pytest.mark.parametrize("dtype, softmax", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32")])
def test_einsum_attention_matches_jax(dtype, softmax):
    import jax.numpy as jnp

    from passl_tpu.ops.attention import einsum_attention as jax_einsum

    q, k, v, _ = _mk(2, 50, 3, 16, seed=7)
    want = jax_einsum(*(jnp.asarray(a, dtype) for a in (q, k, v)), 0.25, softmax, jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    got = einsum_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), 0.25,
                           getattr(torch, softmax), tdt)
    assert got.dtype == tdt and got.shape == (2, 50, 48)
    # f32: sums in another order; bf16: the two frameworks round the bf16
    # softmax at other places (XLA each op, torch once), a few ulps
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


RESOLVER_CASES = [("flash", 197, 0.0, True), ("flash", 197, 0.1, False), ("flash", 197, 0.1, True),
                  ("flash", 64, 0.0, True), ("flash", 65, 0.0, False), ("auto", 197, 0.0, True),
                  ("auto", 4095, 0.0, True), ("auto", 4096, 0.0, True), ("auto", 4096, 0.1, False),
                  ("einsum", 4096, 0.0, True)]


@pytest.mark.parametrize("impl, seq_len, attn_drop, deterministic", RESOLVER_CASES)
def test_resolver_follows_the_jax_rules(monkeypatch, impl, seq_len, attn_drop, deterministic):
    """The JAX package's rules on a TPU (its backend check answered yes)."""
    import passl_tpu.ops.attention as jax_attention

    monkeypatch.setattr(jax_attention, "_tpu_backend", lambda: True)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jax_attention.resolve_attn_impl(impl, seq_len, attn_drop, deterministic)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = resolve_attn_impl(impl, seq_len, attn_drop, deterministic)
    assert got == want
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    if impl == "flash" and want == "einsum":
        assert len(pw) == 1 and "attn_impl=flash falling back to einsum" in str(pw[0].message)


def test_resolver_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown attn_impl"):
        resolve_attn_impl("pallas", 197)


def _tensors(n=2, l=70, h=2, d=16, dtype=torch.float32, device="cpu"):
    return [torch.zeros(n, l, h, d, dtype=dtype, device=device) for _ in range(3)]


@pytest.mark.parametrize("change, match", [
    (lambda q, k, v: (q.double(), k.double(), v.double()), "must be one of"),
    (lambda q, k, v: (q[..., 0], k[..., 0], v[..., 0]), r"\[n, l, h, d\]"),
    (lambda q, k, v: (q, k[:1], v), "of q's shape"),
    (lambda q, k, v: (q, k.bfloat16(), v), "of q's shape"),
    (lambda q, k, v: (q, k.transpose(1, 2).contiguous().transpose(1, 2), v), "share their strides"),
    (lambda q, k, v: (torch.zeros(1, 70, 1, 136),) * 3, "d <= 128"),
    (lambda q, k, v: (torch.zeros(1, 70, 1, 20),) * 3, "d % 8 == 0"),
    (lambda q, k, v: tuple(t.transpose(2, 3).contiguous().transpose(2, 3) for t in (q, k, v)),
     "contiguous last dim"),
    (lambda q, k, v: (torch.zeros(1, 1, 1, 16).expand(2**26, 1024, 2, 16),) * 3,
     "exceeds the grid"),  # 2^31 blocks of 64-row tiles
    (lambda q, k, v: (q, k, v), "CUDA tensors"),
])
def test_kernel_wrappers_refuse_what_they_do_not_take(change, match):
    q, k, v = change(*_tensors())
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention_fwd(q, k, v, 0.25)


@pytest.mark.parametrize("kernel, dtype", [("fwd", torch.float32), ("bwd", torch.bfloat16)])
def test_resources_query_takes_the_tensor_core_kernels_only(kernel, dtype):
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        port_attention.flash_kernel_resources(kernel, dtype, 64)


def test_backward_wrappers_check_their_row_inputs():
    q, k, v = _tensors()
    do = torch.zeros_like(q)
    m = lsum = di = torch.zeros(2, 2, 70)
    for fn in (flash_attention_dkv, flash_attention_dq):
        with pytest.raises(ValueError, match="do must be"):
            fn(q, k, v, do.bfloat16(), m, lsum, di, 0.25)
        with pytest.raises(ValueError, match="m must be"):
            fn(q, k, v, do, m[:, :1], lsum, di, 0.25)
        with pytest.raises(ValueError, match="di must be"):
            fn(q, k, v, do, m, lsum, di.transpose(1, 2).contiguous().transpose(1, 2), 0.25)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v, do, m, lsum, di, 0.25)


# ---------------------------------------------------------------- card only


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _qkv_on(device, dtype, n, l, h, d, seed):
    """q, k, v as views of one [n, l, 3, h, d] qkv tensor, drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(n, l, 3, h, d, generator=gen, device=device).to(dtype)
    return qkv.unbind(2)


# (n, l, h, d): ViT-B/16 (2 images), ViT-B/32 (below the resolver's 65),
# ViT-L/16, ViT-H/14 (d = 80), ViT-g/14 (d = 104), MoCo v3 ViT-S (d = 32), the
# shortest flash sequence, one token, a full last tile, d = 8 and 128; then
# the edges of the 64-row tiles and their 16-row warps and 8-key chunks: l
# just below, at and above 64 and 128 (in d = 8, 64 and 128), l = 193 (a last
# tile of one 16-row group and one key chunk), ViT-B/16 at 384 (577), and 24
# ViT-B/16 images, whose 1,152 blocks run in more than one wave of the card;
# last, the edges of the 128-row q tiles (forward and dQ) and of their 16-row
# warps: l = 144 (a second tile of one warp), 255 and 256 (one row short of
# and at two full tiles) and 383 (a third tile whose last warp holds 15 rows)
CARD_SHAPES = [(2, 197, 12, 64), (2, 50, 12, 64), (2, 197, 16, 64), (2, 257, 16, 80),
               (1, 257, 16, 104), (2, 197, 12, 32), (2, 65, 2, 32), (3, 1, 2, 16),
               (2, 128, 2, 64), (2, 100, 2, 8), (1, 70, 2, 128),
               (2, 63, 2, 64), (2, 64, 3, 8), (2, 65, 2, 128), (2, 127, 2, 64), (1, 128, 2, 128),
               (2, 129, 3, 64), (2, 193, 2, 64), (1, 193, 2, 8), (1, 577, 4, 64),
               (24, 197, 12, 64), (2, 144, 2, 64), (1, 255, 2, 64), (1, 256, 2, 32),
               (2, 383, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fwd_kernel_matches_plain_version(cuda, shape, dtype):
    q, k, v = _qkv_on(cuda, dtype, *shape, seed=20)
    scale = shape[-1] ** -0.5
    before = flash_attention.launches
    o, m, lsum = flash_attention_fwd(q, k, v, scale)
    assert flash_attention.launches == before + 1
    o_ref, m_ref, l_ref = flash_attention_fwd_ref(q, k, v, scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(m, m_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lsum, l_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fwd_kernel_repeatable_bitwise(cuda, shape, dtype):
    q, k, v = _qkv_on(cuda, dtype, *shape, seed=23)
    scale = shape[-1] ** -0.5
    first = flash_attention_fwd(q, k, v, scale)
    again = flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bwd_kernels_match_plain_version(cuda, shape, dtype):
    q, k, v = _qkv_on(cuda, dtype, *shape, seed=21)
    do = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(22),
                     device=cuda).to(dtype)
    scale = shape[-1] ** -0.5
    o, m, lsum = flash_attention_fwd_ref(q, k, v, scale)
    before = (flash_attention_dkv.launches, flash_attention_dq.launches)
    got = port_attention.flash_attention_bwd(q, k, v, o, m, lsum, do, scale)
    assert (flash_attention_dkv.launches, flash_attention_dq.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    want = flash_attention_bwd_ref(q, k, v, o, m, lsum, do, scale)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype], atol=TOL[dtype], msg=name)
    again = port_attention.flash_attention_bwd(q, k, v, o, m, lsum, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_autograd_on_cuda_goes_through_the_three_kernels(cuda):
    rs = np.random.RandomState(25)
    qkv = torch.from_numpy(rs.randn(4, 197, 3, 12, 64)).to(cuda, torch.bfloat16).requires_grad_()
    dout = torch.from_numpy(rs.randn(4, 197, 768)).to(cuda, torch.bfloat16)
    counts = (flash_attention.launches, flash_attention_dkv.launches, flash_attention_dq.launches)
    q, k, v = qkv.unbind(2)
    out = flash_attention(q, k, v, 0.125)
    out.backward(dout)
    assert (flash_attention.launches, flash_attention_dkv.launches,
            flash_attention_dq.launches) == tuple(c + 1 for c in counts)
    ref = qkv.detach().float().requires_grad_()
    rq, rk, rv = ref.unbind(2)
    want = einsum_attention(rq, rk, rv, 0.125, torch.float32, torch.float32)
    want.backward(dout.float())
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(qkv.grad.float(), ref.grad, rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take_on_the_card(cuda):
    q, k, v = _tensors(device=cuda)
    with pytest.raises(ValueError, match="d <= 128"):
        flash_attention_fwd(*_tensors(d=136, device=cuda), 0.1)
    with pytest.raises(ValueError, match="share their strides"):
        flash_attention_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 0.1)
    with pytest.raises(ValueError, match="of q's shape"):
        flash_attention_fwd(q, k.cpu(), v, 0.1)
    shifted = torch.zeros(2 * 70 * 2 * 16 + 2, device=cuda)[2:].view(2, 70, 2, 16)  # 8 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(shifted, shifted, shifted, 0.1)
