"""The port's decode attention (one frame and the [prev, cur] pair, bf16-style
and int8 cache), its cache quantization, the spatial block's qk-LN and the
fused attention's plain version, against the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX function
and the port's in fp32 on the CPU. The JAX kernels run in interpret mode and
are held beside their jnp references, as the JAX package's own tests do;
the port's wrappers take their plain versions because the tensors lie on the
CPU. Tolerance: atol = rtol = 1e-4 (fp32, sums in another order) unless a
test states another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.ops import decode_attention as jdec
from tpu1x_torch import kernels
from tpu1x_torch.models.st_maskgit import update_cache
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops import decode_attention as tdec
from tpu1x_torch.ops.spatial_block import spatial_block

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
L, B, S, T, C, H = 3, 4, 32, 5, 64, 2


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("dim", [-1, 2])
def test_quantize_and_dequantize_kv(dim):
    """int8 values equal, scales equal (both divide by 127 and round half to
    even in fp32); a zero token gets scale 1."""
    rng = np.random.default_rng(0)
    x = rand(rng, 3, 4, 6, 16, scale=2.0)
    x[1, 2] = 0.0
    x[0, 0, 0, :4] = [0.5, 1.5, 2.5, -0.5]  # ties after the division
    x[0, 0, 0, 4] = 127.0
    q, scale = tdec.quantize_kv(t(x), dim=dim)
    wq, wscale = jdec.quantize_kv(jnp.asarray(x), axis=dim)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(wscale))
    back = tdec.dequantize_kv(q, scale, dim=dim)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jdec.dequantize_kv(wq, wscale, axis=dim)))
    assert float((back - t(x)).abs().max()) <= float(scale.max()) / 2 + 1e-6


def decode_inputs(seed, frames):
    rng = np.random.default_rng(seed)
    qkv = [rand(rng, B, S, C) for _ in range(3 * frames)]
    kc, vc = rand(rng, T, L, B, S, C), rand(rng, T, L, B, S, C)
    return qkv, kc, vc


def quantized(kc, vc):
    """int8 caches and their (L, B, T, S) scales, made by the JAX package."""
    out = []
    for c in (kc, vc):
        q, sc = jdec.quantize_kv(jnp.asarray(c))
        out += [np.asarray(q), np.asarray(jnp.transpose(sc, (1, 2, 0, 3)))]
    return out  # kq, ksc, vq, vsc


@pytest.mark.parametrize("int8", [False, True], ids=["plain-cache", "int8"])
@pytest.mark.parametrize("layer,t_B", [(0, (0, 1, 3, 5)), (2, (4, 0, 2, 1))])
def test_temporal_decode_attention(int8, layer, t_B):
    """K7's wrapper on the CPU against the JAX kernel (interpret) and, for
    the int8 cache, against the reference fed the dequantized cache."""
    (q, kcur, vcur), kc, vc = decode_inputs(1, 1)
    tB = np.array(t_B, np.int32)
    kw = dict(layer=layer, scale=0.25, num_heads=H)
    jkw, tkw = {}, {}
    if int8:
        kc, ksc, vc, vsc = quantized(kc, vc)
        jkw = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
        tkw = dict(k_scale=t(ksc), v_scale=t(vsc))
    want = jdec.temporal_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcur),
        jnp.asarray(vcur), jnp.asarray(tB), tile_s=16, interpret=True, **kw,
        **jkw)
    got = tdec.temporal_decode_attention(t(q), t(kc), t(vc), t(kcur), t(vcur),
                                         t(tB), **kw, **tkw)
    close(got, want)
    if int8:
        deq = [jdec.dequantize_kv(jnp.asarray(c), jnp.transpose(
            jnp.asarray(sc), (2, 0, 1, 3)))[:, layer]
            for c, sc in ((kc, ksc), (vc, vsc))]
        ref = jdec.temporal_decode_attention_reference(
            jnp.asarray(q), *deq, jnp.asarray(kcur), jnp.asarray(vcur),
            jnp.asarray(tB), scale=0.25, num_heads=H)
        close(got, ref)
    # a row with t = 0 attends its own key alone: the output is its v
    for b in np.nonzero(tB == 0)[0]:
        close(got[b], vcur[b])


@pytest.mark.parametrize("int8", [False, True], ids=["plain-cache", "int8"])
@pytest.mark.parametrize("layer,t_prev", [(0, (0, 1, 2, 4)),
                                          (1, (3, 0, 4, 2))])
def test_temporal_decode2_attention(int8, layer, t_prev):
    """K8's wrapper on the CPU against the JAX kernel (interpret)."""
    (qp, qc, kp, vp, kcur, vcur), kc, vc = decode_inputs(2, 2)
    tB = np.array(t_prev, np.int32)
    kw = dict(layer=layer, scale=0.25, num_heads=H)
    jkw, tkw = {}, {}
    if int8:
        kc, ksc, vc, vsc = quantized(kc, vc)
        jkw = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
        tkw = dict(k_scale=t(ksc), v_scale=t(vsc))
    args = (qp, qc, kc, vc, kp, vp, kcur, vcur, tB)
    want = jdec.temporal_decode2_attention(
        *map(jnp.asarray, args), tile_s=16, interpret=True, **kw, **jkw)
    got = tdec.temporal_decode2_attention(*map(t, args), **kw, **tkw)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("pair", [False, True])
def test_decode_attention_out_and_kv_out(pair):
    """Results written into the caller's tensors (strided halves of one
    tensor; a layer of a k/v stack): the same values, in place; inputs that
    are column views of one qkv product."""
    rng = np.random.default_rng(3)
    frames = 2 if pair else 1
    qkv = t(rand(rng, frames * B, S, 3 * C))
    q, k, v = qkv.split(C, dim=-1)
    kc, vc = t(rand(rng, T, L, B, S, C)), t(rand(rng, T, L, B, S, C))
    tB = t(np.array([0, 2, 4, 5], np.int32))
    kw = dict(layer=1, scale=0.25, num_heads=H)
    if pair:
        args = (q[:B], q[B:], kc, vc, k[:B], v[:B], k[B:], v[B:], tB)
        fn = tdec.temporal_decode2_attention
    else:
        args = (q, kc, vc, k, v, tB)
        fn = tdec.temporal_decode_attention
    want = fn(*args, **kw)
    out = torch.zeros(frames * B, S, C)
    stack = torch.zeros(2, L, B, S, C)
    got = fn(*args, out=(out[:B], out[B:]) if pair else out,
             kv_out=(stack[0, 1], stack[1, 1]), **kw)
    if pair:
        assert got[0].data_ptr() == out.data_ptr()
        assert torch.equal(out, torch.cat(want))
    else:
        assert got.data_ptr() == out.data_ptr() and torch.equal(out, want)
    assert torch.equal(stack[0, 1], k[:B]) and torch.equal(stack[1, 1], v[:B])
    assert not stack[:, 0].any() and not stack[:, 2].any()


def test_update_cache_int8():
    from tpu1x.models import st_maskgit as jsm
    rng = np.random.default_rng(4)
    kc, vc = rand(rng, T, L, B, S, C), rand(rng, T, L, B, S, C)
    kq, ksc, vq, vsc = quantized(kc, vc)
    kn, vn = rand(rng, 1, L, B, S, C), rand(rng, 1, L, B, S, C)
    want = jsm.update_cache(
        {"k": jnp.asarray(kq), "v": jnp.asarray(vq),
         "k_scale": jnp.asarray(ksc), "v_scale": jnp.asarray(vsc)},
        (jnp.asarray(kn), jnp.asarray(vn)), 3)
    cache = {"k": t(kq.copy()), "v": t(vq.copy()), "k_scale": t(ksc.copy()),
             "v_scale": t(vsc.copy())}
    got = update_cache(cache, (t(kn), t(vn)), 3)
    assert got is cache and cache["k"].dtype == torch.int8  # in place
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("pre_ln,qkv_bias,H_", [
    pytest.param(False, False, 2, id="False-False"),
    pytest.param(False, True, 2, id="False-True"),
    pytest.param(True, False, 2, id="True-False"),
    pytest.param(False, False, 1, id="False-False-h64")])
def test_spatial_block_qk_ln(pre_ln, qkv_bias, H_):
    """The spatial block with the per-head qk-LN (and, for completeness,
    with both LayerNorms) against the JAX kernel in interpret mode; H_ = 1
    at C = 64 is head_dim 64, the card kernels' other head width."""
    from tpu1x.ops.spatial_block import spatial_block as jax_spatial_block
    rng = np.random.default_rng(5)
    N, S_, C_ = 3, 32, 64
    D = C_ // H_
    kw = dict(x=rand(rng, N, S_, C_, scale=0.5),
              wqkv=rand(rng, C_, 3 * C_, scale=0.05),
              wproj=rand(rng, C_, C_, scale=0.05),
              bproj=rand(rng, C_, scale=0.1),
              qk_ln_scale=1.0 + rand(rng, D, scale=0.1),
              qk_ln_bias=rand(rng, D, scale=0.1))
    if pre_ln:
        kw.update(ln_scale=1.0 + rand(rng, C_, scale=0.1),
                  ln_bias=rand(rng, C_, scale=0.1))
    if qkv_bias:
        kw["bqkv"] = rand(rng, 3 * C_, scale=0.1)
    scale = 8.0 / D
    want = jax_spatial_block(num_heads=H_, scale=scale, interpret=True,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = spatial_block(num_heads=H_, scale=scale,
                        **{k: t(v) for k, v in kw.items()})
    close(got, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lead,N", [((3,), 64), ((2, 2), 128), ((2,), 192),
                                    ((1,), 256)])
def test_flash_mha_and_gradients(causal, lead, N):
    """`flash_mha` (its plain version, on the CPU) against the JAX kernel
    pair in interpret mode: the value and dq, dk, dv of sum(out * cot)."""
    from tpu1x.ops.pallas_attention import flash_mha as jax_flash
    rng = np.random.default_rng(6)
    Hh, D = 2, 8
    q, k, v, cot = (rand(rng, *lead, N, Hh, D) for _ in range(4))

    def loss(q, k, v):
        out = jax_flash(q, k, v, scale=0.3, causal=causal, interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    got = tattn.flash_mha(*leaves, scale=0.3, causal=causal)
    grads = torch.autograd.grad((got * t(cot)).sum(), leaves)
    close(got.detach(), want)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_on_qkv_thirds(causal):
    """q, k and v as strided thirds of one (..., N, 3, H, D) tensor, the
    train step's layout, which the card kernels read in place: the value
    and the gradient of the packed tensor, against the JAX kernel pair."""
    from tpu1x.ops.pallas_attention import flash_mha as jax_flash
    rng = np.random.default_rng(8)
    qkv, cot = rand(rng, 2, 128, 3, 2, 8), rand(rng, 2, 128, 2, 8)

    def loss(qkv):
        out = jax_flash(qkv[..., 0, :, :], qkv[..., 1, :, :],
                        qkv[..., 2, :, :], scale=0.3, causal=causal,
                        interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), want_grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(qkv))
    leaf = t(qkv).requires_grad_(True)
    q, k, v = leaf.unbind(-3)
    assert q.stride()[-3] == 3 * 2 * 8 and not q.is_contiguous()
    got = tattn.flash_mha(q, k, v, scale=0.3, causal=causal)
    (grad,) = torch.autograd.grad((got * t(cot)).sum(), [leaf])
    close(got.detach(), want)
    close(grad, want_grad)


@pytest.mark.parametrize("N", [64, 16])
def test_mha_is_the_plain_attention_on_the_cpu(N):
    """Above and below the token count from which `mha` takes the fused
    kernel on the card, a CPU tensor gets `mha_reference`."""
    rng = np.random.default_rng(7)
    q, k, v = (t(rand(rng, 2, N, 2, 8)) for _ in range(3))
    assert (N >= tattn.FLASH_MIN_TOKENS) == (N == 64)
    want = tattn.mha_reference(q, k, v, scale=0.3, causal=True)
    assert torch.equal(tattn.mha(q, k, v, scale=0.3, causal=True), want)
