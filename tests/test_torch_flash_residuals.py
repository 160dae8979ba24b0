"""The residuals of the port's fused attention backward and its GEMM for
the spatial block's products, against the JAX package.

`mha_lse_reference` gives the forward's output and the per-query
log-sum-exp that the card's forward writes beside it; `flash_mha_bwd_plain`
is the backward from those residuals, the arithmetic of the card's
backward; `gemm_sm90` on a CPU tensor is its plain version, the serving
chain of the spatial block's products. The same inputs, drawn with numpy
from a seed, go through the JAX function and the port's in fp32 on the CPU;
the JAX kernels run in interpret mode, as the JAX package's own tests run
them. Tolerance: atol = rtol = 1e-4 (fp32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.ops import pallas_attention as jpa
from tpu1x_torch import kernels
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops import spatial_block as tsb

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
SCALE = 32 ** -0.5
# (tokens, heads, head_dim), 2 rows: the kernels' token counts at head_dim
# 32, and 128 tokens at 64 and 128, the kernels' other head widths (ids as
# before the head_dim existed)
SHAPES = [pytest.param(64, 4, 32, id="64-4"),
          pytest.param(128, 3, 32, id="128-3"),
          pytest.param(256, 2, 32, id="256-2"),
          pytest.param(128, 2, 64, id="128-2-h64"),
          pytest.param(128, 2, 128, id="128-2-h128")]


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def bhnd(a):
    """(R, N, H, D) -> the JAX kernels' (R, H, N, D)."""
    return jnp.asarray(a).transpose(0, 2, 1, 3)


def from_bhnd(a):
    return np.asarray(a).transpose(0, 2, 1, 3)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def inputs(seed, N, H, D):
    rng = np.random.default_rng(seed)
    return [rand(rng, 2, N, H, D) for _ in range(4)]  # q, k, v, dout


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,H,D", SHAPES)
def test_lse_reference_output(causal, N, H, D):
    """The o of `mha_lse_reference` against the JAX forward kernel in
    interpret mode; it is `mha_reference`'s exactly."""
    q, k, v, _ = inputs(10, N, H, D)
    want = jpa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=SCALE, causal=causal, interpret=True)
    o, _ = tattn.mha_lse_reference(t(q), t(k), t(v), scale=SCALE,
                                   causal=causal)
    close(o, want)
    assert torch.equal(o, tattn.mha_reference(t(q), t(k), t(v), scale=SCALE,
                                              causal=causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,H,D", SHAPES)
def test_lse_reference_lse(causal, N, H, D):
    """lse (R, H, N) against jax.nn.logsumexp of the scaled logits over the
    keys in view."""
    q, k, _, _ = inputs(11, N, H, D)
    logits = jnp.einsum("rqhd,rkhd->rhqk", jnp.asarray(q),
                        jnp.asarray(k)) * SCALE
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((N, N), bool)), logits, -jnp.inf)
    want = jax.nn.logsumexp(logits, axis=-1)
    _, lse = tattn.mha_lse_reference(t(q), t(k), t(q), scale=SCALE,
                                     causal=causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, H, N)
    close(lse, want)


def plain_grads(q, k, v, dout, causal):
    o, lse = tattn.mha_lse_reference(t(q), t(k), t(v), scale=SCALE,
                                     causal=causal)
    return tattn.flash_mha_bwd_plain(t(q), t(k), t(v), o, lse, t(dout),
                                     scale=SCALE, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,H,D", SHAPES)
def test_bwd_plain_against_jnp_oracle(causal, N, H, D):
    """dq, dk, dv from (o, lse) against the JAX package's jnp oracle of the
    backward kernel, which recomputes the softmax."""
    q, k, v, dout = inputs(12, N, H, D)
    want = jpa._flash_mha_bwd_jnp(SCALE, causal, (bhnd(q), bhnd(k), bhnd(v)),
                                  bhnd(dout))
    for name, g, w in zip("qkv", plain_grads(q, k, v, dout, causal), want):
        np.testing.assert_allclose(g.numpy(), from_bhnd(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,H,D", SHAPES)
def test_bwd_plain_against_kernel(causal, N, H, D):
    """dq, dk, dv from (o, lse) against the JAX backward kernel
    (_flash_mha_bwd_bhnd) in interpret mode."""
    q, k, v, dout = inputs(13, N, H, D)
    want = jpa._flash_mha_bwd_bhnd(bhnd(q), bhnd(k), bhnd(v), bhnd(dout),
                                   scale=SCALE, causal=causal, interpret=True)
    for name, g, w in zip("qkv", plain_grads(q, k, v, dout, causal), want):
        np.testing.assert_allclose(g.numpy(), from_bhnd(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_on_qkv_thirds(causal):
    """q, k, v as strided thirds of one (R, N, 3, H, D) tensor, the train
    step's layout: the gradient of the packed tensor against the JAX kernel
    pair's."""
    rng = np.random.default_rng(14)
    qkv, cot = rand(rng, 2, 128, 3, 2, 32), rand(rng, 2, 128, 2, 32)

    def loss(qkv):
        out = jpa.flash_mha(qkv[..., 0, :, :], qkv[..., 1, :, :],
                            qkv[..., 2, :, :], scale=SCALE, causal=causal,
                            interpret=True)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.grad(loss)(jnp.asarray(qkv))
    q, k, v = t(qkv).unbind(-3)
    assert not q.is_contiguous()
    o, lse = tattn.mha_lse_reference(q, k, v, scale=SCALE, causal=causal)
    grads = tattn.flash_mha_bwd_plain(q, k, v, o, lse, t(cot), scale=SCALE,
                                      causal=causal)
    close(torch.stack(grads, dim=-3), want)


# the epilogue's forms: no activation (ids as before the GELU existed), the
# tanh GELU and the exact-erf GELU, each with and without bias and residual
GEMM_CASES = [pytest.param(act, bias, resid,
                           id=("" if act is None else f"{act}-")
                           + f"{resid}-{bias}")
              for act in (None, "tanh", "erf") for resid in (False, True)
              for bias in (False, True)]


@pytest.mark.parametrize("act,bias,resid", GEMM_CASES)
def test_gemm_sm90_plain(act, bias, resid):
    """`gemm_sm90` on CPU tensors: a @ b (+ bias) (GELU) (+ resid), the JAX
    package's serving chain `gelu(dense(h, w, b), approximate=...)` and
    adds (tpu1x/ops/temporal_mlp_block.py's reference), in fp32."""
    rng = np.random.default_rng(15)
    a, b = rand(rng, 96, 64), rand(rng, 64, 128, scale=0.1)
    bb, r = rand(rng, 128), rand(rng, 96, 128)
    want = jnp.dot(jnp.asarray(a), jnp.asarray(b),
                   precision=jax.lax.Precision.HIGHEST)
    want = want + (jnp.asarray(bb) if bias else 0.0)
    if act is not None:
        want = jax.nn.gelu(want, approximate=act == "tanh")
    want = (jnp.asarray(r) if resid else 0.0) + want
    got = tsb.gemm_sm90(t(a), t(b), t(bb) if bias else None,
                        t(r) if resid else None, act=act)
    close(got, want)


def test_gemm_sm90_act_is_checked():
    """An activation the epilogue does not have is refused, on any device."""
    a, b = torch.zeros(4, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="act must be one of"):
        tsb.gemm_sm90(a, b, act="relu")
