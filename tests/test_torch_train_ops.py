"""Values and every gradient of the port's train blocks (K11 spatial, K12
temporal, K13 MLP) and of the temporal attention (K4 forward, K6 backward)
against the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX function,
whose Pallas kernels (forward and custom-VJP backward) run in interpret mode
as in the JAX package's own tests, and through the port's function in fp32
on the CPU, where the wrapper takes its plain version under ordinary
autograd. The scalar differentiated is sum(out * cotangent) with a random
cotangent. Tolerance: atol = rtol = 1e-4 (fp32, sums in another order).
The exact-erf MLP is held at atol 2e-4: the TPU kernel evaluates erf by a
rational approximation with 5e-7 absolute error, the port by erf itself,
and the gradients sum that difference over the rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops.mlp_train_block import mlp_train_block
from tpu1x_torch.ops.spatial_train_block import spatial_train_block
from tpu1x_torch.ops.temporal_attention import temporal_attention
from tpu1x_torch.ops.temporal_train_block import temporal_train_block

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
N, S, C, H, T = 4, 16, 32, 4, 4


def rand(rng, *shape, scale=1.0, mean=0.0):
    return (rng.standard_normal(shape) * scale + mean).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def both_ways(jax_fn, torch_fn, args, cot, tol=TOL):
    """`args`: name -> numpy array or None. Calls fn(**args) in each
    framework and holds the output and the gradient of sum(out * cot) for
    every array argument to each other."""
    names = [k for k, v in args.items() if v is not None]

    def jax_loss(*vals):
        kw = dict(args, **dict(zip(names, vals)))
        out = jax_fn(**kw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(args[k]) for k in names))

    leaves = {k: torch.from_numpy(args[k]).requires_grad_(True) for k in names}
    got = torch_fn(**dict(args, **leaves))
    got_grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                    [leaves[k] for k in names])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    for k, g, w in zip(names, got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=k, **tol)


@pytest.mark.parametrize("pre_ln,qkv_bias,proj_bias", [
    (True, False, True),    # the shipped GENIE configs
    (True, True, True),
    (False, False, False),  # qk_norm style: no pre-LN, no biases
])
def test_spatial_train_block(pre_ln, qkv_bias, proj_bias):
    from tpu1x.ops.spatial_train_block import spatial_train_block as jax_fn
    rng = np.random.default_rng(0)
    args = dict(
        x=rand(rng, N, S, C), wqkv=rand(rng, C, 3 * C, scale=0.05),
        wproj=rand(rng, C, C, scale=0.05),
        bqkv=rand(rng, 3 * C, scale=0.02) if qkv_bias else None,
        bproj=rand(rng, C, scale=0.02) if proj_bias else None,
        ln_scale=rand(rng, C, scale=0.1, mean=1.0) if pre_ln else None,
        ln_bias=rand(rng, C, scale=0.1) if pre_ln else None)
    kw = dict(num_heads=H, scale=8.0 / (C // H))

    def j(x, wqkv, wproj, **rest):
        return jax_fn(x, wqkv, wproj, interpret=True, **kw, **rest)

    def t(x, wqkv, wproj, **rest):
        return spatial_train_block(x, wqkv, wproj, **kw, **rest)

    both_ways(j, t, args, rand(rng, N, S, C))


@pytest.mark.parametrize("qkv_bias,proj_bias", [(False, True), (True, True),
                                                (False, False)])
def test_temporal_train_block(qkv_bias, proj_bias):
    from tpu1x.ops.temporal_train_block import temporal_train_block as jax_fn
    rng = np.random.default_rng(1)
    B = 2
    args = dict(
        x=rand(rng, B, T, S, C), wqkv=rand(rng, C, 3 * C, scale=0.05),
        wproj=rand(rng, C, C, scale=0.05),
        bqkv=rand(rng, 3 * C, scale=0.02) if qkv_bias else None,
        bproj=rand(rng, C, scale=0.02) if proj_bias else None)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)

    def j(x, wqkv, wproj, **rest):
        return jax_fn(x, wqkv, wproj, interpret=True, **kw, **rest)

    def t(x, wqkv, wproj, **rest):
        return temporal_train_block(x, wqkv, wproj, **kw, **rest)

    both_ways(j, t, args, rand(rng, B, T, S, C))


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("bias,pre_ln", [(True, True), (False, True),
                                         (True, False)])
def test_mlp_train_block(gelu_approx, bias, pre_ln):
    from tpu1x.ops.mlp_train_block import mlp_train_block as jax_fn
    rng = np.random.default_rng(2)
    F4 = 4 * C
    args = dict(
        x=rand(rng, N, S, C), wfc1=rand(rng, C, F4, scale=0.05),
        wfc2=rand(rng, F4, C, scale=0.05),
        bfc1=rand(rng, F4, scale=0.02) if bias else None,
        bfc2=rand(rng, C, scale=0.02) if bias else None,
        ln_scale=rand(rng, C, scale=0.1, mean=1.0) if pre_ln else None,
        ln_bias=rand(rng, C, scale=0.1) if pre_ln else None)

    def j(x, wfc1, wfc2, **rest):
        return jax_fn(x, wfc1, wfc2, gelu_approx=gelu_approx, interpret=True,
                      **rest)

    def t(x, wfc1, wfc2, **rest):
        return mlp_train_block(x, wfc1, wfc2, gelu_approx=gelu_approx, **rest)

    tol = TOL if gelu_approx else dict(atol=2e-4, rtol=1e-4)
    both_ways(j, t, args, rand(rng, N, S, C), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_temporal_attention_and_backward(causal):
    from tpu1x.ops.temporal_attention import temporal_attention as jax_fn
    rng = np.random.default_rng(3)
    B = 2
    args = dict(q=rand(rng, B, T, S, C), k=rand(rng, B, T, S, C),
                v=rand(rng, B, T, S, C))
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, causal=causal)

    def j(q, k, v):
        return jax_fn(q, k, v, interpret=True, **kw)

    def t(q, k, v):
        return temporal_attention(q, k, v, **kw)

    both_ways(j, t, args, rand(rng, B, T, S, C))


def test_train_blocks_return_param_dtype_gradients():
    """fp32 master weights under a bf16 activation: gradients come back in
    each parameter's dtype, dx in the activation's."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rand(rng, 2, S, C)).bfloat16().requires_grad_(True)
    w1 = torch.from_numpy(rand(rng, C, 4 * C, scale=0.05)).requires_grad_(True)
    w2 = torch.from_numpy(rand(rng, 4 * C, C, scale=0.05)).requires_grad_(True)
    g = torch.ones(C, requires_grad=True)
    b = torch.zeros(C, requires_grad=True)
    out = mlp_train_block(x, w1, w2, ln_scale=g, ln_bias=b)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in (w1, w2, g, b))
