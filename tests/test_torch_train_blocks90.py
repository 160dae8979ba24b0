"""The spatial and temporal train blocks' launch sequences on the CPU:
`spatial_train_block_bwd` and `temporal_train_block_fwd` / `_bwd` on CPU
tensors, where every launcher computes its plain version (the GEMM's
training forms and serving chain, the LayerNorm row passes, the column
sums, the flash attention pair, the temporal attention and its VJP) in the
order the wrappers launch the kernels on the card, against the JAX
package's `spatial_train_block` / `temporal_train_block` values and
`jax.vjp`; and `flash_mha_bwd` writing into the thirds of one qkv gradient.

The JAX side runs its Pallas kernels in interpret mode, as in the JAX
package's own tests; inputs are drawn with numpy from a seed. Tolerance:
atol = rtol = 1e-4 in fp32 (sums in another order); in bf16 2e-2 in
relative L2 (both sides round to bf16 at different places between the
products, each rounding 2^-9 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops.spatial_block import spatial_block
from tpu1x_torch.ops.spatial_train_block import spatial_train_block_bwd
from tpu1x_torch.ops.temporal_train_block import (temporal_train_block_bwd,
                                                  temporal_train_block_fwd)

torch.set_num_threads(2)
BF16 = torch.bfloat16
N, S, C, H = 2, 32, 64, 2
B, T = 2, 4


def rand(rng, *shape, scale=1.0, mean=0.0):
    return (rng.standard_normal(shape) * scale + mean).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def close(got, want, dtype):
    g, w = got.double().numpy(), want.double().numpy()
    assert g.shape == w.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        return
    assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)


def as_torch(j):
    return torch.from_numpy(np.array(j.astype(jnp.float32)))


def jax_value_and_vjp(fn, args, cot, dtype):
    """fn's value and the VJP at `cot` of every array in `args` (name ->
    numpy array or None), in the JAX package at `dtype`; the LN params
    stay fp32, as the port's train step keeps them."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = {k: None if v is None else
             jnp.asarray(v, jnp.float32 if k.startswith("ln") else jdt)
             for k, v in args.items()}
    names = [k for k, v in jargs.items() if v is not None]
    want, vjp = jax.vjp(lambda *v: fn(**dict(jargs, **dict(zip(names, v)))),
                        *(jargs[k] for k in names))
    return as_torch(want), {k: as_torch(g) for k, g in
                            zip(names, vjp(jnp.asarray(cot, jdt)))}


def to_torch(args, dtype):
    return {k: None if v is None else
            torch.from_numpy(v).to(torch.float32 if k.startswith("ln")
                                   else dtype)
            for k, v in args.items()}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_spatial_launch_sequence_against_jax(qkv_bias, dtype):
    """`spatial_train_block_bwd` (LN1, the serving qkv product, K9's
    forward and K10's backward into one dqkv, the training forms, the LN
    backward) against `jax.vjp` of the JAX package's `spatial_train_block`,
    with the proj bias and with and without the qkv bias; the value through
    the forward's `spatial_block`."""
    from tpu1x.ops.spatial_train_block import spatial_train_block as jax_fn
    rng = np.random.default_rng(3)
    args = dict(
        x=rand(rng, N, S, C), wqkv=rand(rng, C, 3 * C, scale=0.05),
        wproj=rand(rng, C, C, scale=0.05),
        bqkv=rand(rng, 3 * C, scale=0.02) if qkv_bias else None,
        bproj=rand(rng, C, scale=0.02),
        ln_scale=rand(rng, C, scale=0.1, mean=1.0),
        ln_bias=rand(rng, C, scale=0.1))
    cot = rand(rng, N, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    want, want_grads = jax_value_and_vjp(
        lambda x, wqkv, wproj, **rest: jax_fn(x, wqkv, wproj, interpret=True,
                                              **kw, **rest), args, cot, dtype)

    t = to_torch(args, dtype)
    got = spatial_block(t["x"], t["wqkv"], t["wproj"], bqkv=t["bqkv"],
                        bproj=t["bproj"], ln_scale=t["ln_scale"],
                        ln_bias=t["ln_bias"], **kw)
    grads = spatial_train_block_bwd(
        t["x"], torch.from_numpy(cot).to(dtype), t["wqkv"], t["wproj"],
        t["bqkv"], t["ln_scale"], t["ln_bias"], proj_bias=True, **kw)
    assert got.dtype == dtype and grads[0].dtype == dtype
    assert all(g is None or g.dtype == torch.float32 for g in grads[1:])
    close(got, want, dtype)
    for name, g in zip(("x", "wqkv", "wproj", "bqkv", "bproj", "ln_scale",
                        "ln_bias"), grads):
        if name == "bqkv" and not qkv_bias:
            assert g is None
            continue
        close(g, want_grads[name], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("qkv_bias,proj_bias", [(False, True), (True, True),
                                                (False, False),
                                                (True, False)])
def test_temporal_launch_sequence_against_jax(qkv_bias, proj_bias, dtype):
    """`temporal_train_block_fwd` and `_bwd` (the training forms around the
    temporal attention and the plain VJP that stands for its backward
    kernel) against the JAX package's `temporal_train_block` value and
    `jax.vjp`, with and without each bias."""
    from tpu1x.ops.temporal_train_block import temporal_train_block as jax_fn
    rng = np.random.default_rng(4)
    args = dict(
        x=rand(rng, B, T, S, C), wqkv=rand(rng, C, 3 * C, scale=0.05),
        wproj=rand(rng, C, C, scale=0.05),
        bqkv=rand(rng, 3 * C, scale=0.02) if qkv_bias else None,
        bproj=rand(rng, C, scale=0.02) if proj_bias else None)
    cot = rand(rng, B, T, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    want, want_grads = jax_value_and_vjp(
        lambda x, wqkv, wproj, **rest: jax_fn(x, wqkv, wproj, interpret=True,
                                              **kw, **rest), args, cot, dtype)

    t = to_torch(args, dtype)
    got = temporal_train_block_fwd(t["x"], t["wqkv"], t["wproj"], t["bqkv"],
                                   t["bproj"], **kw)
    grads = temporal_train_block_bwd(
        t["x"], torch.from_numpy(cot).to(dtype), t["wqkv"], t["wproj"],
        t["bqkv"], proj_bias=proj_bias, **kw)
    assert got.dtype == dtype and grads[0].dtype == dtype
    close(got, want, dtype)
    for name, g in zip(("x", "wqkv", "wproj", "bqkv", "bproj"), grads):
        if args[name] is None:
            assert g is None
            continue
        assert g.dtype == (dtype if name == "x" else torch.float32)
        close(g, want_grads[name], dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_into_qkv_thirds_equals_contiguous(causal):
    """`flash_mha_bwd(..., out=...)` writes into the q, k, v thirds of one
    (R, N, 3C) gradient exactly what it returns as new tensors."""
    rng = np.random.default_rng(5)
    R, n, D = 2, 64, 32
    qkv = torch.from_numpy(rand(rng, R, n, 3, H, D))
    dout = torch.from_numpy(rand(rng, R, n, H, D))
    q, k, v = qkv.unbind(2)
    kw = dict(scale=D ** -0.5, causal=causal)
    o, lse = tattn.flash_mha_fwd(q, k, v, **kw)
    want = tattn.flash_mha_bwd(q, k, v, o, lse, dout, **kw)
    dqkv = torch.full((R, n, 3 * H * D), float("nan"))
    thirds = dqkv.view(R, n, 3, H, D).unbind(2)
    got = tattn.flash_mha_bwd(q, k, v, o, lse, dout, out=thirds, **kw)
    for g, th, w in zip(got, thirds, want):
        assert g.data_ptr() == th.data_ptr()
        assert torch.equal(g, w)
    assert torch.equal(dqkv.view(R, n, 3, H, D), torch.stack(want, 2))
