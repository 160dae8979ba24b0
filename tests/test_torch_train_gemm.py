"""The MLP train block's launch sequence on the CPU: the plain versions of
its launchers (the training forms of the TMA/wgmma GEMM, the LayerNorm row
passes and the column sums) against float64 with the kernels' rounding
points, and `mlp_train_block_fwd` / `_bwd` as a whole against the JAX
package's `mlp_train_block` and its VJP.

On CPU tensors each launcher computes its plain version, so the block's
wrappers run their launch sequence here exactly as they sequence the
kernels on the card. The JAX side runs its Pallas kernels in interpret mode,
as in the JAX package's own tests; inputs are drawn with numpy from a seed.
Tolerance: atol = rtol = 1e-4 in fp32 (sums in another order); in bf16
2e-2 in relative L2, and elementwise atol = rtol = 2e-2 for the single
forms (one bf16 rounding, 2^-8 relative, apart at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops.mlp_train_block import (mlp_train_block_bwd,
                                             mlp_train_block_fwd)

torch.set_num_threads(2)
BF16 = torch.bfloat16
M, K, N = 64, 128, 96


def rand(rng, *shape, scale=1.0, mean=0.0):
    return (rng.standard_normal(shape) * scale + mean).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def gelu64(x, tanh):
    if tanh:
        return 0.5 * x * (1 + torch.tanh(0.7978845608028654
                                         * (x + 0.044715 * x ** 3)))
    return 0.5 * x * (1 + torch.erf(x / 2 ** 0.5))


def dgelu64(x, tanh):
    """d gelu / dx in float64 by autograd of `gelu64`."""
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(gelu64(x, tanh).sum(), x)
    return g


def want64(a, b, form, bias, resid, aux, act, fp32_out, pre_out, cd):
    """The form in float64 with the stated rounding: the product exact,
    then + bias, the activation, one rounding to `cd`, + resid rounded."""
    a64 = a.double().t() if form == "tn" else a.double()
    b64 = b.double().t() if form == "nt" else b.double()
    acc = torch.einsum("mk,kn->mn", a64, b64)
    if form == "tn" or fp32_out:
        return (acc,)
    if bias is not None:
        acc = acc + bias.double()
    pre = acc.to(cd)
    if act in ("gelu_tanh", "gelu_erf"):
        acc = gelu64(acc, act == "gelu_tanh")
    elif act is not None:
        acc = acc * dgelu64(aux.double(), act == "dgelu_tanh")
    out = acc.to(cd)
    if resid is not None:
        out = (resid.double() + out.double()).to(cd)
    return (out, pre) if pre_out else (out,)


def close(got, want, dtype, elementwise=True):
    g, w = got.double().numpy(), want.double().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        return
    assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)
    if elementwise:
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2)


FORMS = [
    ("nn", dict()),
    ("nn", dict(bias=True, act="gelu_erf")),
    ("nn", dict(bias=True, act="gelu_tanh")),
    ("nn", dict(bias=True, act="gelu_erf", pre_out=True)),
    ("nn", dict(bias=True, act="gelu_tanh", pre_out=True)),
    ("nn", dict(bias=True, resid=True)),
    ("nt", dict(aux=True, act="dgelu_erf")),
    ("nt", dict(aux=True, act="dgelu_tanh")),
    ("nt", dict(fp32_out=True)),
    ("nt", dict(resid=True)),
    ("tn", dict()),
]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("form,opts", FORMS,
                         ids=[f"{f}-{'-'.join(o) or 'bare'}"
                              for f, o in FORMS])
def test_gemm90_form_against_float64(form, opts, dtype):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rand(rng, *((K, M) if form == "tn" else (M, K))))
    b = torch.from_numpy(rand(rng, *((N, K) if form == "nt" else (K, N)),
                              scale=0.1))
    kw = dict(
        bias=torch.from_numpy(rand(rng, N, scale=0.1)) if opts.get("bias")
        else None,
        resid=torch.from_numpy(rand(rng, M, N)) if opts.get("resid") else None,
        aux=torch.from_numpy(rand(rng, M, N)) if opts.get("aux") else None,
        act=opts.get("act"), fp32_out=opts.get("fp32_out", False),
        pre_out=opts.get("pre_out", False))
    a, b = a.to(dtype), b.to(dtype)
    kw = {k: v.to(dtype) if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    got = tk.gemm90(a, b, form=form, **kw)
    got = got if kw["pre_out"] else (got,)
    want = want64(a, b, form, cd=dtype, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        fp32 = form == "tn" or kw["fp32_out"]
        assert g.dtype == (torch.float32 if fp32 else dtype)
        close(g, w, torch.float32 if fp32 else dtype)


@pytest.mark.parametrize("form,kw", [
    ("nn", dict(act="dgelu_erf")),         # GELU' is the nt form's
    ("nt", dict(act="gelu_erf")),          # GELU is the nn form's
    ("nt", dict(pre_out=True)),            # pre_out is the nn form's
    ("nn", dict(fp32_out=True)),           # the fp32 store is nt's
    ("tn", dict(bias=True)),               # tn has no epilogue
    ("nt", dict(act="dgelu_tanh")),        # GELU' needs aux
    ("nn", dict(pre_out=True, resid=True)),  # one tile staged beside C
    ("xx", dict()),
])
def test_gemm90_refuses_forms_without_an_instantiation(form, kw):
    a, b = torch.zeros(M, K), torch.zeros(K, N)
    if form == "nt":
        b = b.t().contiguous()
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros(N)
    if kw.pop("resid", False):
        kw["resid"] = torch.zeros(M, N)
    with pytest.raises(ValueError):
        tk.gemm90(a, b, form=form, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_ln_row_passes_and_col_sum_against_float64(dtype):
    rng = np.random.default_rng(1)
    rows, C = 48, 64
    x = torch.from_numpy(rand(rng, rows, C, mean=0.3)).to(dtype)
    scale = torch.from_numpy(rand(rng, C, scale=0.1, mean=1.0))
    bias = torch.from_numpy(rand(rng, C, scale=0.1))
    d_xn = torch.from_numpy(rand(rng, rows, C))
    dout = torch.from_numpy(rand(rng, rows, C)).to(dtype)

    x64 = x.double().requires_grad_(True)
    s64, b64 = (t.double().requires_grad_(True) for t in (scale, bias))
    mu = x64.mean(-1, keepdim=True)
    var = (x64 * x64).mean(-1, keepdim=True) - mu * mu
    xn64 = (x64 - mu) / torch.sqrt(var + 1e-5) * s64 + b64
    dx64, ds64, db64 = torch.autograd.grad(xn64, (x64, s64, b64),
                                           d_xn.double())

    xn, stats = tk.ln_fwd(x, scale, bias)
    assert xn.dtype == dtype and stats.shape == (rows, 2)
    close(xn, xn64.detach().to(dtype), dtype)
    dx, ds, db = tk.ln_bwd(x, stats, scale, d_xn, dout)
    assert dx.dtype == dtype
    close(dx, (dx64 + dout.double()).to(dtype), dtype)
    for got, want in ((ds, ds64), (db, db64)):
        close(got, want, torch.float32)
    close(tk.col_sum(dout), dout.double().sum(0), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_mlp_launch_sequence_against_jax(pre_ln, gelu_approx, dtype):
    """`mlp_train_block_fwd` and `_bwd` on CPU tensors (the launchers'
    plain versions, in the kernels' order) against the JAX package's
    `mlp_train_block` value and `jax.vjp`, with biases, with and without
    the LN."""
    from tpu1x.ops.mlp_train_block import mlp_train_block as jax_fn
    rng = np.random.default_rng(2)
    B, S, C = 2, 32, 64
    F4 = 4 * C
    args = dict(
        x=rand(rng, B, S, C), wfc1=rand(rng, C, F4, scale=0.05),
        wfc2=rand(rng, F4, C, scale=0.05), bfc1=rand(rng, F4, scale=0.02),
        bfc2=rand(rng, C, scale=0.02),
        ln_scale=rand(rng, C, scale=0.1, mean=1.0) if pre_ln else None,
        ln_bias=rand(rng, C, scale=0.1) if pre_ln else None)
    cot = rand(rng, B, S, C)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # the LN params stay fp32, as the port's train step keeps them
    jargs = {k: None if v is None else
             jnp.asarray(v, jnp.float32 if k.startswith("ln") else jdt)
             for k, v in args.items()}

    def jax_out(x, wfc1, wfc2, bfc1, bfc2, ln_scale, ln_bias):
        return jax_fn(x, wfc1, wfc2, bfc1=bfc1, bfc2=bfc2, ln_scale=ln_scale,
                      ln_bias=ln_bias, gelu_approx=gelu_approx,
                      interpret=True)
    names = [k for k, v in jargs.items() if v is not None]
    want, vjp = jax.vjp(
        lambda *v: jax_out(**dict(jargs, **dict(zip(names, v)))),
        *(jargs[k] for k in names))
    want_grads = dict(zip(names, vjp(jnp.asarray(cot, jdt))))

    t = {k: None if v is None else
         torch.from_numpy(v).to(torch.float32 if k.startswith("ln") else dtype)
         for k, v in args.items()}
    got = mlp_train_block_fwd(t["x"], t["wfc1"], t["wfc2"], t["bfc1"],
                              t["bfc2"], t["ln_scale"], t["ln_bias"],
                              gelu_approx=gelu_approx)
    grads = mlp_train_block_bwd(
        t["x"], torch.from_numpy(cot).to(dtype), t["wfc1"], t["wfc2"],
        t["bfc1"], t["ln_scale"], t["ln_bias"], gelu_approx=gelu_approx,
        bias=True)
    assert got.dtype == dtype and grads[0].dtype == dtype

    def as_torch(j):
        return torch.from_numpy(np.array(j.astype(jnp.float32)))
    close(got, as_torch(want), dtype, elementwise=False)
    for name, g in zip(("x", "wfc1", "wfc2", "bfc1", "bfc2", "ln_scale",
                        "ln_bias"), grads):
        if name in ("ln_scale", "ln_bias") and not pre_ln:
            assert g is None
            continue
        close(g, as_torch(want_grads[name]), dtype, elementwise=False)
