"""One head a rank under tensor parallelism, on the CPU: what the card's
kernels newly take, held to the JAX package and to float64.

- The frame-axis attention pair (K4, K6) at any number of heads: the port's
  `temporal_attention_plain` and `temporal_attention_bwd_plain` (which the
  wrappers take on CPU tensors) at 1, 3 and 5 heads of 32, 64 and 128
  channels against the JAX package's `_temporal_fwd` / `_temporal_bwd`
  (its Pallas kernels in interpret mode), causal and not; atol = rtol =
  1e-4 in fp32 (the same products summed in another order, as
  tests/test_torch_temporal90.py).
- The GEMM's plain versions at GENIE_35M's tp = 8 shapes, N and K of 32
  and 96: `gemm90_plain` in the "nn", "nt" and "tn" forms with their
  epilogues and `gemm_sm90_plain` with and without bias, GELU and residual,
  against a float64 product with the kernels' rounding points (fp32 atol =
  rtol = 1e-4, as tests/test_torch_train_gemm.py).
- The shapes the wrappers check before a launch: the one GEMM predicate
  (`_util.gemm_shape_ok`, shared by `gemm_sm90` and `gemm90`) and K4/K6's
  (`temporal_attention._check_qkv`) take the new shapes and still refuse
  what the kernels refuse (N or K not a multiple of 8, head_dim 48).
- Weights across: a JAX model's parameters through `params_from_jax`,
  split by `shard_state_dict` at tp = 8 (one head of 32 a rank, GENIE_35M's
  widths) and tp = 4 (one head of 128, GENIE_138M-h128's), each rank's qkv
  shard its head of q, of k and of v, and gathered back bit for bit.

Inputs are drawn with numpy from a seed.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import _util
from tpu1x_torch.ops import spatial_block as sb
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.parallel import tensor as tp_lib

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)


# ------------------------------------------------------------ K4 and K6

@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("heads", [1, 3, 5])
def test_temporal_plain_against_jax_at_any_head_count(heads, D):
    """The forward and dq, dk, dv at (1, 4, 4, heads D), causal where heads
    + D / 32 is even, else not (both at every head count and width)."""
    from tpu1x.ops.temporal_attention import _temporal_bwd, _temporal_fwd
    C, causal = heads * D, (heads + D // 32) % 2 == 0
    rng = np.random.default_rng(heads * 1000 + D)
    q, k, v, dout = (rand(rng, 1, 4, 4, C) for _ in range(4))
    kw = dict(scale=D ** -0.5, num_heads=heads, causal=causal)
    want = _temporal_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                         interpret=True, **kw)
    want_grads = _temporal_bwd(*(jnp.asarray(a) for a in (q, k, v, dout)),
                               interpret=True, **kw)
    tq, tk_, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    close(ta.temporal_attention_plain(tq, tk_, tv, **kw), want)
    o = torch.full_like(tdo, float("nan"))
    dqkv = ta.temporal_attention_bwd_plain(tq, tk_, tv, tdo, o=o, **kw)
    close(o, want)
    for got, w in zip(dqkv.split(C, dim=-1), want_grads):
        close(got, w)


# ------------------------------------------------------------ the GEMM

M = 40  # rows: not a multiple of the tile's 128, as any M may be

# (form, N, K, epilogue) at GENIE_35M's tp = 8 products: qkv (N = 96, K =
# 256), proj (N = 256, K = 32), their "nt" backward (N = 32 / K = 96) and
# "tn" weight gradients, at N and K of 32 and 96
GEMM90_CASES = [
    ("nn", 96, 32, dict(bias=True)),
    ("nn", 32, 96, dict(bias=True, act="gelu_erf", pre_out=True)),
    ("nn", 96, 96, dict(bias=True, resid=True)),
    ("nt", 32, 96, dict()),
    ("nt", 96, 32, dict(fp32_out=True)),
    ("nt", 32, 32, dict(resid=True)),
    ("nt", 96, 96, dict(aux=True, act="dgelu_tanh")),
    ("tn", 96, 32, dict()),
    ("tn", 32, 96, dict()),
]


def float64_form(a, b, form, bias=None, resid=None, aux=None, act=None,
                 fp32_out=False, pre_out=False):
    """The training chain in float64: the exact product, + bias, the
    activation, one rounding to fp32, + resid rounded."""
    a64 = a.double().t() if form == "tn" else a.double()
    b64 = b.double().t() if form == "nt" else b.double()
    acc = a64 @ b64
    if form == "tn" or fp32_out:
        return (acc,)
    if bias is not None:
        acc = acc + bias.double()
    pre = acc
    if act == "gelu_erf":
        acc = 0.5 * acc * (1 + torch.erf(acc / 2 ** 0.5))
    elif act == "dgelu_tanh":
        x = aux.double().requires_grad_(True)
        g = 0.5 * x * (1 + torch.tanh(0.7978845608028654
                                      * (x + 0.044715 * x ** 3)))
        (d,) = torch.autograd.grad(g.sum(), x)
        acc = acc * d
    if resid is not None:
        acc = resid.double() + acc
    return (acc, pre) if pre_out else (acc,)


@pytest.mark.parametrize("form,N,K,opts", GEMM90_CASES,
                         ids=[f"{f}-N{n}-K{k}-{'-'.join(o) or 'bare'}"
                              for f, n, k, o in GEMM90_CASES])
def test_gemm90_plain_below_64_against_float64(form, N, K, opts):
    rng = np.random.default_rng(N * 7 + K)
    a = torch.from_numpy(rand(rng, *((K, M) if form == "tn" else (M, K))))
    b = torch.from_numpy(rand(rng, *((N, K) if form == "nt" else (K, N)),
                              scale=0.1))
    kw = dict(bias=torch.from_numpy(rand(rng, N, scale=0.1))
              if opts.get("bias") else None,
              resid=torch.from_numpy(rand(rng, M, N))
              if opts.get("resid") else None,
              aux=torch.from_numpy(rand(rng, M, N)) if opts.get("aux")
              else None,
              act=opts.get("act"), fp32_out=opts.get("fp32_out", False),
              pre_out=opts.get("pre_out", False))
    got = tk.gemm90_plain(a, b, form=form, **kw)
    got = got if kw["pre_out"] else (got,)
    want = float64_form(a, b, form, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (M, N)
        close(g, w)


@pytest.mark.parametrize("N,K", [(96, 32), (32, 96), (32, 32), (96, 96)])
@pytest.mark.parametrize("act", [None, "tanh", "erf"])
def test_gemm_sm90_plain_below_64_against_float64(N, K, act):
    """The serving chain at N, K of 32 and 96, with bias and residual
    (both rounded where the chain rounds: fp32 here) and without."""
    rng = np.random.default_rng(N + K)
    a = torch.from_numpy(rand(rng, M, K))
    w = torch.from_numpy(rand(rng, K, N, scale=0.1))
    bias = torch.from_numpy(rand(rng, N, scale=0.1))
    resid = torch.from_numpy(rand(rng, M, N))
    for with_bias, with_resid in ((False, False), (True, True)):
        y = a.double() @ w.double()
        if with_bias:
            y = y + bias.double()
        if act == "tanh":
            y = 0.5 * y * (1 + torch.tanh(0.7978845608028654
                                          * (y + 0.044715 * y ** 3)))
        elif act == "erf":
            y = 0.5 * y * (1 + torch.erf(y / 2 ** 0.5))
        if with_resid:
            y = resid.double() + y
        got = sb.gemm_sm90_plain(a, w, bias if with_bias else None,
                                 resid if with_resid else None, act)
        close(got, y)


# ------------------------------------------------------------ the contract

@pytest.mark.parametrize("M_,N,K,form", [
    (32768, 96, 256, "nn"), (32768, 256, 32, "nn"), (32768, 32, 256, "nt"),
    (32768, 256, 96, "nt"), (256, 96, 32768, "tn"), (32, 256, 32768, "tn"),
    (7, 8, 8, "nn"), (0, 96, 32, "nt"), (4096, 1536, 512, "nn")])
def test_gemm_shape_predicate_takes_sub_64_shapes(M_, N, K, form):
    """GENIE_35M's tp = 8 products (N and K of 32 and 96, the "tn" weight
    gradients' M of 32 and 256), the smallest N and K (8), no rows, and a
    multiple of 64 (K1's qkv) all pass the one predicate."""
    assert _util.gemm_shape_ok(M_, N, K, form)
    _util.check_gemm_shape(M_, N, K, "gemm", form)


@pytest.mark.parametrize("M_,N,K,form,message", [
    (64, 36, 64, "nn", "N % 8 == 0"), (64, 64, 20, "nt", "K % 8 == 0"),
    (12, 64, 64, "tn", "M % 8 == 0"), (64, 0, 64, "nn", "N % 8 == 0"),
    (64, 64, 0, "nt", "K % 8 == 0"), (-1, 64, 64, "nn", "N % 8 == 0")])
def test_gemm_shape_predicate_refuses(M_, N, K, form, message):
    """What TMA's 16-byte row strides refuse, refused before a launch with
    the limit named: one predicate behind both wrappers."""
    assert not _util.gemm_shape_ok(M_, N, K, form)
    with pytest.raises(ValueError, match=message):
        _util.check_gemm_shape(M_, N, K, "gemm", form)


@pytest.mark.parametrize("C,heads", [(48, 1), (144, 3), (256, 1), (96, 4)])
def test_check_qkv_refuses_other_head_widths(C, heads):
    """A head width no kernel has (48, 256, 24) is still refused, naming
    the widths there are."""
    qkv = torch.zeros(2, 8, 4, 3 * C, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32, 64, 72 or 128"):
        ta._check_qkv(*qkv.split(C, dim=-1), heads)


# ------------------------------------------------------------ weights

def jax_state_dict(heads, d_model):
    """A tiny JAX model's parameters (GENIE_35M's JSON at 2 layers, T = 4,
    with the qkv bias) at `heads` heads of d_model / heads, through
    `params_from_jax`."""
    from tpu1x.config import GenieConfig as JaxConfig
    from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
    from tpu1x_torch.config import GenieConfig
    from tpu1x_torch.weights import params_from_jax
    cut = dict(num_layers=2, T=4, num_prompt_frames=2, dtype="float32",
               remat=False, num_heads=heads, d_model=d_model,
               qkv_bias=True)
    config = ROOT / "configs" / "genie_35m.json"
    jcfg = dataclasses.replace(JaxConfig.from_pretrained(config), **cut)
    cfg = dataclasses.replace(GenieConfig.from_pretrained(config), **cut)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    tree = JaxModel(jcfg).init(jax.random.PRNGKey(3), dummy, dummy)["params"]
    return params_from_jax(jax.device_get(tree), cfg)


@pytest.mark.parametrize("tp,heads,d_model", [
    pytest.param(8, 8, 256, id="tp8-h32"),
    pytest.param(4, 4, 512, id="tp4-h128")])
def test_jax_weights_split_one_head_a_rank(tp, heads, d_model):
    """Each rank's qkv shard (weight and bias) is its one head of q, of k
    and of v, its proj shard that head's columns, its fc2 shard hidden /
    tp columns; the shards gather back to the whole state dict bit for
    bit."""
    sd = jax_state_dict(heads, d_model)
    D = d_model // heads
    shards = [tp_lib.shard_state_dict(sd, r, tp, heads) for r in range(tp)]
    whole = tp_lib.gather_state_dict(shards, heads)
    assert set(whole) == set(sd)
    assert all(torch.equal(whole[k], v) for k, v in sd.items())
    for attn in ("spatial_attn", "temporal_attn"):
        pre = f"decoder.layers.1.{attn}"
        w, b = sd[f"{pre}.qkv.weight"], sd[f"{pre}.qkv.bias"]
        for r in range(tp):
            got = shards[r][f"{pre}.qkv.weight"]
            assert got.shape == (3 * D, d_model)
            assert torch.equal(got, w.view(3, heads, D, d_model)[:, r]
                               .reshape(3 * D, d_model))
            assert torch.equal(shards[r][f"{pre}.qkv.bias"],
                               b.view(3, heads, D)[:, r].reshape(-1))
            assert torch.equal(shards[r][f"{pre}.proj.weight"],
                               sd[f"{pre}.proj.weight"][:, r * D:(r + 1) * D])
            assert shards[r]["decoder.layers.1.mlp.fc2.weight"].shape == \
                (d_model, 4 * d_model // tp)
