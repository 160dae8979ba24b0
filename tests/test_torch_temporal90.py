"""The temporal attention pair (K4 forward, K6 backward) as the train
block's backward now calls it, on the CPU: `temporal_attention_bwd_plain`
writing the forward's output `o` beside dq, dk, dv, against the JAX
package's `temporal_attention` (its Pallas kernels in interpret mode) and
`jax.vjp`, at T = 8 and 16, causal and not; `temporal_train_block_bwd`,
whose one attention launch is now that backward with `o`, against
`jax.vjp` of the JAX package's `temporal_train_block`; and the contract
the CUDA kernels check before a launch (`_check_qkv`).

Inputs are drawn with numpy from a seed. Tolerance: atol = rtol = 1e-4 in
fp32 (the same products, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x_torch import kernels
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.ops import temporal_train_block as ttb

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, C, H = 2, 8, 64, 2


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,H_,C_", [pytest.param(8, H, C, id="8"),
                                     pytest.param(16, H, C, id="16"),
                                     pytest.param(16, 1, C, id="16-h64"),
                                     pytest.param(16, 1, 2 * C,
                                                  id="16-h128")])
def test_backward_with_o_against_jax(T, H_, C_, causal):
    """dq, dk, dv against `jax.vjp` of the JAX kernel, and `o` against its
    value; `o` leaves the gradients as they are without it. H_ = 1 at C =
    64 and 128: head_dim 64 and 128, the kernels' other head widths."""
    from tpu1x.ops.temporal_attention import temporal_attention as jax_fn
    rng = np.random.default_rng(T + causal)
    q, k, v, dout = (rand(rng, B, T, S, C_) for _ in range(4))
    kw = dict(scale=(C_ // H_) ** -0.5, num_heads=H_, causal=causal)
    want, vjp = jax.vjp(lambda *a: jax_fn(*a, interpret=True, **kw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    o = torch.full_like(tdo, float("nan"))
    dqkv = ta.launch_backward(tq, tk, tv, tdo, o=o, **kw)
    assert dqkv.shape == (B, T, S, 3 * C_)
    close(o, want)
    for got, w in zip(dqkv.split(C_, dim=-1), want_grads):
        close(got, w)
    assert torch.equal(dqkv, ta.launch_backward(tq, tk, tv, tdo, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_backward_o_equals_forward(causal):
    """The `o` the backward writes is the forward's output exactly, in bf16
    as on the card (q, k, v the thirds of one qkv tensor)."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rand(rng, B, 8, S, 3 * C)).bfloat16()
    q, k, v = qkv.split(C, dim=-1)
    dout = torch.from_numpy(rand(rng, B, 8, S, C)).bfloat16()
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, causal=causal)
    o = torch.empty_like(dout)
    ta.launch_backward(q, k, v, dout, o=o, **kw)
    assert torch.equal(o, ta.launch_forward(q, k, v, **kw))


@pytest.mark.parametrize("T", [8, 16])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_train_block_backward_against_jax(T, qkv_bias, monkeypatch):
    """`temporal_train_block_bwd` launches the attention backward once,
    with `o`, and no attention forward; its gradients against `jax.vjp` of
    the JAX package's `temporal_train_block`."""
    from tpu1x.ops.temporal_train_block import temporal_train_block as jax_fn
    rng = np.random.default_rng(11 + T)
    args = dict(x=rand(rng, B, T, S, C), wqkv=rand(rng, C, 3 * C, scale=0.05),
                wproj=rand(rng, C, C, scale=0.05),
                bqkv=rand(rng, 3 * C, scale=0.02) if qkv_bias else None,
                bproj=rand(rng, C, scale=0.02))
    cot = rand(rng, B, T, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    names = [n for n, a in args.items() if a is not None]
    _, vjp = jax.vjp(
        lambda *a: jax_fn(interpret=True, **kw, **dict(zip(names, a))),
        *(jnp.asarray(args[n]) for n in names))
    want = dict(zip(names, vjp(jnp.asarray(cot))))

    calls = []
    backward = ta.launch_backward

    def counted(*a, **k):
        calls.append(k.get("o") is not None)
        return backward(*a, **k)

    def no_forward(*a, **k):
        raise AssertionError("the backward launched the attention forward")
    monkeypatch.setattr(ta, "launch_backward", counted)
    monkeypatch.setattr(ta, "launch_forward", no_forward)
    t = {n: None if a is None else torch.from_numpy(a)
         for n, a in args.items()}
    grads = ttb.temporal_train_block_bwd(
        t["x"], torch.from_numpy(cot), t["wqkv"], t["wproj"], t["bqkv"],
        proj_bias=True, **kw)
    assert calls == [True]
    for name, g in zip(("x", "wqkv", "wproj", "bqkv", "bproj"), grads):
        if args[name] is None:
            assert g is None
            continue
        close(g, want[name])


@pytest.mark.parametrize("T,C_,thirds", [(8, 256, True), (16, 512, True),
                                          (16, 256, False), (5, 512, False),
                                          (16, 64, True), (8, 64, False),
                                          (16, 192, True)])
def test_check_qkv_takes_both_callers_layouts(T, C_, thirds):
    """The kernels' contract takes q, k, v as the thirds of one (B, T, S,
    3C) qkv tensor (row stride 3C, as both callers pass them) or as
    contiguous tensors (row stride C), at the prefill's T = 8 and the train
    step's T = 16, at C = 256 and 512 (head_dim 32), and at C = 64 with 2
    heads (a rank's share of GENIE_35M at tp = 4) and C = 192 with 6 (head
    groups of 2)."""
    g = torch.Generator().manual_seed(T + C_)
    if thirds:
        q, k, v = torch.randn(2, T, 4, 3 * C_, generator=g).bfloat16().split(
            C_, dim=-1)
    else:
        q, k, v = (torch.randn(2, T, 4, C_, generator=g).bfloat16()
                   for _ in range(3))
    assert ta._check_qkv(q, k, v, C_ // 32) == (3 * C_ if thirds else C_)


def _refused(case):
    """q, k, v and the head count of one shape the kernels refuse."""
    C_, T, H_ = 256, 8, 8
    qkv = torch.zeros(2, T, 4, 3 * C_, dtype=torch.bfloat16)
    q, k, v = qkv.split(C_, dim=-1)
    if case == "fp32":
        q = q.float()
    elif case == "shapes":
        k = k[:, :4]
    elif case == "T > 32":
        q, k, v = torch.zeros(3, 2, 33, 4, C_, dtype=torch.bfloat16).unbind(0)
    elif case == "head_dim 256":
        H_ = 1
    elif case == "C % 256":
        q, k, v = torch.zeros(3, 2, T, 4, 96,
                              dtype=torch.bfloat16).unbind(0)
        H_ = 3
    elif case == "one head":  # an odd number of heads: no head group
        q, k, v = torch.zeros(3, 2, T, 4, 32,
                              dtype=torch.bfloat16).unbind(0)
        H_ = 1
    elif case == "frame stride":  # frames and positions swapped
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    elif case == "row stride % 8":
        q, k, v = torch.zeros(2, T, 4, 3 * C_ + 4,
                              dtype=torch.bfloat16)[..., :3 * C_].split(
                                  C_, dim=-1)
    elif case == "alignment":
        q, k, v = torch.zeros(2, T, 4, 3 * C_ + 8,
                              dtype=torch.bfloat16)[..., 4:4 + 3 * C_].split(
                                  C_, dim=-1)
    return q, k, v, H_


@pytest.mark.parametrize("case,message", [
    ("fp32", "bf16"), ("shapes", "one shape"), ("T > 32", "T <= 32"),
    ("head_dim 256", "head_dim 32, 64 or 128"), ("C % 256", "C % 256"),
    ("one head", "C % 64 == 0"),
    ("frame stride", "strides"), ("row stride % 8", "multiple of 8"),
    ("alignment", "16-byte aligned")])
def test_check_qkv_refuses(case, message):
    """Every shape, dtype, stride or alignment the kernels do not take
    raises before a launch, for that reason, with no fallback."""
    q, k, v, heads = _refused(case)
    with pytest.raises(ValueError, match=message):
        ta._check_qkv(q, k, v, heads)
