"""d_model past 2048 through both packages on the CPU.

Past 2048 channels the card's LN row passes take a pair of warps a row
(K5's row pass, which K1's pre-LN and K2's and K3's LN2 are, and the
training LN rows of K11 and K13), and the decode ring's items a group of
whole heads of their tokens; the port's plain versions, which the wrappers
take on CPU tensors, have no width limit, as the JAX package has none.
Each case holds the port's plain path against the JAX package (its Pallas
kernels in interpret mode), the inputs drawn with numpy from a seed:

- K5 `layer_norm` at C = 3072 and 4096 against the JAX kernel, fp32, atol
  = rtol = 1e-4 (tests/test_torch_ops.py's tolerance: the same sums in
  another order);
- K13 with its LN at C = 3072 and 4096, the output and every gradient
  (tests/test_torch_widths.py's `mlp_ln_rows_case`: atol = rtol = 1e-4 for
  values, atol 2e-4 + rtol 1e-3 for sums over the rows);
- K11's backward with LN1 at C = 3072 in 48 heads of 64
  (`spatial_ln_rows_case`, the same tolerances);
- GENIE_138M-C3072 (configs/genie_138m.json at d_model 3072 in 48 heads of
  64, CogVideoX-5B's width and head split) at 1 layer, S = 16, T = 2: the
  weights carried across by `params_from_jax`, the logits and the loss
  (atol 2e-4, rtol 2e-3; 1e-5);
- the contract: every widened wrapper's check refuses C = 4128, naming the
  one limit `_util.MAX_C`.

K7 and K8 at C = 3072 (48 heads of 64) and 4096 (32 of 128) on both caches
against the JAX decode kernels are the `1-C3072` and `1-C4096` ids of
tests/test_torch_decode90.py; the width rule over the new widths is
tests/test_torch_widths.py's `test_decode_width_rule_takes`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_widths import (build, logits_and_loss, mlp_ln_rows_case,
                               spatial_ln_rows_case)
from tpu1x_torch import kernels
from tpu1x_torch.ops import _util
from tpu1x_torch.ops import decode_attention as tdec
from tpu1x_torch.ops import spatial_block as sb
from tpu1x_torch.ops.layernorm import layer_norm

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
# GENIE_138M-C3072 at one layer
C3072 = dict(d_model=3072, num_heads=48, num_layers=1, S=16, T=2,
             num_prompt_frames=1, dtype="float32", remat=False)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("rows,C", [(13, 3072), (5, 4096)],
                         ids=["13-C3072", "5-C4096"])
def test_layer_norm_past_2048(rows, C):
    """K5 at 6 and 8 chunks of 8 channels a lane of a pair of warps on the
    card; 13 rows take the JAX reference (rows % 8), 5 a row count that the
    card's pairs of a block (four) do not divide."""
    from tpu1x.ops.layernorm import layer_norm as jax_layer_norm
    rng = np.random.default_rng(C)
    x = rand(rng, rows, C, scale=2.0) + 0.5
    g, b = rand(rng, C, scale=0.1) + 1.0, rand(rng, C, scale=0.1)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          interpret=True)
    got = layer_norm(*map(torch.from_numpy, (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C", [3072, 4096])
def test_mlp_train_block_ln_rows_past_2048(C):
    """K13 with its LN at C = 3072 and 4096 (6 and 8 chunks a lane of a
    pair of warps on the card): the output and the gradient of x, both
    weights, both biases, the LN scale and bias."""
    mlp_ln_rows_case(C)


def test_spatial_train_block_ln_rows_at_c3072():
    """K11's backward with LN1 at C = 3072 in 48 heads of 64: the gradient
    of x, both weights, the proj bias, the LN scale and bias, and the value
    through K1's forward."""
    spatial_ln_rows_case(3072, 48, 8)


def test_c3072_weights_across_and_logits():
    """48 heads of 64: every JAX parameter reaches the port's module by
    `params_from_jax`, the qkv product's columns in the heads' order, and
    the two models agree on the logits and the loss."""
    m = build(C3072, 9)
    cfg = m["cfg"]
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim) == (3072, 48, 64)
    state = m["model"].state_dict()
    assert tuple(state["decoder.layers.0.spatial_attn.qkv.weight"].shape
                 ) == (3 * 3072, 3072)
    logits_and_loss(m, 10)


def test_wrappers_refuse_past_the_limit():
    """C = 4128 (129 heads of 32) is refused by every check that a widened
    wrapper makes before a launch, each naming MAX_C: the LN rows' (K5, the
    training LN rows), the decode ring's (K7, K8, K2, K3), and K1's with its
    pre-LN (at 4160, since K1 asks C % 64 == 0 first); 4096 is taken by
    each."""
    C = _util.MAX_C + 32
    for what in ("layer_norm kernel", "the LayerNorm row pass"):
        _util.check_width(_util.MAX_C, what)
        with pytest.raises(ValueError, match=r"C <= 4096 \(MAX_C\)"):
            _util.check_width(C, what)
    # K1's wrapper first asks C % 64 == 0: 4160, 130 heads of 32
    for width, taken in ((_util.MAX_C, True), (_util.MAX_C + 64, False)):
        bf, f32 = torch.bfloat16, torch.float32
        kw = dict(x=torch.zeros(1, 64, width, dtype=bf),
                  wqkv=torch.zeros(width, 3 * width, dtype=bf),
                  wproj=torch.zeros(width, width, dtype=bf),
                  num_heads=width // 32,
                  ln_scale=torch.ones(width, dtype=f32),
                  ln_bias=torch.zeros(width, dtype=f32))
        if taken:
            assert sb._check(**kw) == 32
        else:
            with pytest.raises(ValueError, match=r"C <= 4096 \(MAX_C\)"):
                sb._check(**kw)
    assert _util.check_decode_width(_util.MAX_C, 32, "k") == 128
    with pytest.raises(ValueError, match=r"C <= 4096 at head_dim 32"):
        _util.check_decode_width(C, C // 32, "decode attention kernel")
    # the decode ring's own contract check names the same limit
    L_, B_, S_, T_ = 2, 1, 4, 2
    qkv = torch.zeros(B_, 1, S_, 3 * C, dtype=torch.bfloat16)
    q, k, v = (x.unbind(1) for x in qkv.split(C, dim=-1))
    kc = torch.zeros(T_, L_, B_, S_, C, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"C <= 4096"):
        tdec._check(qs=q, ks=k, vs=v, k_cache=kc, v_cache=kc.clone(),
                    t_B=torch.zeros(B_, dtype=torch.int32), layer=1,
                    k_scale=None, v_scale=None, out=None, kv_out=None,
                    num_heads=C // 32)
