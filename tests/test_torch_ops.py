"""Per-module parity of the PyTorch port (tpu1x_torch) with the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX function
and the port's counterpart in fp32 on the CPU. Where the JAX function is a
Pallas kernel it runs in interpret mode, as the JAX package's own tests run
it; the port's wrapper takes its plain version because its tensors lie on
the CPU. Tolerance: atol 1e-4, rtol 1e-4 (fp32, sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x_torch import kernels
from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models import factorization as tfact
from tpu1x_torch.models.st_maskgit import STMaskGIT, cosine_schedule, update_cache
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops import decode_attention as tdec
from tpu1x_torch.ops.layernorm import layer_norm
from tpu1x_torch.ops.spatial_block import spatial_block
from tpu1x_torch.ops.temporal_attention import temporal_attention
from tpu1x_torch.ops.temporal_mlp_block import (temporal_mlp_block,
                                                temporal_mlp_block_pair)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("name", ["genie_35m.json", "genie_138m.json"])
def test_config_json_loads(name):
    from tpu1x.config import GenieConfig as JaxConfig
    path = f"configs/{name}"
    got, want = GenieConfig.from_pretrained(path), JaxConfig.from_pretrained(path)
    for f in ("num_layers", "num_heads", "d_model", "T", "S", "qk_norm",
              "factored_vocab_size", "num_factored_vocabs", "dtype"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.mask_token_id == want.mask_token_id


@pytest.mark.parametrize("name", ["tiny", "genie_35m", "genie_138m"])
def test_model_zoo(name):
    from tpu1x.model_zoo import MODEL_ZOO as JAX_ZOO
    from tpu1x_torch.model_zoo import MODEL_ZOO
    got, want = MODEL_ZOO[name](), JAX_ZOO[name]()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_factorize_and_embed():
    from tpu1x.models.factorization import factorize_token_ids
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512 ** 2, (3, 7)).astype(np.int32)
    want = np.asarray(factorize_token_ids(jnp.asarray(ids), 2, 512))
    got = tfact.factorize_token_ids(t(ids).long(), 2, 512)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal((got[..., 0] + 512 * got[..., 1]).numpy(), ids)
    # the embedding sums digit rows and substitutes the mask embedding
    tabs = [t(rand(rng, 8, 4)), t(rand(rng, 8, 4))]
    mask_embed = t(rand(rng, 4))
    ids = t(np.array([[0, 9, 63, 64]])).long()
    e = tfact.factored_embed(tabs, mask_embed, ids, 64)
    close(e[0, 1], tabs[0][1] + tabs[1][1])
    close(e[0, 2], tabs[0][7] + tabs[1][7])
    close(e[0, 3], mask_embed)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference(causal):
    from tpu1x.ops.attention import mha_reference
    rng = np.random.default_rng(1)
    q, k, v = (rand(rng, 2, 5, 9, 3, 8) for _ in range(3))
    want = mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=0.3, causal=causal)
    got = tattn.mha_reference(t(q), t(k), t(v), scale=0.3, causal=causal)
    close(got, want)


@pytest.mark.parametrize(
    "rows,C", [(24, 128), (13, 128), (24, 256), (24, 512), (24, 2048),
               (1, 512)],
    ids=["24", "13", "24-C256", "24-C512", "24-C2048", "1-C512"])
def test_layer_norm(rows, C):
    """rows=13 and the single row take the JAX reference (rows % 8); the
    port has no such rule, the kernel takes any row count. C = 256, 512 and
    2048 are 1, 2 and 8 chunks of 8 channels a lane, the card kernel's
    smallest, the GENIE widths' and its largest instantiation."""
    from tpu1x.ops.layernorm import layer_norm as jax_layer_norm
    rng = np.random.default_rng(2)
    x = rand(rng, rows, C, scale=2.0) + 0.5
    g, b = rand(rng, C, scale=0.1) + 1.0, rand(rng, C, scale=0.1)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          interpret=True)
    close(layer_norm(t(x), t(g), t(b)), want)


def spatial_inputs(rng, N, S, C, qkv_bias, proj_bias):
    kw = dict(x=rand(rng, N, S, C, scale=0.5),
              wqkv=rand(rng, C, 3 * C, scale=0.05),
              wproj=rand(rng, C, C, scale=0.05),
              ln_scale=1.0 + rand(rng, C, scale=0.1),
              ln_bias=rand(rng, C, scale=0.1))
    if qkv_bias:
        kw["bqkv"] = rand(rng, 3 * C, scale=0.1)
    if proj_bias:
        kw["bproj"] = rand(rng, C, scale=0.1)
    return kw


@pytest.mark.parametrize("qkv_bias,proj_bias,H,C", [
    pytest.param(False, True, 2, 64, id="False-True"),
    pytest.param(True, False, 2, 64, id="True-False"),
    pytest.param(False, True, 1, 64, id="False-True-h64"),
    pytest.param(False, True, 1, 128, id="False-True-h128")])
def test_spatial_block(qkv_bias, proj_bias, H, C):
    """K1 with the pre-LN against the JAX kernel; H = 1 at C = 64 and 128
    is head_dim 64 and 128, the card kernel's other head widths."""
    from tpu1x.ops.spatial_block import spatial_block as jax_spatial_block
    rng = np.random.default_rng(3)
    N, S = 3, 32
    kw = spatial_inputs(rng, N, S, C, qkv_bias, proj_bias)
    scale = (C // H) ** -0.5
    want = jax_spatial_block(num_heads=H, scale=scale, interpret=True,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = spatial_block(num_heads=H, scale=scale,
                        **{k: t(v) for k, v in kw.items()})
    close(got, want)


@pytest.mark.parametrize("T", [4, 7])
def test_temporal_attention(T):
    from tpu1x.ops.temporal_attention import temporal_attention as jax_ta
    rng = np.random.default_rng(4)
    B, S, C, H = 2, 16, 64, 2
    q, k, v = (rand(rng, B, T, S, C) for _ in range(3))
    want = jax_ta(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.2,
                  num_heads=H, causal=True, interpret=True)
    got = temporal_attention(t(q), t(k), t(v), scale=0.2, num_heads=H)
    close(got, want)


def test_decode_attention_references():
    from tpu1x.ops import decode_attention as jdec
    rng = np.random.default_rng(5)
    B, S, C, H, T = 3, 8, 64, 2, 5
    q, kc_, vc_, qc, kp, vp = (rand(rng, B, S, C) for _ in range(6))
    kcache, vcache = rand(rng, T, B, S, C), rand(rng, T, B, S, C)
    tB = np.array([0, 2, 4], np.int32)
    args = (q, kcache, vcache, kp, vp)
    want = jdec.temporal_decode_attention_reference(
        *map(jnp.asarray, args), jnp.asarray(tB), scale=0.3, num_heads=H)
    got = tdec.temporal_decode_attention_reference(
        *map(t, args), t(tB), scale=0.3, num_heads=H)
    close(got, want)
    args2 = (q, qc, kcache, vcache, kp, vp, kc_, vc_)
    want2 = jdec.temporal_decode2_attention_reference(
        *map(jnp.asarray, args2), jnp.asarray(tB), scale=0.3, num_heads=H)
    got2 = tdec.temporal_decode2_attention_reference(
        *map(t, args2), t(tB), scale=0.3, num_heads=H)
    for g, w in zip(got2, want2):
        close(g, w)


def block_weights(rng, C, F4, qkv_bias, mlp_bias):
    w = dict(wqkv=rand(rng, C, 3 * C, scale=0.05), wproj=rand(rng, C, C, scale=0.05),
             wfc1=rand(rng, C, F4, scale=0.05), wfc2=rand(rng, F4, C, scale=0.05),
             ln_scale=1.0 + rand(rng, C, scale=0.1), ln_bias=rand(rng, C, scale=0.1),
             bproj=rand(rng, C, scale=0.1))
    if qkv_bias:
        w["bqkv"] = rand(rng, 3 * C, scale=0.1)
    if mlp_bias:
        w["bfc1"] = rand(rng, F4, scale=0.1)
        w["bfc2"] = rand(rng, C, scale=0.1)
    return w


# (C, heads): the small width, and GENIE_35M's C=256 with 8 heads of 32
# channels, the narrowest width the card's kernels take (ids of the small
# width as before the wide cases existed)
@pytest.mark.parametrize("qkv_bias,mlp_bias,gelu_tanh,C,H", [
    pytest.param(False, True, True, 64, 2, id="False-True-True"),
    pytest.param(True, False, False, 64, 2, id="True-False-False"),
    pytest.param(False, True, True, 256, 8, id="C256-tanh"),
    pytest.param(True, True, False, 256, 8, id="C256-erf"),
    pytest.param(False, True, True, 256, 4, id="h64-tanh"),
    pytest.param(False, True, True, 256, 2, id="h128-tanh")])
def test_temporal_mlp_block_single(qkv_bias, mlp_bias, gelu_tanh, C, H):
    from tpu1x.ops.temporal_mlp_block import temporal_mlp_block as jax_tmb
    rng = np.random.default_rng(6)
    B, S, T, L, layer = 2, 32, 8, 3, 1
    w = block_weights(rng, C, 4 * C, qkv_bias, mlp_bias)
    x = rand(rng, B, S, C, scale=0.5)
    kc, vc = rand(rng, T, L, B, S, C, scale=0.5), rand(rng, T, L, B, S, C, scale=0.5)
    tB = np.array([3, 5], np.int32)
    scale = (C // H) ** -0.5
    want = jax_tmb(jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                   jnp.asarray(tB), layer=layer, scale=scale, num_heads=H,
                   gelu_tanh=gelu_tanh, tile_s=16, interpret=True,
                   **{k: jnp.asarray(v) for k, v in w.items()})
    got = temporal_mlp_block(t(x), t(kc), t(vc), t(tB), layer=layer,
                             scale=scale, num_heads=H, gelu_tanh=gelu_tanh,
                             **{k: t(v) for k, v in w.items()})
    for g, wnt in zip(got, want):
        close(g, wnt)


@pytest.mark.parametrize("layer,t_prev,C,H,gelu_tanh", [
    pytest.param(2, (2, 6), 64, 2, True, id="2-t_prev0"),
    pytest.param(0, (0, 7), 64, 2, True, id="0-t_prev1"),
    pytest.param(1, (3, 6), 256, 8, True, id="C256-tanh"),
    pytest.param(2, (0, 5), 256, 8, False, id="C256-erf"),
    pytest.param(1, (3, 6), 256, 4, False, id="h64-erf"),
    pytest.param(1, (3, 6), 256, 2, False, id="h128-erf")])
def test_temporal_mlp_block_pair(layer, t_prev, C, H, gelu_tanh):
    from tpu1x.ops.temporal_mlp_block import temporal_mlp_block_pair as jax_pair
    rng = np.random.default_rng(7)
    B, S, T, L = 2, 32, 8, 3
    w = block_weights(rng, C, 4 * C, False, True)
    z = rand(rng, B, 2, S, C, scale=0.5)
    kc, vc = rand(rng, T, L, B, S, C, scale=0.5), rand(rng, T, L, B, S, C, scale=0.5)
    tB = np.array(t_prev, np.int32)
    scale = (C // H) ** -0.5
    want = jax_pair(jnp.asarray(z), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(tB), layer=layer, scale=scale, num_heads=H,
                    gelu_tanh=gelu_tanh, tile_s=16, interpret=True,
                    **{k: jnp.asarray(v) for k, v in w.items()})
    got = temporal_mlp_block_pair(t(z), t(kc), t(vc), t(tB), layer=layer,
                                  scale=scale, num_heads=H,
                                  gelu_tanh=gelu_tanh,
                                  **{k: t(v) for k, v in w.items()})
    for g, wnt in zip(got, want):
        close(g, wnt)


@pytest.mark.parametrize("pair", [False, True])
def test_temporal_mlp_block_kv_out(pair):
    """k/v written into a layer of a stack, or not kept: the same output."""
    rng = np.random.default_rng(9)
    B, S, C, H, T, L, layer = 2, 8, 64, 2, 4, 3, 1
    w = {k: t(v) for k, v in block_weights(rng, C, 4 * C, True, True).items()}
    x = t(rand(rng, B, 2, S, C) if pair else rand(rng, B, S, C))
    kc, vc = t(rand(rng, T, L, B, S, C)), t(rand(rng, T, L, B, S, C))
    tB = t(np.array([1, 3], np.int32))
    fn = temporal_mlp_block_pair if pair else temporal_mlp_block
    kw = dict(layer=layer, scale=0.25, num_heads=H, **w)
    y, k, v = fn(x, kc, vc, tB, **kw)
    stack = torch.zeros(2, L, B, S, C), torch.zeros(2, L, B, S, C)
    out = fn(x, kc, vc, tB, kv_out=(stack[0][0, layer], stack[1][0, layer]),
             **kw)
    assert torch.equal(out[0], y)
    assert out[1].data_ptr() == stack[0][0, layer].data_ptr()
    assert torch.equal(stack[0][0, layer], k) and torch.equal(stack[1][0, layer], v)
    assert not stack[0][1].any() and not stack[0][0, 0].any()
    y2, k2, v2 = fn(x, kc, vc, tB, return_kv=False, **kw)
    assert torch.equal(y2, y) and k2 is None and v2 is None


def test_cosine_schedule_and_update_cache():
    from tpu1x.models import st_maskgit as jsm
    for u in (0.0, 0.25, 0.5, 1.0):
        assert cosine_schedule(u) == jsm.cosine_schedule(u)
    rng = np.random.default_rng(8)
    k, v = rand(rng, 4, 2, 3, 5, 8), rand(rng, 4, 2, 3, 5, 8)
    kn, vn = rand(rng, 1, 2, 3, 5, 8), rand(rng, 1, 2, 3, 5, 8)
    want = jsm.update_cache({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                            (jnp.asarray(kn), jnp.asarray(vn)), 2)
    cache = {"k": t(k.copy()), "v": t(v.copy())}
    got = update_cache(cache, (t(kn), t(vn)), 2)
    assert got is cache  # in place
    close(got["k"], want["k"])
    close(got["v"], want["v"])


def test_sampler_frame_update_greedy():
    from tpu1x.models.sampler import _frame_update as jax_frame_update
    from tpu1x.model_zoo import genie_tiny as jax_tiny
    from tpu1x_torch.model_zoo import genie_tiny
    from tpu1x_torch.models.sampler import _frame_update
    cfg, jcfg = genie_tiny(), jax_tiny()
    rng = np.random.default_rng(9)
    B, S, V, F = 3, cfg.S, cfg.factored_vocab_size, cfg.num_factored_vocabs
    logits = rand(rng, B, S, V, F, scale=3.0)
    frame = rng.integers(0, cfg.image_vocab_size, (B, S))
    unmasked = rng.random((B, S)) < 0.3
    frame = np.where(unmasked, frame, cfg.mask_token_id)
    for step, steps, n in ((0, 2, [7]), (1, 2, [7]), (0, 3, [12, 5])):
        want = jax_frame_update(jnp.asarray(frame, jnp.int32),
                                jnp.asarray(unmasked), jnp.asarray(logits),
                                step, steps, n, jax.random.PRNGKey(0), jcfg,
                                0.0, "greedy")
        got = _frame_update(t(frame).long(), t(unmasked), t(logits), step,
                            steps, n, None, cfg, 0.0, "greedy")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_model_names_match_reference_state_dict():
    """The port's parameter names are the reference's torch names, as the
    JAX package's converter writes them."""
    from tpu1x.model_zoo import genie_tiny as jax_tiny
    from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
    from tpu1x.train.checkpoint import convert_to_torch_state_dict
    from tpu1x_torch.model_zoo import genie_tiny
    for qk_norm, qkv_bias in ((False, False), (True, True)):
        jcfg = jax_tiny(qk_norm=qk_norm, qkv_bias=qkv_bias)
        dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
        params = JaxModel(jcfg).init(jax.random.PRNGKey(0), dummy, dummy)
        want = convert_to_torch_state_dict(params["params"], jcfg)
        got = STMaskGIT(genie_tiny(qk_norm=qk_norm, qkv_bias=qkv_bias)
                        ).state_dict()
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k

