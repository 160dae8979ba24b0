"""The port's op-by-op serving path against the JAX package on the CPU: the
qk_norm=True model, the int8 KV cache, and both together; and both
together at head_dim 64 (d_model 128, 2 heads).

As tests/test_torch_serving.py: genie_tiny(T=4, num_prompt_frames=2,
num_heads=2, d_model=32) in fp32, weights drawn with numpy from a seed, the
JAX DecodeEngine with attn_impl="pallas" (its decode attention and spatial
block kernels in interpret mode; the engine calls the decode attention
kernels without the flag, so the fixture binds it for the module's
duration) against the port's DecodeEngine on the CPU, where every op takes
its plain version. Tolerances: a compute-dtype prefill
cache atol 1e-4; an int8 prefill cache within one step per value (the two
packages sum in another order before they round), its scales rtol 1e-5;
decode logits and k/v on the same cache atol 2e-4, rtol 2e-3; greedy rollout
tokens exact.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu1x.serving as jax_serving
from tpu1x.model_zoo import genie_tiny as jax_tiny
from tpu1x.models.sampler import generate_cached_fused as jax_fused
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.ops import decode_attention as jdec
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.ops.decode_attention import dequantize_kv
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
SIZE = dict(T=4, num_prompt_frames=2, num_heads=2, d_model=32)
B = 2
# (qk_norm, cache dtype, widths other than SIZE's): the last two at head_dim
# 64 and 128, the card kernels' other head widths, both at d_model 128 (at
# 256 this file's weight scales put the logits near 5e3, where fp32
# summation order alone parts the packages by 1e-3)
COMBOS = {"qk_norm": (True, "bf16", {}), "int8": (False, "int8", {}),
          "qk_norm-int8": (True, "int8", {}),
          "qk_norm-int8-h64": (True, "int8", dict(d_model=128)),
          "qk_norm-int8-h128": (True, "int8", dict(d_model=128,
                                                   num_heads=1))}


def random_tree(tree, seed):
    """Replace every leaf with numpy draws; large head and embedding scales
    keep the logits far from uniform, so that greedy argmax has clear
    winners."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = np.shape(leaf)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "out_x_proj" in name:
            s = 0.3
        elif "embed" in name:
            s = 1.0
        elif name.endswith("bias"):
            s = 0.05
        else:
            s = 0.1
        return (s * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module", params=list(COMBOS))
def tiny(request):
    qk_norm, cache_dtype, widths = COMBOS[request.param]
    size = dict(SIZE, **widths)
    jcfg = jax_tiny(**size, qk_norm=qk_norm)
    cfg = genie_tiny(**size, qk_norm=qk_norm)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    tree = JaxModel(jcfg).init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    np_params = random_tree(jax.device_get(tree), 0)
    jsp = jax_prepare(jax.tree_util.tree_map(jnp.asarray, np_params),
                      compute_dtype=jnp.float32)
    with warnings.catch_warnings():  # qk_norm: "takes the per-op path"
        warnings.simplefilter("ignore")
        jeng = JaxEngine(jcfg, attn_impl="pallas", compute_dtype=jnp.float32,
                         cache_dtype=cache_dtype)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    sp = prepare_serving_params(model, cfg, compute_dtype=torch.float32,
                                device="cpu")
    eng = DecodeEngine(cfg, device="cpu", cache_dtype=cache_dtype)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.image_vocab_size, (B, 2, 4, 4)).astype(
        np.int32)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("temporal_decode_attention",
                     "temporal_decode2_attention"):
            mp.setattr(jax_serving, name, functools.partial(
                getattr(jdec, name), interpret=True))
        yield dict(jcfg=jcfg, cfg=cfg, jsp=jsp, jeng=jeng, model=model, sp=sp,
                   eng=eng, prompt=prompt, int8=cache_dtype == "int8",
                   cache_dtype=cache_dtype)


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def t(a):
    return torch.from_numpy(np.array(a))


def test_serving_params_carry_the_qk_ln(tiny):
    for lp in tiny["sp"]["layers"]:
        for name in ("spatial_attn", "temporal_attn"):
            assert ("norm" in lp[name]) == tiny["cfg"].qk_norm
            if tiny["cfg"].qk_norm:
                assert lp[name]["norm"]["scale"].dtype == torch.float32
                assert tuple(lp[name]["norm"]["bias"].shape) == (
                    tiny["cfg"].head_dim,)
        assert ("norm1" in lp) == (not tiny["cfg"].qk_norm)


def test_prefill_cache_matches_jax(tiny):
    want = tiny["jeng"].prefill(tiny["jsp"], jnp.asarray(tiny["prompt"]))
    got = tiny["eng"].prefill(tiny["sp"], t(tiny["prompt"]).long())
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
    if not tiny["int8"]:
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=1e-4, rtol=0)
        assert not got["k"][2:].any()  # slots past the prompt stay zero
        return
    for key in ("k", "v"):
        assert got[key].dtype == torch.int8
        scale, wscale = got[key + "_scale"], np.asarray(want[key + "_scale"])
        assert scale.dtype == torch.float32
        np.testing.assert_allclose(scale.numpy(), wscale, rtol=1e-5)
        diff = got[key].numpy().astype(np.int32) - np.asarray(want[key])
        assert np.abs(diff).max() <= 1, key
        assert (diff != 0).mean() < 0.01, key
        # dequantized: within one step of the token's scale
        deq = dequantize_kv(got[key], scale.permute(2, 0, 1, 3))
        wdeq = np.asarray(want[key]).astype(np.float32) * np.transpose(
            wscale, (2, 0, 1, 3))[..., None]
        np.testing.assert_allclose(deq.numpy(), wdeq,
                                   atol=1.01 * float(scale.max()), rtol=0)
        assert not got[key][2:].any() and (scale[:, :, 2:] == 1).all()


def test_decode_frame_and_pair_match_jax(tiny):
    cfg = tiny["cfg"]
    jcache = tiny["jeng"].prefill(tiny["jsp"], jnp.asarray(tiny["prompt"]))
    cache = {k: t(np.asarray(v)).clone() for k, v in jcache.items()}
    rng = np.random.default_rng(2)
    frame = rng.integers(0, cfg.image_vocab_size, (B, cfg.S))
    frame[:, :5] = cfg.mask_token_id
    masked = np.full((B, cfg.S), cfg.mask_token_id)
    tB = np.array([2, 1], np.int32)  # mixed frame index across the batch
    tol = dict(atol=2e-4, rtol=2e-3)

    want, (wk, wv) = tiny["jeng"].decode_frame(
        tiny["jsp"], jnp.asarray(frame, jnp.int32), jnp.asarray(tB), jcache)
    got, (gk, gv) = tiny["eng"].decode_frame(tiny["sp"], t(frame).long(),
                                             t(tB), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **tol)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **tol)

    # return_kv=False: the same logits, and no k/v
    again, none = tiny["eng"].decode_frame(tiny["sp"], t(frame).long(), t(tB),
                                           cache, return_kv=False)
    assert none is None and torch.equal(again, got)

    want, (wk, wv) = tiny["jeng"].decode_frame_pair(
        tiny["jsp"], jnp.asarray(frame, jnp.int32),
        jnp.asarray(masked, jnp.int32), jnp.asarray(tB), jcache)
    got, (gk, gv) = tiny["eng"].decode_frame_pair(
        tiny["sp"], t(frame).long(), t(masked).long(), t(tB), cache)
    assert tuple(gk.shape) == (1, cfg.num_layers, B, cfg.S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **tol)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **tol)


def test_greedy_rollout_tokens_match_jax(tiny):
    """Greedy fused rollout: tokens exact; step-0 logits atol 2e-4, rtol
    2e-3, or with the int8 cache atol 5e-3: a committed value that the two
    packages round to neighbouring int8 steps moves later logits by about
    that step's share of one key, and the argmax gaps are far larger."""
    cfg, jcfg = tiny["cfg"], tiny["jcfg"]
    prompt_flat = tiny["prompt"].reshape(B, -1)
    jeng, jsp = tiny["jeng"], tiny["jsp"]
    want_tokens, want_logits = jax_fused(
        functools.partial(jeng.prefill, jsp),
        functools.partial(jeng.decode_frame, jsp),
        functools.partial(jeng.decode_frame_pair, jsp),
        jnp.asarray(prompt_flat), cfg.T - 2, jax.random.PRNGKey(0), jcfg,
        maskgit_steps=2, temperature=0.0, unmask_mode="greedy")
    s = np.sort(np.asarray(want_logits), axis=1)
    assert float((s[:, -1] - s[:, -2]).min()) > 1e-2  # no near-ties

    eng, sp = tiny["eng"], tiny["sp"]
    tokens, logits = generate_cached_fused(
        functools.partial(eng.prefill, sp),
        functools.partial(eng.decode_frame, sp, return_kv=False),
        functools.partial(eng.decode_frame_pair, sp),
        input_ids_BN=t(prompt_flat).long(), num_new_frames=cfg.T - 2,
        generator=None, config=cfg, maskgit_steps=2, temperature=0.0,
        unmask_mode="greedy")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=5e-3 if tiny["int8"] else 2e-4, rtol=2e-3)

    # the user's entry point takes the same route
    engine = RolloutEngine(tiny["model"], cfg, device="cpu",
                           unmask_mode="greedy",
                           cache_dtype=tiny["cache_dtype"])
    assert engine.engine.cache_dtype == tiny["cache_dtype"]
    out = engine.rollout(t(tiny["prompt"]), cfg.T - 2)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  tokens.numpy())
