"""The port's serving slice against the JAX package, end to end on the CPU.

At genie_tiny(T=4, num_prompt_frames=2, num_heads=2, d_model=32) in fp32,
weights drawn with numpy from a seed go into the JAX DecodeEngine
(attn_impl="pallas": its kernels in interpret mode) and, through
`params_from_jax`, into the port's DecodeEngine on the CPU, where every op
takes its plain version. Tolerances: prefill cache atol 1e-4; decode logits
atol 2e-4, rtol 2e-3; greedy rollout tokens exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.model_zoo import genie_tiny as jax_tiny
from tpu1x.models.sampler import generate_cached_fused as jax_fused
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.sampler import generate_cached, generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
SIZE = dict(T=4, num_prompt_frames=2, num_heads=2, d_model=32)
B = 2


def random_tree(tree, seed):
    """Replace every leaf with numpy draws. The head and embeddings get
    large scales, so that logits are far from uniform and greedy argmax has
    clear winners."""
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


def setup(action_vocab_size=0, scan_layers=True, seed=0):
    jcfg = jax_tiny(**SIZE, action_vocab_size=action_vocab_size,
                    scan_layers=scan_layers)
    cfg = genie_tiny(**SIZE, action_vocab_size=action_vocab_size)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    act = jnp.zeros((1, jcfg.T), jnp.int32) if action_vocab_size else None
    tree = JaxModel(jcfg).init(jax.random.PRNGKey(0), dummy, dummy,
                               act)["params"]
    np_params = random_tree(jax.device_get(tree), seed)
    return jcfg, cfg, np_params


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg, np_params = setup()
    jsp = jax_prepare(jax.tree_util.tree_map(jnp.asarray, np_params),
                      compute_dtype=jnp.float32)
    jeng = JaxEngine(jcfg, attn_impl="pallas", compute_dtype=jnp.float32)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    sp = prepare_serving_params(model, cfg, compute_dtype=torch.float32,
                                device="cpu")
    eng = DecodeEngine(cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.image_vocab_size, (B, 2, 4, 4)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jsp=jsp, jeng=jeng, model=model, sp=sp,
                eng=eng, prompt=prompt, np_params=np_params)


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def t(a):
    return torch.from_numpy(np.array(a))


def test_prefill_cache_matches_jax(tiny):
    want = tiny["jeng"].prefill(tiny["jsp"], jnp.asarray(tiny["prompt"]))
    got = tiny["eng"].prefill(tiny["sp"], t(tiny["prompt"]).long())
    for key in ("k", "v"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=0)
    assert not got["k"][2:].any()  # slots past the prompt stay zero


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

    want, (wk, wv) = tiny["jeng"].decode_frame_pair(
        tiny["jsp"], jnp.asarray(frame, jnp.int32),
        jnp.asarray(masked, jnp.int32), jnp.asarray(tB), jcache)
    got, (gk, gv) = tiny["eng"].decode_frame_pair(
        tiny["sp"], t(frame).long(), t(masked).long(), t(tB), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **tol)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **tol)


def test_decode_frame_without_kv(tiny):
    """return_kv=False: the same logits, and no k/v."""
    cfg = tiny["cfg"]
    cache = tiny["eng"].prefill(tiny["sp"], t(tiny["prompt"]).long())
    frame = torch.full((B, cfg.S), cfg.mask_token_id, dtype=torch.long)
    want, kv = tiny["eng"].decode_frame(tiny["sp"], frame, 2, cache)
    got, none = tiny["eng"].decode_frame(tiny["sp"], frame, 2, cache,
                                         return_kv=False)
    assert none is None and tuple(kv[0].shape) == (1, cfg.num_layers, B,
                                                  cfg.S, cfg.d_model)
    assert torch.equal(got, want)


def top2_gap(logits_BVF_last):
    """Smallest gap between the two largest logits over V (axis 1)."""
    s = np.sort(np.asarray(logits_BVF_last), axis=1)
    return float((s[:, -1] - s[:, -2]).min())


def test_greedy_rollout_tokens_match_jax(tiny):
    cfg, jcfg = tiny["cfg"], tiny["jcfg"]
    prompt_flat = tiny["prompt"].reshape(B, -1)
    jeng, jsp = tiny["jeng"], tiny["jsp"]
    want_tokens, want_logits = jax_fused(
        functools.partial(jeng.prefill, jsp),
        functools.partial(jeng.decode_frame, jsp),
        functools.partial(jeng.decode_frame_pair, jsp),
        jnp.asarray(prompt_flat), cfg.T - 2, jax.random.PRNGKey(0), jcfg,
        maskgit_steps=2, temperature=0.0, unmask_mode="greedy")
    # precondition of exact token parity: no near-ties at the argmax
    assert top2_gap(want_logits) > 1e-3

    eng, sp = tiny["eng"], tiny["sp"]
    kw = dict(input_ids_BN=t(prompt_flat).long(), num_new_frames=cfg.T - 2,
              generator=None, config=cfg, maskgit_steps=2, temperature=0.0,
              unmask_mode="greedy")
    fused_tokens, fused_logits = generate_cached_fused(
        functools.partial(eng.prefill, sp), functools.partial(eng.decode_frame, sp),
        functools.partial(eng.decode_frame_pair, sp), **kw)
    np.testing.assert_array_equal(fused_tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(fused_logits.numpy(), np.asarray(want_logits),
                               atol=2e-4, rtol=2e-3)

    std_tokens, std_logits = generate_cached(
        functools.partial(eng.prefill, sp), functools.partial(eng.decode_frame, sp),
        **kw)
    np.testing.assert_array_equal(std_tokens.numpy(), fused_tokens.numpy())
    np.testing.assert_allclose(std_logits.numpy(), fused_logits.numpy(),
                               atol=2e-4, rtol=2e-3)

    # the user's entry point takes the same route
    engine = RolloutEngine(tiny["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    out = engine.rollout(t(tiny["prompt"]), cfg.T - 2, num_futures=2)
    assert tuple(out.shape) == (B, 2, cfg.T, 4, 4)
    for k in range(2):
        np.testing.assert_array_equal(out[:, k].reshape(B, -1).numpy(),
                                      fused_tokens.numpy())


def test_random_sampling_uses_the_generator(tiny):
    cfg = tiny["cfg"]
    engine = RolloutEngine(tiny["model"], cfg, device="cpu", temperature=1.0)
    prompt = t(tiny["prompt"])
    a = engine.rollout(prompt, 2, torch.Generator().manual_seed(5))
    b = engine.rollout(prompt, 2, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(a.min()) >= 0 and int(a.max()) < cfg.image_vocab_size


def test_action_conditioned_decode_matches_jax():
    jcfg, cfg, np_params = setup(action_vocab_size=7, seed=3)
    jsp = jax_prepare(jax.tree_util.tree_map(jnp.asarray, np_params),
                      compute_dtype=jnp.float32)
    jeng = JaxEngine(jcfg, attn_impl="pallas", compute_dtype=jnp.float32)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    sp = prepare_serving_params(model, cfg, compute_dtype=torch.float32,
                                device="cpu")
    eng = DecodeEngine(cfg, device="cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.image_vocab_size, (B, 2, 4, 4))
    acts = rng.integers(0, 7, (B, 2))
    jcache = jeng.prefill(jsp, jnp.asarray(prompt, jnp.int32),
                          jnp.asarray(acts, jnp.int32))
    cache = eng.prefill(sp, t(prompt).long(), t(acts).long())
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4, rtol=0)
    frame = np.full((B, cfg.S), cfg.mask_token_id)
    want, _ = jeng.decode_frame(jsp, jnp.asarray(frame, jnp.int32), 2, jcache,
                                jnp.asarray(acts[:, 0], jnp.int32))
    got, _ = eng.decode_frame(sp, t(frame).long(), 2, cache, t(acts[:, 0]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_params_from_jax_layouts(scan_layers):
    """Both flax layer layouts give the reference-named state dict that the
    JAX package's own converter writes."""
    from tpu1x.train.checkpoint import convert_to_torch_state_dict
    jcfg, cfg, np_params = setup(scan_layers=scan_layers, seed=5)
    sd = params_from_jax(np_params, cfg)
    want = convert_to_torch_state_dict(np_params, jcfg)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    STMaskGIT(cfg).load_state_dict(sd)  # strict: every name, every shape


def test_unported_options_raise(tiny):
    """qk_norm and the int8 cache are served (tests/test_torch_qk_norm.py);
    a cache dtype that neither package has raises."""
    assert not DecodeEngine(genie_tiny(qk_norm=True),
                            device="cpu").block_fusion
    assert DecodeEngine(tiny["cfg"], device="cpu",
                        cache_dtype="int8").cache_dtype == "int8"
    with pytest.raises(ValueError, match="cache_dtype"):
        DecodeEngine(tiny["cfg"], device="cpu", cache_dtype="fp8")
    with pytest.raises(ValueError, match="cache_dtype"):
        RolloutEngine(tiny["model"], tiny["cfg"], device="cpu",
                      cache_dtype="int4")


def test_cuda_without_a_card_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(tiny["cfg"])  # the default device is cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutEngine(tiny["model"], tiny["cfg"])
