"""A 32-frame window through both packages, on the CPU.

A tiny configuration at T = 32 (2 layers, d_model 64, 2 heads of 32, S =
16, 16 prompt frames, fp32, no remat), the window GENIE_138M-T32 runs on
the card: weights drawn with numpy from a seed go into the JAX model and,
through `params_from_jax`, into the port's, whose ops take their plain
versions on CPU tensors; the JAX side runs its Pallas kernels in interpret
mode. Held to each other at tests/test_torch_head_dim64.py's fp32
tolerances: the logits, loss and accuracy (atol 2e-4, rtol 2e-3; 1e-5), the
cached rollout of 16 new frames after 16 prompt frames at temperature 0
with greedy unmasking (tokens exact, logits atol 2e-4, rtol 2e-3), one
train step's loss and every parameter's gradient (atol 2e-5 + rtol 2e-3),
and `score_policies` with 16 context frames and 16 frames a policy (rtol
1e-4, as tests/test_torch_eval.py).

Then each module whose card kernel depends on the frame count, at T = 32
(and the temporal attention also at T = 20, causal: frames past T masked on
the card), against its JAX function in interpret mode at atol = rtol = 1e-4
(fp32, the same products summed in another order): the temporal attention
and its gradients, the decode attention (plain and int8 cache, one frame
and the pair, t_B up to 31) and the temporal+MLP block (one frame and the
pair). Last, the contract the card wrappers check before a launch: T <= 32
taken, T = 33 refused, naming the limit.
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
from tpu1x.ops import decode_attention as jdec
from tpu1x.rollout.engine import RolloutEngine as JaxRollout
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.ops import decode_attention as tdec
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.ops import temporal_mlp_block as tmb
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
SIZE = dict(num_layers=2, d_model=64, num_heads=2, S=16, T=32,
            num_prompt_frames=16, remat=False)
B = 1
TOL = dict(atol=1e-4, rtol=1e-4)


def random_tree(tree, seed):
    """Every leaf drawn with numpy; the head and embeddings at large scales,
    so that the logits have clear winners and greedy decoding decides no
    near-tie."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = np.shape(leaf)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        s = (0.3 if "out_x_proj" in name else 1.0 if "embed" in name
             else 0.05 if name.endswith("bias") else 0.1)
        return (s * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def as_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def t(a):
    return torch.from_numpy(np.asarray(a))


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(tol or TOL))


@pytest.fixture(scope="module")
def w32():
    jcfg, cfg = jax_tiny(**SIZE), genie_tiny(**SIZE)
    assert (cfg.T, cfg.num_prompt_frames, cfg.head_dim) == (32, 16, 32)
    jmodel = JaxModel(jcfg)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    tree = jmodel.init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    np_params = random_tree(jax.device_get(tree), 0)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, np_params=np_params,
                model=model.eval())


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def batch(cfg, seed):
    """Input ids with some masked positions in frames 1 onward, and the
    clean labels, made with numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.image_vocab_size, (B, cfg.T * cfg.S))
    ids = labels.copy().reshape(B, cfg.T, cfg.S)
    ids[:, 1:][rng.random((B, cfg.T - 1, cfg.S)) < 0.4] = cfg.mask_token_id
    return ids.reshape(B, -1).astype(np.int32), labels.astype(np.int32)


# ------------------------------------------------------------ the model

def test_logits_loss_and_acc(w32):
    cfg = w32["cfg"]
    ids, labels = batch(cfg, 1)
    want = w32["jmodel"].apply({"params": as_jnp(w32["np_params"])},
                               jnp.asarray(ids), jnp.asarray(labels))
    with torch.no_grad():
        got = w32["model"](t(ids).long(), t(labels).long())
    assert tuple(got["logits"].shape)[:3] == (B, cfg.T, cfg.S)
    close(got["logits"].numpy(), want["logits"], atol=2e-4, rtol=2e-3)
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-5, err_msg=key)


def test_greedy_cached_rollout_tokens(w32):
    """16 new frames after 16 prompt frames: every decode reads a cache of
    32 slots, the last frames at t_B up to 31."""
    jcfg, cfg = w32["jcfg"], w32["cfg"]
    rng = np.random.default_rng(2)
    side = cfg.latent_side_len
    prompt = rng.integers(0, cfg.image_vocab_size,
                          (B, cfg.num_prompt_frames, side, side))
    prompt_flat = prompt.reshape(B, -1).astype(np.int32)
    new = cfg.T - cfg.num_prompt_frames
    jsp = jax_prepare(as_jnp(w32["np_params"]), compute_dtype=jnp.float32)
    jeng = JaxEngine(jcfg, attn_impl="pallas", compute_dtype=jnp.float32)
    want_tokens, want_logits = jax_fused(
        functools.partial(jeng.prefill, jsp),
        functools.partial(jeng.decode_frame, jsp),
        functools.partial(jeng.decode_frame_pair, jsp),
        jnp.asarray(prompt_flat), new, jax.random.PRNGKey(0), jcfg,
        maskgit_steps=2, temperature=0.0, unmask_mode="greedy")
    # precondition of exact token parity: no near-tie at an argmax
    s = np.sort(np.asarray(want_logits), axis=1)
    assert float((s[:, -1] - s[:, -2]).min()) > 1e-3

    sp = prepare_serving_params(w32["model"], cfg,
                                compute_dtype=torch.float32, device="cpu")
    eng = DecodeEngine(cfg, device="cpu")
    tokens, logits = generate_cached_fused(
        functools.partial(eng.prefill, sp),
        functools.partial(eng.decode_frame, sp),
        functools.partial(eng.decode_frame_pair, sp),
        input_ids_BN=t(prompt_flat).long(), num_new_frames=new,
        generator=None, config=cfg, maskgit_steps=2, temperature=0.0,
        unmask_mode="greedy")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    close(logits.numpy(), want_logits, atol=2e-4, rtol=2e-3)
    # the user's entry point takes the same route
    engine = RolloutEngine(w32["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    out = engine.rollout(t(prompt), new)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  np.asarray(want_tokens))


def test_train_step_loss_and_every_gradient(w32):
    """The loss through the JAX package's Pallas train kernels (interpret
    mode) and its gradient with respect to every parameter, against the
    port's plain train blocks under autograd, at T = 32."""
    cfg = w32["cfg"]
    jcfg = jax_tiny(**SIZE, attn_impl="pallas")
    ids, labels = batch(cfg, 3)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels))["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(as_jnp(w32["np_params"]))
    want = params_from_jax(jax.device_get(jgrads), cfg)
    model = STMaskGIT(cfg)
    model.load_state_dict(w32["model"].state_dict())
    out = model(t(ids).long(), t(labels).long())
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               atol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)


def test_score_policies_16_after_16(w32):
    """Two policies of 16 frames each after one shared context of 16:
    the per-frame CE and the scores."""
    cfg, side = w32["cfg"], w32["cfg"].latent_side_len
    rng = np.random.default_rng(5)
    T_ctx, P = 16, 2
    ctx = rng.integers(0, cfg.image_vocab_size,
                       (T_ctx, side, side)).astype(np.int32)
    conts = rng.integers(0, cfg.image_vocab_size,
                         (P, cfg.T - T_ctx, side, side)).astype(np.int32)
    got = RolloutEngine(w32["model"], cfg, device="cpu").score_policies(
        t(ctx), t(conts), per_frame=True)
    want = JaxRollout(w32["jmodel"], as_jnp(w32["np_params"]),
                      w32["jcfg"]).score_policies(
        jnp.asarray(ctx), jnp.asarray(conts), per_frame=True)
    assert tuple(got[1].shape) == (P, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)


# ------------------------------------------------- the frame-axis modules

@pytest.mark.parametrize("T,causal,H", [
    pytest.param(32, True, 2, id="32-causal"),
    pytest.param(32, False, 2, id="32-non-causal"),
    pytest.param(20, True, 2, id="20-causal"),
    pytest.param(32, True, 1, id="32-causal-h64")])
def test_temporal_attention_and_gradients(T, causal, H):
    """The forward (`temporal_attention`), and dq, dk, dv with the
    forward's output `o` (`launch_backward`, the backward the train block
    calls), against the JAX kernel and `jax.vjp`; H = 1 at C = 64 is
    head_dim 64."""
    from tpu1x.ops.temporal_attention import temporal_attention as jax_fn
    rng = np.random.default_rng(T + 2 * causal + H)
    Bq, S, C = 1, 8, 64
    q, k, v, dout = (rand(rng, Bq, T, S, C) for _ in range(4))
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, causal=causal)
    want, vjp = jax.vjp(lambda *a: jax_fn(*a, interpret=True, **kw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    close(ta.temporal_attention(t(q), t(k), t(v), **kw), want)
    o = torch.full((Bq, T, S, C), float("nan"))
    dqkv = ta.launch_backward(t(q), t(k), t(v), t(dout), o=o, **kw)
    close(o, want)
    for got, w in zip(dqkv.split(C, dim=-1), want_grads):
        close(got, w)


def decode_case(rng, frames, int8, T=32, L=2, Bd=4, S=32, C=64):
    """q, k, v of `frames` frames and a (T, L, B, S, C) cache (int8 with its
    (L, B, T, S) scales, made by the JAX package), as numpy."""
    qkv = [rand(rng, Bd, S, C) for _ in range(3 * frames)]
    kc, vc = rand(rng, T, L, Bd, S, C), rand(rng, T, L, Bd, S, C)
    scales = {}
    if int8:
        caches = []
        for c, name in ((kc, "k_scale"), (vc, "v_scale")):
            q8, sc = jdec.quantize_kv(jnp.asarray(c))
            caches.append(np.array(q8))
            scales[name] = np.array(jnp.transpose(sc, (1, 2, 0, 3)))
        kc, vc = caches
    return qkv, kc, vc, scales


@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
@pytest.mark.parametrize("int8", [False, True], ids=["plain-cache", "int8"])
def test_decode_attention_32_slots(pair, int8):
    """K7 (one frame) and K8 (the pair) on the CPU against the JAX kernels
    in interpret mode, on a cache of 32 slots with t_B up to 31 (the pair's
    prev at most 30, its cur then at 31)."""
    rng = np.random.default_rng(20 + 2 * pair + int8)
    qkv, kc, vc, scales = decode_case(rng, 2 if pair else 1, int8)
    kw = dict(layer=1, scale=0.25, num_heads=2)
    if pair:
        t_B = np.array([0, 17, 29, 30], np.int32)
        qp, qc, kp, vp, kcur, vcur = qkv
        args = (qp, qc, kc, vc, kp, vp, kcur, vcur, t_B)
        jfn, tfn = (jdec.temporal_decode2_attention,
                    tdec.temporal_decode2_attention)
    else:
        t_B = np.array([31, 0, 16, 24], np.int32)
        q, kcur, vcur = qkv
        args = (q, kc, vc, kcur, vcur, t_B)
        jfn, tfn = (jdec.temporal_decode_attention,
                    tdec.temporal_decode_attention)
    want = jfn(*map(jnp.asarray, args), tile_s=16, interpret=True, **kw,
               **{n: jnp.asarray(s) for n, s in scales.items()})
    got = tfn(*map(t, args), **kw, **{n: t(s) for n, s in scales.items()})
    got, want = (got, want) if pair else ((got,), (want,))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
def test_temporal_mlp_block_32_slots(pair):
    """K2 (one frame) and K3 (the pair) on the CPU against the JAX kernels
    in interpret mode, on a cache of 32 slots, t_B up to 31."""
    rng = np.random.default_rng(30 + pair)
    Bd, S, C, H, T, L, layer = 2, 32, 64, 2, 32, 2, 1
    w = dict(wqkv=rand(rng, C, 3 * C, scale=0.05),
             wproj=rand(rng, C, C, scale=0.05),
             wfc1=rand(rng, C, 4 * C, scale=0.05),
             wfc2=rand(rng, 4 * C, C, scale=0.05),
             ln_scale=1.0 + rand(rng, C, scale=0.1),
             ln_bias=rand(rng, C, scale=0.1), bproj=rand(rng, C, scale=0.1),
             bfc1=rand(rng, 4 * C, scale=0.1), bfc2=rand(rng, C, scale=0.1))
    x = (rand(rng, Bd, 2, S, C, scale=0.5) if pair
         else rand(rng, Bd, S, C, scale=0.5))
    kc = rand(rng, T, L, Bd, S, C, scale=0.5)
    vc = rand(rng, T, L, Bd, S, C, scale=0.5)
    t_B = np.array([17, 30] if pair else [31, 20], np.int32)
    if pair:
        from tpu1x.ops.temporal_mlp_block import temporal_mlp_block_pair as jfn
        tfn = tmb.temporal_mlp_block_pair
    else:
        from tpu1x.ops.temporal_mlp_block import temporal_mlp_block as jfn
        tfn = tmb.temporal_mlp_block
    kw = dict(layer=layer, scale=(C // H) ** -0.5, num_heads=H,
              gelu_tanh=True)
    want = jfn(jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
               jnp.asarray(t_B), tile_s=16, interpret=True, **kw,
               **{k: jnp.asarray(v) for k, v in w.items()})
    got = tfn(t(x), t(kc), t(vc), t(t_B), **kw,
              **{k: t(v) for k, v in w.items()})
    for g, wnt in zip(got, want):
        close(g, wnt)


# ------------------------------------------------------------ the contract

@pytest.mark.parametrize("T", [17, 20, 24, 32])
def test_contract_takes_up_to_32_frames(T):
    """The checks before a launch take every frame count up to 32: the
    temporal attention's (K4, K6, and K12 through them) and the decode
    attention's (K7, K8)."""
    qkv = torch.zeros(2, T, 4, 3 * 256, dtype=torch.bfloat16)
    assert ta._check_qkv(*qkv.split(256, dim=-1), 8) == 3 * 256
    qs = torch.zeros(2, 8, 3 * 256, dtype=torch.bfloat16).split(256, dim=-1)
    cache = torch.zeros(T, 2, 2, 8, 256, dtype=torch.bfloat16)
    strides = tdec._check((qs[0],), (qs[1],), (qs[2],), cache, cache,
                          torch.zeros(2, dtype=torch.int32), 1, None, None,
                          None, None, 8)
    assert strides == [(8 * 3 * 256, 3 * 256)] * 3


def test_contract_refuses_33_frames():
    """T = 33 raises before a launch in every frame-axis wrapper, naming
    the limit, with no fallback."""
    qkv = torch.zeros(2, 33, 4, 3 * 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T <= 32"):
        ta._check_qkv(*qkv.split(256, dim=-1), 8)
    qs = torch.zeros(2, 8, 3 * 256, dtype=torch.bfloat16).split(256, dim=-1)
    cache = torch.zeros(33, 2, 2, 8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T <= 32"):
        tdec._check((qs[0],), (qs[1],), (qs[2],), cache, cache,
                    torch.zeros(2, dtype=torch.int32), 1, None, None, None,
                    None, 8)
    w = dict(wqkv=None, wproj=None, ln_scale=None, ln_bias=None, wfc1=None,
             wfc2=None, bqkv=None, bproj=None, bfc1=None, bfc2=None)
    w["wfc1"] = torch.zeros(256, 1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T <= 32"):
        tmb._launch(torch.zeros(2, 8, 256, dtype=torch.bfloat16), cache,
                    cache, torch.zeros(2, dtype=torch.int32), 1, 1, None,
                    True, scale=1.0, num_heads=8, gelu_tanh=True, **w)
