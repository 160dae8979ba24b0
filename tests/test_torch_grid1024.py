"""A 32 x 32 token grid through both packages, on the CPU.

A tiny configuration at S = 1024 (2 layers, d_model 64, 2 heads of 32, T 4,
2 prompt frames, fp32, no remat), the grid GENIE_138M-S1024 runs on the
card, and the same at S = 576 (a 24 x 24 grid, whose 9 query tiles leave
the card's last 128-query block half full): weights drawn with numpy from
a seed go into the JAX model and, through `params_from_jax`, into the
port's, whose ops take their plain versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode. Held to each other at
tests/test_torch_window32.py's fp32 tolerances: the logits, loss and
accuracy (atol 2e-4, rtol 2e-3; 1e-5), the cached rollout of 2 new frames
at temperature 0 with greedy unmasking (tokens exact, logits atol 2e-4,
rtol 2e-3), one train step's loss and every parameter's gradient (atol
2e-5 + rtol 2e-3), and `score_policies` (rtol 1e-4).

Then each module whose card kernel depends on S, at S = 1024, against its
JAX function in interpret mode at atol = rtol = 1e-4 (fp32, the same
products summed in another order): `flash_mha`'s plain forward and lse and
`flash_mha_bwd_plain` (K9, K10), `spatial_block_plain` (K1, both modes) and
`spatial_train_block_plain`'s values and gradients (K11). Last, the
contract the card wrappers check before a launch: S % 64 == 0 from 64 to
4096 taken, S = 1000 and 4160 refused, naming the limit.
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
from tpu1x.ops import pallas_attention as jpa
from tpu1x.rollout.engine import RolloutEngine as JaxRollout
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops import spatial_block as tsb
from tpu1x_torch.ops import spatial_train_block as tstb
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
B = 1
TOL = dict(atol=1e-4, rtol=1e-4)


def size(S):
    return dict(num_layers=2, d_model=64, num_heads=2, S=S, T=4,
                num_prompt_frames=2, remat=False)


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


def rand(rng, *shape, scale=1.0, mean=0.0):
    return (mean + rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(tol or TOL))


@pytest.fixture(scope="module", params=[1024, 576], ids=["S1024", "S576"])
def grid(request):
    S = request.param
    jcfg, cfg = jax_tiny(**size(S)), genie_tiny(**size(S))
    assert (cfg.S, cfg.latent_side_len, cfg.head_dim) == (
        S, int(S ** 0.5), 32)
    jmodel = JaxModel(jcfg)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    tree = jmodel.init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    np_params = random_tree(jax.device_get(tree), 0)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    return dict(S=S, jcfg=jcfg, cfg=cfg, jmodel=jmodel, np_params=np_params,
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

def test_logits_loss_and_acc(grid):
    cfg = grid["cfg"]
    ids, labels = batch(cfg, 1)
    want = grid["jmodel"].apply({"params": as_jnp(grid["np_params"])},
                                jnp.asarray(ids), jnp.asarray(labels))
    with torch.no_grad():
        got = grid["model"](t(ids).long(), t(labels).long())
    assert tuple(got["logits"].shape)[:3] == (B, cfg.T, cfg.S)
    close(got["logits"].numpy(), want["logits"], atol=2e-4, rtol=2e-3)
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-5, err_msg=key)


def test_greedy_cached_rollout_tokens(grid):
    """2 new frames after 2 prompt frames: the prefill and every decode
    attend over the whole grid of each frame."""
    jcfg, cfg = grid["jcfg"], grid["cfg"]
    # a prompt whose rollout decides no near-tie at either grid (2048 and
    # 1152 greedy choices a frame)
    rng = np.random.default_rng(4)
    side = cfg.latent_side_len
    prompt = rng.integers(0, cfg.image_vocab_size,
                          (B, cfg.num_prompt_frames, side, side))
    prompt_flat = prompt.reshape(B, -1).astype(np.int32)
    new = cfg.T - cfg.num_prompt_frames
    jsp = jax_prepare(as_jnp(grid["np_params"]), compute_dtype=jnp.float32)
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

    sp = prepare_serving_params(grid["model"], cfg,
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
    engine = RolloutEngine(grid["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    out = engine.rollout(t(prompt), new)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  np.asarray(want_tokens))


def test_train_step_loss_and_every_gradient(grid):
    """The loss through the JAX package's Pallas train kernels (interpret
    mode) and its gradient with respect to every parameter, against the
    port's plain train blocks under autograd."""
    cfg = grid["cfg"]
    jcfg = jax_tiny(**size(grid["S"]), attn_impl="pallas")
    ids, labels = batch(cfg, 3)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels))["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(as_jnp(grid["np_params"]))
    want = params_from_jax(jax.device_get(jgrads), cfg)
    model = STMaskGIT(cfg)
    model.load_state_dict(grid["model"].state_dict())
    out = model(t(ids).long(), t(labels).long())
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               atol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)


def test_score_policies(grid):
    """Two policies of 2 frames each after one shared context of 2: the
    per-frame CE and the scores."""
    cfg, side = grid["cfg"], grid["cfg"].latent_side_len
    rng = np.random.default_rng(5)
    T_ctx, P = 2, 2
    ctx = rng.integers(0, cfg.image_vocab_size,
                       (T_ctx, side, side)).astype(np.int32)
    conts = rng.integers(0, cfg.image_vocab_size,
                         (P, cfg.T - T_ctx, side, side)).astype(np.int32)
    got = RolloutEngine(grid["model"], cfg, device="cpu").score_policies(
        t(ctx), t(conts), per_frame=True)
    want = JaxRollout(grid["jmodel"], as_jnp(grid["np_params"]),
                      grid["jcfg"]).score_policies(
        jnp.asarray(ctx), jnp.asarray(conts), per_frame=True)
    assert tuple(got[1].shape) == (P, cfg.T - T_ctx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)


# ------------------------------------------------ the spatial-axis modules

N_GRID, H, D = 1024, 2, 32
SCALE = D ** -0.5


def flash_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rand(rng, 2, N_GRID, H, D) for _ in range(4)]  # q, k, v, dout


@pytest.mark.parametrize("causal", [False, True],
                         ids=["non-causal", "causal"])
def test_flash_forward_and_lse(causal):
    """K9's plain version at N = 1024: o against the JAX `flash_mha` in
    interpret mode, lse against the log-sum-exp of the JAX logits."""
    q, k, v, _ = flash_inputs(40 + causal)
    want = jpa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=SCALE, causal=causal, interpret=True)
    o, lse = tattn.mha_lse_reference(t(q), t(k), t(v), scale=SCALE,
                                     causal=causal)
    close(o, want)
    logits = jnp.einsum("rqhd,rkhd->rhqk", jnp.asarray(q),
                        jnp.asarray(k)) * SCALE
    if causal:
        logits = jnp.where(jnp.tril(jnp.ones((N_GRID, N_GRID), bool)),
                           logits, -jnp.inf)
    assert tuple(lse.shape) == (2, H, N_GRID)
    close(lse, jax.nn.logsumexp(logits, axis=-1))


@pytest.mark.parametrize("causal", [False, True],
                         ids=["non-causal", "causal"])
def test_flash_backward(causal):
    """K10's plain version at N = 1024 (`flash_mha_bwd_plain` from the
    residuals o and lse) against `jax.vjp` of the JAX `flash_mha` in
    interpret mode (its Pallas backward kernel)."""
    q, k, v, dout = flash_inputs(42 + causal)
    _, vjp = jax.vjp(lambda *a: jpa.flash_mha(*a, scale=SCALE, causal=causal,
                                              interpret=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    o, lse = tattn.mha_lse_reference(t(q), t(k), t(v), scale=SCALE,
                                     causal=causal)
    got = tattn.flash_mha_bwd_plain(t(q), t(k), t(v), o, lse, t(dout),
                                    scale=SCALE, causal=causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def spatial_args(seed, qk_ln=False, C=64):
    rng = np.random.default_rng(seed)
    args = dict(x=rand(rng, 2, N_GRID, C), wqkv=rand(rng, C, 3 * C, scale=0.1),
                wproj=rand(rng, C, C, scale=0.1),
                bproj=rand(rng, C, scale=0.05))
    if qk_ln:
        args.update(qk_ln_scale=rand(rng, C // H, scale=0.1, mean=1.0),
                    qk_ln_bias=rand(rng, C // H, scale=0.1))
    else:
        args.update(ln_scale=rand(rng, C, scale=0.1, mean=1.0),
                    ln_bias=rand(rng, C, scale=0.1))
    return args


@pytest.mark.parametrize("qk_ln", [False, True], ids=["pre-ln", "qk-ln"])
def test_spatial_block_plain(qk_ln):
    """K1's plain version at S = 1024, with the pre-LN or the qk-LN,
    against the JAX kernel in interpret mode."""
    from tpu1x.ops.spatial_block import spatial_block as jax_fn
    args = spatial_args(50 + qk_ln, qk_ln)
    kw = dict(num_heads=H, scale=SCALE)
    want = jax_fn(**{k: jnp.asarray(v) for k, v in args.items()},
                  interpret=True, **kw)
    got = tsb.spatial_block(**{k: t(v) for k, v in args.items()}, **kw)
    close(got, want)


def test_spatial_train_block_plain_and_gradients():
    """K11's plain version at S = 1024: the value and the gradient of every
    input under autograd against `jax.vjp` of the JAX `spatial_train_block`
    in interpret mode (its Pallas backward kernel)."""
    from tpu1x.ops.spatial_train_block import spatial_train_block as jax_fn
    args = spatial_args(52)
    cot = rand(np.random.default_rng(53), 2, N_GRID, 64)
    kw = dict(num_heads=H, scale=SCALE)
    names = list(args)
    want, vjp = jax.vjp(
        lambda *a: jax_fn(**dict(zip(names, a)), interpret=True, **kw),
        *(jnp.asarray(args[n]) for n in names))
    want_grads = vjp(jnp.asarray(cot))
    leaves = {n: t(v).requires_grad_(True) for n, v in args.items()}
    got = tstb.spatial_train_block(**leaves, **kw)
    close(got.detach(), want)
    grads = torch.autograd.grad(got, list(leaves.values()), t(cot))
    for n, g, w in zip(names, grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=2e-3, err_msg=n)


# ------------------------------------------------------------ the contract

def spatial_bf16(S, C=256, heads=8):
    x = torch.zeros(2, S, C, dtype=torch.bfloat16)
    w = dict(wqkv=torch.zeros(C, 3 * C, dtype=torch.bfloat16),
             wproj=torch.zeros(C, C, dtype=torch.bfloat16))
    return x, w, heads


@pytest.mark.parametrize("S", [64, 576, 1024, 4096])
def test_contract_takes_the_grid(S):
    """The checks before a launch take every S % 64 == 0 from 64 to 4096:
    the flash pair's (K9, K10, and K11 through them) and K1's."""
    tattn._check_shape(*(torch.zeros(2, S, 8, 32),) * 3)
    tattn._check_shape(*(torch.zeros(2, S, 4, 64),) * 3)
    x, w, heads = spatial_bf16(S)
    assert tsb._check(x, w["wqkv"], w["wproj"], heads) == 32


@pytest.mark.parametrize("S", [1000, 4160])
def test_contract_refuses_other_grids(S):
    """S = 1000 (not a multiple of 64) and S = 4160 (past 4096) raise before
    a launch in both wrappers, naming the limit, with no fallback."""
    with pytest.raises(ValueError, match="64 <= N <= 4096"):
        tattn._check_shape(*(torch.zeros(2, S, 8, 32),) * 3)
    x, w, heads = spatial_bf16(S)
    with pytest.raises(ValueError, match="64 <= S <= 4096"):
        tsb._check(x, w["wqkv"], w["wproj"], heads)
