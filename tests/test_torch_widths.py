"""Model widths that are not a multiple of 256, and rows past 1024, through
both packages on the CPU.

- GENIE_138M-C384 is configs/genie_138m.json loaded by each package's
  `GenieConfig.from_pretrained` with d_model 384 in 6 heads of 64 (DiT-S's
  width and head split), cut to 2 layers, S = 64 (8 x 8 tokens) and T = 4
  (2 prompt frames), fp32 and no remat. Weights drawn with numpy from a
  seed go into the JAX model and, through `params_from_jax`, into the
  port's, whose ops take their plain versions on CPU tensors; the JAX side
  runs its Pallas kernels in interpret mode. Held to each other at
  tests/test_torch_head_dim128.py's fp32 tolerances: the logits, loss and
  accuracy (atol 2e-4, rtol 2e-3; 1e-5), the cached rollout's tokens at
  temperature 0 with greedy unmasking, exact, and its logits, one train
  step's loss and every parameter's gradient (atol 2e-5 + rtol 2e-3).
- GENIE_138M-C1600's width (GPT-2 XL's: 25 heads of 64) at 1 layer, S = 16,
  T = 2: the weights carried across by `params_from_jax`, and the logits
  and loss at the same tolerances.
- The LayerNorm row passes of the train blocks past 1024 channels (C =
  1600 and 2048): `mlp_train_block_fwd` / `_bwd` with the LN on CPU tensors
  (the launchers' plain versions, `ln_fwd_plain` and `ln_bwd_plain`
  among them, in the kernels' order) against the JAX package's
  `mlp_train_block` (K13, interpret mode) and `jax.vjp` at a few rows and
  a narrow hidden width, and `spatial_train_block_bwd` (K11) at C = 1600;
  fp32, atol = rtol = 1e-4 (sums in another order) for the values and
  gradients but the weight and LN parameter gradients, sums over the rows
  (atol 2e-4 + rtol 1e-3).
- The width rule of the decode ring (`_util.decode_width_ok`, shared by
  K7/K8's and K2/K3's wrappers) takes every C up to 2048 whose head width
  is 32, 64, 72 or 128, and refuses C = 2080, naming the limit; so does the
  LN rows' limit.

The decode attention and the temporal+MLP block at C = 384 and 1600
against their JAX kernels are cases of their own ops tests (the `C384` and
`C1600` ids of tests/test_torch_decode90.py and tests/test_torch_ops.py).
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.config import GenieConfig as JaxConfig
from tpu1x.models.sampler import generate_cached_fused as jax_fused
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import _util
from tpu1x_torch.ops.mlp_train_block import (mlp_train_block_bwd,
                                             mlp_train_block_fwd)
from tpu1x_torch.ops.spatial_block import spatial_block
from tpu1x_torch.ops.spatial_train_block import spatial_train_block_bwd
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "genie_138m.json"
# GENIE_138M-C384 cut for the CPU; GENIE_138M-C1600 at one layer
C384 = dict(d_model=384, num_heads=6, num_layers=2, S=64, T=4,
            num_prompt_frames=2, dtype="float32", remat=False)
C1600 = dict(d_model=1600, num_heads=25, num_layers=1, S=16, T=2,
             num_prompt_frames=1, dtype="float32", remat=False)
B = 1


def configs(cut, **jax_only):
    """The JSON through each package's config, with `cut` replaced."""
    jcfg = dataclasses.replace(JaxConfig.from_pretrained(CONFIG), **cut,
                               **jax_only)
    cfg = dataclasses.replace(GenieConfig.from_pretrained(CONFIG), **cut)
    return jcfg, cfg


def random_tree(tree, seed, d_model):
    """Every leaf drawn with numpy; the head and embeddings at large scales,
    so that the logits have clear winners over the 512 values of a factor
    and greedy decoding decides no near-tie; the other weights fan-in
    scaled from tests/test_torch_genie35m.py's at d_model 256."""
    rng = np.random.default_rng(seed)
    fan_in = (256 / d_model) ** 0.5

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = leaf.shape
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        s = (1.0 if "embed" in name else 0.02 if name.endswith("bias")
             else fan_in if "out_x_proj" in name else 0.05 * fan_in)
        return (s * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def as_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def build(cut, seed):
    jcfg, cfg = configs(cut)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(
        jax.random.PRNGKey(0), dummy, dummy))["params"]
    np_params = random_tree(shapes, seed, cfg.d_model)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    return dict(jcfg=jcfg, cfg=cfg, np_params=np_params, model=model)


@pytest.fixture(scope="module")
def c384():
    got = build(C384, 0)
    cfg = got["cfg"]
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.S,
            cfg.factored_vocab_size) == (384, 6, 64, 64, 512)
    return got


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


def logits_and_loss(m, seed):
    """The JAX model's and the port's logits, loss and accuracy on one
    batch, held at the fp32 tolerances."""
    jcfg, cfg = m["jcfg"], m["cfg"]
    ids, labels = batch(cfg, seed)
    want = JaxModel(jcfg).apply({"params": as_jnp(m["np_params"])},
                                jnp.asarray(ids), jnp.asarray(labels))
    with torch.no_grad():
        got = m["model"](torch.from_numpy(ids).long(),
                         torch.from_numpy(labels).long())
    assert tuple(got["logits"].shape) == (B, cfg.T, cfg.S, 512, 2)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=2e-3)
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-5, err_msg=key)


# --------------------------------------------------------- GENIE_138M-C384

def test_logits_loss_and_acc(c384):
    logits_and_loss(c384, 1)


def test_greedy_cached_rollout_tokens(c384):
    jcfg, cfg = c384["jcfg"], c384["cfg"]
    rng = np.random.default_rng(2)
    side = cfg.latent_side_len
    prompt = rng.integers(0, cfg.image_vocab_size,
                          (B, cfg.num_prompt_frames, side, side))
    prompt_flat = prompt.reshape(B, -1).astype(np.int32)
    new = cfg.T - cfg.num_prompt_frames
    jsp = jax_prepare(as_jnp(c384["np_params"]), compute_dtype=jnp.float32)
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

    sp = prepare_serving_params(c384["model"], cfg,
                                compute_dtype=torch.float32, device="cpu")
    eng = DecodeEngine(cfg, device="cpu")
    tokens, logits = generate_cached_fused(
        functools.partial(eng.prefill, sp),
        functools.partial(eng.decode_frame, sp),
        functools.partial(eng.decode_frame_pair, sp),
        input_ids_BN=torch.from_numpy(prompt_flat).long(),
        num_new_frames=new, generator=None, config=cfg, maskgit_steps=2,
        temperature=0.0, unmask_mode="greedy")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=2e-4, rtol=2e-3)
    # the user's entry point takes the same route
    engine = RolloutEngine(c384["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    out = engine.rollout(torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  np.asarray(want_tokens))


def test_train_step_loss_and_every_gradient(c384):
    """The loss through the JAX package's Pallas train kernels (interpret
    mode) and its gradient with respect to every parameter, against the
    port's plain train blocks under autograd."""
    cfg = c384["cfg"]
    jcfg, _ = configs(C384, attn_impl="pallas")
    ids, labels = batch(cfg, 3)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels))["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(as_jnp(c384["np_params"]))
    want = params_from_jax(jax.device_get(jgrads), cfg)
    model = STMaskGIT(cfg)
    model.load_state_dict(c384["model"].state_dict())
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               atol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)


# ------------------------------------------------------- GENIE_138M-C1600

def test_c1600_weights_across_and_logits():
    """25 heads of 64 (C % 256 = 64): every JAX parameter reaches the
    port's module by `params_from_jax`, the qkv product's columns in the
    heads' order, and the two models agree on the logits and the loss."""
    m = build(C1600, 4)
    cfg = m["cfg"]
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim) == (1600, 25, 64)
    state = m["model"].state_dict()
    assert tuple(state["decoder.layers.0.spatial_attn.qkv.weight"].shape
                 ) == (3 * 1600, 1600)
    logits_and_loss(m, 5)


# ------------------------------------------ the LN rows past 1024 channels

def rand(rng, *shape, scale=1.0, mean=0.0):
    return (rng.standard_normal(shape) * scale + mean).astype(np.float32)


def value_and_vjp(fn, args, cot):
    """fn's value and its VJP at `cot` of every array of `args`, in the
    JAX package in fp32."""
    names = [k for k, v in args.items() if v is not None]
    jargs = {k: None if v is None else jnp.asarray(v)
             for k, v in args.items()}
    want, vjp = jax.vjp(lambda *v: fn(**dict(jargs, **dict(zip(names, v)))),
                        *(jargs[k] for k in names))
    return np.asarray(want), dict(zip(names, map(np.asarray,
                                                 vjp(jnp.asarray(cot)))))


def held(name, got, want):
    """Rows at atol = rtol = 1e-4; a sum over the rows (a weight's or an LN
    parameter's gradient) at atol 2e-4 + rtol 1e-3."""
    summed = name.startswith(("w", "b", "ln"))
    np.testing.assert_allclose(
        got.double().numpy(), np.asarray(want, np.float64),
        atol=2e-4 if summed else 1e-4, rtol=1e-3 if summed else 1e-4,
        err_msg=name)


@pytest.mark.parametrize("C", [1600, 2048])
def test_mlp_train_block_ln_rows(C):
    """K13 with its LN at C = 1600 (7 chunks of 8 channels a lane on the
    card) and 2048 (8): 2 x 8 rows, hidden 64, the output and the gradient
    of x, both weights, both biases, the LN scale and bias."""
    from tpu1x.ops.mlp_train_block import mlp_train_block as jax_fn
    rng = np.random.default_rng(C)
    F4 = 64
    args = dict(x=rand(rng, 2, 8, C), wfc1=rand(rng, C, F4, scale=0.05),
                wfc2=rand(rng, F4, C, scale=0.05),
                bfc1=rand(rng, F4, scale=0.02), bfc2=rand(rng, C, scale=0.02),
                ln_scale=rand(rng, C, scale=0.1, mean=1.0),
                ln_bias=rand(rng, C, scale=0.1))
    cot = rand(rng, 2, 8, C)
    want, want_grads = value_and_vjp(
        lambda x, wfc1, wfc2, **rest: jax_fn(x, wfc1, wfc2, interpret=True,
                                             **rest), args, cot)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    got = mlp_train_block_fwd(t["x"], t["wfc1"], t["wfc2"], t["bfc1"],
                              t["bfc2"], t["ln_scale"], t["ln_bias"],
                              gelu_approx=False)
    grads = mlp_train_block_bwd(
        t["x"], torch.from_numpy(cot), t["wfc1"], t["wfc2"], t["bfc1"],
        t["ln_scale"], t["ln_bias"], gelu_approx=False, bias=True)
    held("out", got, want)
    for name, g in zip(("x", "wfc1", "wfc2", "bfc1", "bfc2", "ln_scale",
                        "ln_bias"), grads):
        held(name, g, want_grads[name])


def test_spatial_train_block_ln_rows_at_c1600():
    """K11's backward with LN1 at C = 1600 (25 heads of 64), 1 x 16 rows:
    the gradient of x, both weights, the proj bias, the LN scale and bias,
    and the value through K1's forward."""
    from tpu1x.ops.spatial_train_block import spatial_train_block as jax_fn
    rng = np.random.default_rng(7)
    C, H = 1600, 25
    args = dict(x=rand(rng, 1, 16, C), wqkv=rand(rng, C, 3 * C, scale=0.02),
                wproj=rand(rng, C, C, scale=0.02), bqkv=None,
                bproj=rand(rng, C, scale=0.02),
                ln_scale=rand(rng, C, scale=0.1, mean=1.0),
                ln_bias=rand(rng, C, scale=0.1))
    cot = rand(rng, 1, 16, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    want, want_grads = value_and_vjp(
        lambda x, wqkv, wproj, **rest: jax_fn(x, wqkv, wproj, interpret=True,
                                              **kw, **rest), args, cot)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in args.items()}
    got = spatial_block(t["x"], t["wqkv"], t["wproj"], bproj=t["bproj"],
                        ln_scale=t["ln_scale"], ln_bias=t["ln_bias"], **kw)
    grads = spatial_train_block_bwd(
        t["x"], torch.from_numpy(cot), t["wqkv"], t["wproj"], None,
        t["ln_scale"], t["ln_bias"], proj_bias=True, **kw)
    held("out", got, want)
    for name, g in zip(("x", "wqkv", "wproj", "bqkv", "bproj", "ln_scale",
                        "ln_bias"), grads):
        if name == "bqkv":
            assert g is None
            continue
        held(name, g, want_grads[name])


# ------------------------------------------------------------ the contract

# (C, head widths that divide it): the untimed widths of chip_smoke.py's
# width phase and its two configurations
WIDTHS = [(96, (32,)), (320, (32, 64)), (384, (32, 64, 128)),
          (576, (32, 64, 72)), (640, (32, 64, 128)),
          (1152, (32, 64, 72, 128)), (1600, (32, 64)), (2016, (32, 72)),
          (2048, (32, 64, 128))]


@pytest.mark.parametrize("C,dims", WIDTHS, ids=[str(c) for c, _ in WIDTHS])
def test_decode_width_rule_takes(C, dims):
    for D in dims:
        assert _util.decode_width_ok(C, C // D)
        assert _util.check_decode_width(C, C // D, "k") == D


def test_decode_width_rule_refuses():
    """C = 2080 (65 heads of 32) is past the ring's 256 rows of an item of
    4 tokens, and a head width the kernels lack is refused, each naming
    its limit; the LN rows end at 2048 as well."""
    assert not _util.decode_width_ok(2080, 65)
    with pytest.raises(ValueError, match="C <= 2048"):
        _util.check_decode_width(2080, 65, "decode attention kernel")
    assert not _util.decode_width_ok(1600, 20)  # heads of 80
    with pytest.raises(ValueError, match="head_dim 32, 64, 72 or 128"):
        _util.check_decode_width(1600, 20, "decode attention kernel")
    assert _util.DECODE_MAX_C == tk.LN_MAX_C == 2048
