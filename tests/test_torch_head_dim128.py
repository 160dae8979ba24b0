"""Head_dim 128 through both packages, on the CPU.

GENIE_138M-h128 is configs/genie_138m.json loaded by each package's
`GenieConfig.from_pretrained` with 4 heads (head_dim 128: muP's base head
count halved at twice its base width, the head width of most public
transformers at scale), cut to 2 layers and T = 4 (2 prompt frames), fp32
and no remat; every width stays: d_model 512, 4 heads of 128, S = 256 (16
x 16 tokens), MLP 2048, the factored 2 x 512 vocabulary. Weights drawn
with numpy from a seed go into the JAX model and, through
`params_from_jax`, into the port's, whose ops take their plain versions on
CPU tensors; the JAX side runs its Pallas kernels in interpret mode. Held
to each other at tests/test_torch_head_dim64.py's fp32 tolerances: the
logits, loss and accuracy (atol 2e-4, rtol 2e-3; 1e-5), the cached
rollout's tokens at temperature 0 with greedy unmasking, exact, and its
logits, one train step's loss and every parameter's gradient (atol 2e-5 +
rtol 2e-3), `score_policies` (rtol 1e-4, as tests/test_torch_eval.py) and
a muP forward (`use_mup`: the attention scale 8 / 128 = 0.0625, not
128^-0.5), its logits and loss at the first test's tolerances.

Then the contract the card wrappers check before a launch: head_dim 32, 64
or 128 taken. Each attention op at head_dim 128 against its JAX kernel is
a case of its own ops test (the `h128` ids of tests/test_torch_ops.py,
test_torch_decode_attention.py, test_torch_decode90.py,
test_torch_temporal90.py, test_torch_flash_residuals.py), the qk_norm
op-by-op engine with the int8 cache at head_dim 128 one of
tests/test_torch_qk_norm.py, and the model axis at head_dim 64 and 128
(tp = 2) cases of tests/test_torch_tensor_parallel.py.
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
from tpu1x.rollout.engine import RolloutEngine as JaxRollout
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.ops import _util
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops import decode_attention as tdec
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "genie_138m.json"
HEADS = 4
CUT = dict(num_layers=2, T=4, num_prompt_frames=2, dtype="float32",
           remat=False)
B = 1


def configs(**jax_only):
    """The JSON through each package's config, at 4 heads, cut to CUT."""
    jcfg = dataclasses.replace(JaxConfig.from_pretrained(CONFIG),
                               num_heads=HEADS, **CUT, **jax_only)
    cfg = dataclasses.replace(GenieConfig.from_pretrained(CONFIG),
                              num_heads=HEADS, **CUT)
    return jcfg, cfg


# tests/test_torch_head_dim64.py's weight scales (fan-in scaling from
# tests/test_torch_genie35m.py's at d_model 256).
FAN_IN = (256 / 512) ** 0.5


def random_tree(tree, seed):
    """Every leaf drawn with numpy; the head and embeddings at large scales,
    so that the logits have clear winners over the 512 values of a factor
    and greedy decoding decides no near-tie."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = np.shape(leaf)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        s = (1.0 if "embed" in name else 0.02 if name.endswith("bias")
             else FAN_IN if "out_x_proj" in name else 0.05 * FAN_IN)
        return (s * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def as_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def h128():
    jcfg, cfg = configs()
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.S,
            cfg.factored_vocab_size) == (512, 4, 128, 256, 512)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    tree = JaxModel(jcfg).init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    np_params = random_tree(jax.device_get(tree), 0)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    return dict(jcfg=jcfg, cfg=cfg, np_params=np_params, model=model)


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


# --------------------------------------------------------- GENIE_138M-h128

def test_logits_loss_and_acc(h128):
    jcfg, cfg = h128["jcfg"], h128["cfg"]
    ids, labels = batch(cfg, 1)
    want = JaxModel(jcfg).apply({"params": as_jnp(h128["np_params"])},
                                jnp.asarray(ids), jnp.asarray(labels))
    with torch.no_grad():
        got = h128["model"](torch.from_numpy(ids).long(),
                           torch.from_numpy(labels).long())
    assert tuple(got["logits"].shape) == (B, cfg.T, cfg.S, 512, 2)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=2e-3)
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-5, err_msg=key)


def test_greedy_cached_rollout_tokens(h128):
    jcfg, cfg = h128["jcfg"], h128["cfg"]
    rng = np.random.default_rng(2)
    side = cfg.latent_side_len
    prompt = rng.integers(0, cfg.image_vocab_size,
                          (B, cfg.num_prompt_frames, side, side))
    prompt_flat = prompt.reshape(B, -1).astype(np.int32)
    new = cfg.T - cfg.num_prompt_frames
    jsp = jax_prepare(as_jnp(h128["np_params"]), compute_dtype=jnp.float32)
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

    engine = RolloutEngine(h128["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    sp = prepare_serving_params(h128["model"], cfg,
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
    out = engine.rollout(torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  np.asarray(want_tokens))


def test_train_step_loss_and_every_gradient(h128):
    """The loss through the JAX package's Pallas train kernels (interpret
    mode) and its gradient with respect to every parameter, against the
    port's plain train blocks under autograd."""
    cfg = h128["cfg"]
    jcfg, _ = configs(attn_impl="pallas")
    ids, labels = batch(cfg, 3)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels))["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(as_jnp(h128["np_params"]))
    want = params_from_jax(jax.device_get(jgrads), cfg)
    model = STMaskGIT(cfg)
    model.load_state_dict(h128["model"].state_dict())
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               atol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)


def test_score_policies(h128):
    """Two policies of 2 frames each after one shared context frame: the
    per-frame CE and the scores."""
    cfg, side = h128["cfg"], h128["cfg"].latent_side_len
    rng = np.random.default_rng(5)
    T_ctx, P = 2, 2
    ctx = rng.integers(0, cfg.image_vocab_size,
                       (T_ctx, side, side)).astype(np.int32)
    conts = rng.integers(0, cfg.image_vocab_size,
                         (P, cfg.T - T_ctx, side, side)).astype(np.int32)
    got = RolloutEngine(h128["model"], cfg, device="cpu").score_policies(
        torch.from_numpy(ctx).long(), torch.from_numpy(conts).long(),
        per_frame=True)
    want = JaxRollout(JaxModel(h128["jcfg"]), as_jnp(h128["np_params"]),
                      h128["jcfg"]).score_policies(
        jnp.asarray(ctx), jnp.asarray(conts), per_frame=True)
    assert tuple(got[1].shape) == (P, cfg.T - T_ctx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)


def test_mup_forward(h128):
    """`use_mup` in both packages, the same weights: at head_dim 128 the
    attention scale 8 / head_dim (0.0625) differs from head_dim^-0.5
    (0.0884), and the readout divides by the width multiplier (2)."""
    jcfg, cfg = (dataclasses.replace(c, use_mup=True)
                 for c in (h128["jcfg"], h128["cfg"]))
    ids, labels = batch(cfg, 4)
    want = JaxModel(jcfg).apply({"params": as_jnp(h128["np_params"])},
                                jnp.asarray(ids), jnp.asarray(labels))
    model = STMaskGIT(cfg)
    model.load_state_dict(h128["model"].state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(labels).long())
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-5)


# ------------------------------------------------------------ the contract

def test_contract_takes_head_dim_128():
    """The checks before a launch take head_dim 128 where they took 32 and
    64: K4/K6 two heads of 128 (C % 256), K9/K10, the decode ring."""
    assert _util.head_dim_of(512, 4, "k") == 128
    assert _util.head_dim_of(256, 2, "k") == 128
    qkv = torch.zeros(2, 16, 4, 3 * 512, dtype=torch.bfloat16)
    assert ta._check_qkv(*qkv.split(512, dim=-1), 4) == 3 * 512
    qkv = torch.zeros(2, 16, 4, 3 * 256, dtype=torch.bfloat16)
    assert ta._check_qkv(*qkv.split(256, dim=-1), 2) == 3 * 256
    tattn._check_shape(*(torch.zeros(2, 256, 4, 128),) * 3)
    qs = torch.zeros(2, 8, 3 * 512, dtype=torch.bfloat16).split(512, dim=-1)
    cache = torch.zeros(16, 2, 2, 8, 512, dtype=torch.bfloat16)
    strides = tdec._check((qs[0],), (qs[1],), (qs[2],), cache, cache,
                          torch.zeros(2, dtype=torch.int32), 1, None, None,
                          None, None, 4)
    assert strides == [(8 * 3 * 512, 3 * 512)] * 3


def test_contract_refuses_one_head_of_128():
    """One head of 128 a rank (C = 128, GENIE_138M-h128 at tp = 4), which
    K4/K6 refused before their head group of 1, is taken now; one head of a
    width no kernel has (256) is still refused before a launch, naming the
    widths there are."""
    qkv = torch.zeros(2, 16, 4, 3 * 128, dtype=torch.bfloat16)
    assert ta._check_qkv(*qkv.split(128, dim=-1), 1) == 3 * 128
    qkv = torch.zeros(2, 16, 4, 3 * 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32, 64, 72 or 128"):
        ta._check_qkv(*qkv.split(256, dim=-1), 1)
