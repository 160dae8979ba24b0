"""Head_dim 72 through both packages, on the CPU.

GENIE_138M-h72 is configs/genie_138m.json loaded by each package's
`GenieConfig.from_pretrained` at d_model 1152 in 16 heads of 72 (the
width and head split of DiT-XL/2 and Latte-XL), 28 layers. Here it is
cut to d_model 144 in 2 heads of 72, 2 layers, S = 64 (8 x 8 tokens), T =
4 (2 prompt frames), fp32 and no remat; the head width, the MLP ratio and
the factored 2 x 512 vocabulary stay. Weights are drawn with numpy from a
seed, fan-in scaled as tests/test_torch_widths.py draws them, into the
JAX model and, through `params_from_jax`, into the port's, whose ops take
their plain versions on CPU tensors; the JAX side runs its Pallas
kernels in interpret mode. Held to each other at test_torch_widths.py's
fp32 tolerances: the logits, loss and accuracy (atol 2e-4, rtol 2e-3;
1e-5), the cached rollout's tokens at temperature 0 with greedy
unmasking, exact, and its logits, through `RolloutEngine` too, and one
train step's loss and every parameter's gradient (atol 2e-5 + rtol
2e-3).

Then the contract the card wrappers check before a launch: head_dim 72
taken by every attention wrapper (C = 1152 and 2016 by the decode ring's
width rule), head_dim 80 refused, naming the widths there are. Each
attention op at head_dim 72 against its JAX kernel is a case of its own
ops test (the `h72` ids of tests/test_torch_ops.py,
test_torch_decode_attention.py, test_torch_decode90.py,
test_torch_temporal90.py, test_torch_flash_residuals.py and
test_torch_train_blocks90.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_widths import as_jnp, batch, build, configs, logits_and_loss
from tpu1x.models.sampler import generate_cached_fused as jax_fused
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.serving import DecodeEngine as JaxEngine
from tpu1x.serving import prepare_serving_params as jax_prepare
from tpu1x_torch import kernels
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.ops import _util
from tpu1x_torch.ops import attention as tattn
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
# GENIE_138M-h72 cut for the CPU: 2 heads of 72
H72 = dict(d_model=144, num_heads=2, num_layers=2, S=64, T=4,
           num_prompt_frames=2, dtype="float32", remat=False)
B = 1


@pytest.fixture(scope="module")
def h72():
    got = build(H72, 0)
    cfg = got["cfg"]
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.S,
            cfg.factored_vocab_size) == (144, 2, 72, 64, 512)
    return got


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


# --------------------------------------------------------- GENIE_138M-h72

def test_logits_loss_and_acc(h72):
    logits_and_loss(h72, 1)


def test_greedy_cached_rollout_tokens(h72):
    jcfg, cfg = h72["jcfg"], h72["cfg"]
    rng = np.random.default_rng(2)
    side = cfg.latent_side_len
    prompt = rng.integers(0, cfg.image_vocab_size,
                          (B, cfg.num_prompt_frames, side, side))
    prompt_flat = prompt.reshape(B, -1).astype(np.int32)
    new = cfg.T - cfg.num_prompt_frames
    jsp = jax_prepare(as_jnp(h72["np_params"]), compute_dtype=jnp.float32)
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

    sp = prepare_serving_params(h72["model"], cfg,
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
    engine = RolloutEngine(h72["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    out = engine.rollout(torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  np.asarray(want_tokens))


def test_train_step_loss_and_every_gradient(h72):
    """The loss through the JAX package's Pallas train kernels (interpret
    mode) and its gradient with respect to every parameter, against the
    port's plain train blocks under autograd."""
    cfg = h72["cfg"]
    jcfg, _ = configs(H72, attn_impl="pallas")
    ids, labels = batch(cfg, 3)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels))["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(as_jnp(h72["np_params"]))
    want = params_from_jax(jax.device_get(jgrads), cfg)
    model = STMaskGIT(cfg)
    model.load_state_dict(h72["model"].state_dict())
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               atol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)


# ------------------------------------------------------------ the contract

@pytest.mark.parametrize("C,heads", [(1152, 16), (2016, 28), (576, 8),
                                     (144, 2)])
def test_contract_takes_head_dim_72(C, heads):
    """Every check before a launch takes head_dim 72: the head-width rule,
    the decode ring's width rule (GENIE_138M-h72's 1152, the widest C of
    72 it takes, 2016, and a tp = 2 rank's 576), K4/K6's and K9/K10's
    shape checks."""
    assert _util.head_dim_of(C, heads, "k") == 72
    assert _util.decode_width_ok(C, heads)
    assert _util.check_decode_width(C, heads, "k") == 72
    qkv = torch.zeros(2, 16, 4, 3 * C, dtype=torch.bfloat16)
    assert ta._check_qkv(*qkv.split(C, dim=-1), heads) == 3 * C
    tattn._check_shape(*(torch.zeros(2, 64, heads, 72),) * 3)


def test_contract_refuses_head_dim_80():
    """Heads of 80 (1600 in 20), which no kernel has, are refused by every
    check before a launch, naming the widths there are, with no
    fallback."""
    message = "head_dim 32, 64, 72 or 128"
    assert _util.HEAD_DIMS == (32, 64, 72, 128)
    assert not _util.decode_width_ok(1600, 20)
    for check in (_util.head_dim_of, _util.check_decode_width):
        with pytest.raises(ValueError, match=message):
            check(1600, 20, "kernel")
    qkv = torch.zeros(2, 16, 4, 3 * 1600, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=message):
        ta._check_qkv(*qkv.split(1600, dim=-1), 20)
    with pytest.raises(ValueError, match=message):
        tattn._check_shape(*(torch.zeros(2, 64, 20, 80),) * 3)
