"""GENIE_35M's widths through both packages, on the CPU.

configs/genie_35m.json, the reference's shipped config, is loaded by each
package's `GenieConfig.from_pretrained` and cut to 2 layers and T = 4 (2
prompt frames), fp32 and no remat; every width stays: d_model 256, 8 heads
of 32, S = 256 (16 x 16 tokens), MLP 1024, the factored 2 x 512
vocabulary. Weights drawn with numpy from a seed go into the JAX model and,
through `params_from_jax`, into the port's, whose ops take their plain
versions on CPU tensors; the JAX side runs its Pallas kernels in interpret
mode (serving, and the train blocks under `jax.grad`). Held to each other,
at the existing parity tests' fp32 tolerances: the logits, loss and
accuracy (tests/test_torch_train.py: atol 2e-4, rtol 2e-3; 1e-5), the
cached rollout's tokens at temperature 0 with greedy unmasking, exact, and
its logits (tests/test_torch_serving.py), and one train step's loss and
every parameter's gradient (atol 2e-5 + rtol 2e-3).
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
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
CONFIG = Path(__file__).resolve().parent.parent / "configs" / "genie_35m.json"
CUT = dict(num_layers=2, T=4, num_prompt_frames=2, dtype="float32",
           remat=False)
B = 1


def configs(**jax_only):
    """The JSON through each package's config, cut to CUT."""
    jcfg = dataclasses.replace(JaxConfig.from_pretrained(CONFIG), **CUT,
                               **jax_only)
    cfg = dataclasses.replace(GenieConfig.from_pretrained(CONFIG), **CUT)
    return jcfg, cfg


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
        s = (1.0 if "out_x_proj" in name or "embed" in name
             else 0.02 if name.endswith("bias") else 0.05)
        return (s * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def genie35m():
    jcfg, cfg = configs()
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.S,
            cfg.factored_vocab_size) == (256, 8, 32, 256, 512)
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


def as_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_logits_loss_and_acc(genie35m):
    jcfg, cfg = genie35m["jcfg"], genie35m["cfg"]
    ids, labels = batch(cfg, 1)
    want = JaxModel(jcfg).apply({"params": as_jnp(genie35m["np_params"])},
                                jnp.asarray(ids), jnp.asarray(labels))
    with torch.no_grad():
        got = genie35m["model"](torch.from_numpy(ids).long(),
                                torch.from_numpy(labels).long())
    assert tuple(got["logits"].shape) == (B, cfg.T, cfg.S, 512, 2)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=2e-3)
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-5, err_msg=key)


def test_greedy_cached_rollout_tokens(genie35m):
    jcfg, cfg = genie35m["jcfg"], genie35m["cfg"]
    rng = np.random.default_rng(2)
    side = cfg.latent_side_len
    prompt = rng.integers(0, cfg.image_vocab_size,
                          (B, cfg.num_prompt_frames, side, side))
    prompt_flat = prompt.reshape(B, -1).astype(np.int32)
    new = cfg.T - cfg.num_prompt_frames
    jsp = jax_prepare(as_jnp(genie35m["np_params"]),
                      compute_dtype=jnp.float32)
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

    sp = prepare_serving_params(genie35m["model"], cfg,
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
    engine = RolloutEngine(genie35m["model"], cfg, device="cpu",
                           unmask_mode="greedy")
    out = engine.rollout(torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(out[:, 0].reshape(B, -1).numpy(),
                                  np.asarray(want_tokens))


def test_train_step_loss_and_every_gradient(genie35m):
    """The loss through the JAX package's Pallas train kernels (interpret
    mode) and its gradient with respect to every parameter, against the
    port's plain train blocks under autograd."""
    cfg = genie35m["cfg"]
    jcfg, _ = configs(attn_impl="pallas")
    ids, labels = batch(cfg, 3)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels))["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        as_jnp(genie35m["np_params"]))
    want = params_from_jax(jax.device_get(jgrads), cfg)
    model = STMaskGIT(cfg)
    model.load_state_dict(genie35m["model"].state_dict())
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               atol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)
