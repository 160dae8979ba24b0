"""The port's training slice against the JAX package, end to end on the CPU.

At a tiny fp32 config (2 layers, d_model 32, 2 heads, T=4, S=16, factored
2 x 8 vocabulary) weights drawn with numpy from a seed go into the JAX model
and, through `params_from_jax`, into the port's, where every train block
takes its plain version under ordinary autograd. Held to each other: the
logits, loss and accuracy; the gradient of every parameter (the JAX side
through its Pallas train kernels in interpret mode and through its XLA
path); the corruption given the same ten draws; the schedules; one
optimizer step; and a 50-step loss trajectory. Tolerances are stated at each
test; all are fp32 with sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.data.corruption import maskgit_corrupt as jax_corrupt
from tpu1x.model_zoo import genie_tiny as jax_tiny
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.train.optim import build_lr_schedule as jax_schedule
from tpu1x.train.optim import build_optimizer as jax_optimizer
from tpu1x.train.step import TrainState as JaxTrainState
from tpu1x.train.step import make_train_step as jax_train_step
from tpu1x_torch import kernels
from tpu1x_torch.data.corruption import NOISE_KEYS, maskgit_corrupt
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.st_maskgit import (STMaskGIT,
                                           logits_to_reference_layout)
from tpu1x_torch.train.optim import TrainOptimizer, build_lr_schedule
from tpu1x_torch.train.step import make_eval_step, make_train_step
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
SIZE = dict(T=4, num_prompt_frames=2, num_heads=2, d_model=32)
B = 2


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def random_tree(tree, seed):
    """Replace every leaf of a flax tree with numpy draws."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = np.shape(leaf)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        s = 0.05 if name.endswith("bias") else 0.1
        return (s * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def setup(seed=0, **overrides):
    """(jax config, port config, numpy flax tree, port model)."""
    jax_only = {k: overrides.pop(k) for k in ("scan_layers", "attn_impl")
                if k in overrides}
    jcfg = jax_tiny(**SIZE, remat=False, **overrides, **jax_only)
    cfg = genie_tiny(**SIZE, **overrides)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    act = (jnp.zeros((1, jcfg.T), jnp.int32)
           if jcfg.action_vocab_size else None)
    tree = JaxModel(jcfg).init(jax.random.PRNGKey(0), dummy, dummy,
                               act)["params"]
    np_params = random_tree(jax.device_get(tree), seed)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(np_params, cfg))
    return jcfg, cfg, np_params, model


def batch(cfg, seed, actions=False):
    """A corrupted batch made with numpy: input_ids with some masked
    positions in frames 1 onward, labels clean."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.image_vocab_size, (B, cfg.T * cfg.S))
    ids = labels.copy().reshape(B, cfg.T, cfg.S)
    ids[:, 1:][rng.random((B, cfg.T - 1, cfg.S)) < 0.4] = cfg.mask_token_id
    act = (rng.integers(0, cfg.action_vocab_size, (B, cfg.T))
           if actions else None)
    return ids.reshape(B, -1).astype(np.int32), labels.astype(np.int32), act


def as_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tensor(a):
    return None if a is None else torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("kw", [
    dict(),                                       # the shipped config's shape
    dict(qk_norm=True),                           # identity pre-norms, qk-LN
    dict(use_mup=True, mup_base_d_model=16),      # readout / 2, 8 / hd scale
    dict(scan_layers=False, qkv_bias=True),       # unrolled flax layout
    dict(action_vocab_size=5, gelu_approx=True),  # action embedding, tanh
], ids=lambda kw: "-".join(kw) or "default")
def test_logits_loss_and_acc(kw):
    """logits atol 2e-4, rtol 2e-3 (as tests/test_torch_parity.py); loss and
    acc atol 1e-5."""
    jcfg, cfg, np_params, model = setup(**kw)
    ids, labels, act = batch(cfg, 1, actions=bool(cfg.action_vocab_size))
    want = JaxModel(jcfg).apply(
        {"params": as_jnp(np_params)}, jnp.asarray(ids), jnp.asarray(labels),
        None if act is None else jnp.asarray(act, jnp.int32))
    with torch.no_grad():
        got = model(tensor(ids), tensor(labels), tensor(act))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(got["acc"]), float(want["acc"]),
                               atol=1e-5)
    side = cfg.latent_side_len
    ref = logits_to_reference_layout(got["logits"], side, side)
    assert tuple(ref.shape) == (B, 2 * cfg.factored_vocab_size, cfg.T, side,
                                side)
    assert torch.equal(ref[0, cfg.factored_vocab_size + 3, 1, 2, 1],
                       got["logits"][0, 1, 2 * side + 1, 3, 1])


@pytest.mark.parametrize("attn_impl,kw", [
    ("pallas", dict()),   # the three Pallas train kernels, interpret mode
    ("xla", dict()),
    ("xla", dict(qk_norm=True)),
    ("pallas", dict(use_mup=True, mup_base_d_model=16, qkv_bias=True,
                    action_vocab_size=5)),
], ids=["pallas", "xla", "xla-qk_norm", "pallas-mup-bias-actions"])
def test_every_parameter_gradient(attn_impl, kw):
    """d loss / d parameter for every parameter: atol 2e-5 + rtol 2e-3 of
    the gradient (fp32; the Pallas MLP kernel's rational erf against erf
    itself is inside that)."""
    jcfg, cfg, np_params, model = setup(attn_impl=attn_impl, **kw)
    ids, labels, act = batch(cfg, 2, actions=bool(cfg.action_vocab_size))
    jact = None if act is None else jnp.asarray(act, jnp.int32)

    def loss_fn(params):
        return JaxModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                                    jnp.asarray(labels), jact)["loss"]

    want = params_from_jax(jax.device_get(jax.grad(loss_fn)(
        as_jnp(np_params))), cfg)
    model(tensor(ids), tensor(labels), tensor(act))["loss"].backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=2e-3, err_msg=name)


def jax_noise(rng, shape, cfg):
    """The ten draws that `tpu1x.data.corruption.maskgit_corrupt` makes from
    `rng`, as numpy arrays under the port's names."""
    Bn, T, H, W = shape
    F, V = cfg.num_factored_vocabs, cfg.factored_vocab_size
    k = jax.random.split(rng, 10)
    draws = (
        jax.random.uniform(k[0]),
        jax.random.uniform(k[1], (Bn, T, H, W, F)),
        jax.random.randint(k[2], (Bn, T, H, W, F), 0, V, dtype=jnp.int32),
        jax.random.uniform(k[3]),
        jax.random.randint(k[4], (), cfg.num_prompt_frames, T,
                           dtype=jnp.int32),
        jax.random.uniform(k[5], (), minval=0.25, maxval=1.0),
        jax.random.uniform(k[6], (T,), minval=0.9, maxval=1.0),
        jax.random.uniform(k[7], (Bn, T, H, W, F)),
        jax.random.uniform(k[8], (Bn, T)),
        jax.random.uniform(k[9], (Bn, T, H, W)))
    return {name: torch.from_numpy(np.array(d))
            for name, d in zip(NOISE_KEYS, draws)}


CORRUPT_SEEDS = (0, 1, 6, 10, 12, 14)


@pytest.mark.parametrize("seed", CORRUPT_SEEDS)
def test_maskgit_corrupt_same_draws(seed):
    """Identical `input_ids` and labels from the same ten draws; the seeds
    cover both the MLM and the non-MLM branch."""
    jcfg, cfg = jax_tiny(**SIZE), genie_tiny(**SIZE)
    side = cfg.latent_side_len
    tokens = np.random.default_rng(seed).integers(
        0, cfg.image_vocab_size, (B, cfg.T, side, side)).astype(np.int32)
    rng = jax.random.PRNGKey(seed)
    want = jax_corrupt(jnp.asarray(tokens), rng, jcfg)
    noise = jax_noise(rng, tokens.shape, cfg)
    got = maskgit_corrupt(torch.from_numpy(tokens), noise, cfg)
    for key in ("input_ids", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_corruption_seeds_cover_both_branches():
    cfg = genie_tiny(**SIZE)
    draws = {bool(jax.random.uniform(jax.random.split(
        jax.random.PRNGKey(seed), 10)[3]) < cfg.non_mlm_ratio)
        for seed in CORRUPT_SEEDS}
    assert draws == {True, False}


def test_maskgit_corrupt_masks_at_least_one_token():
    """Draws that mask nothing: the position closest to its threshold is
    masked, and only that one."""
    cfg = genie_tiny(**SIZE)
    side = cfg.latent_side_len
    shape = (B, cfg.T, side, side)
    tokens = torch.zeros(shape, dtype=torch.long)
    noise = jax_noise(jax.random.PRNGKey(0), shape, cfg)
    noise["u_non_mlm"] = torch.tensor(1.0)   # the MLM branch
    noise["u_rate"] = torch.tensor(0.0)      # no corruption
    noise["r_mask"] = torch.full(shape, 2.0)  # above every mask probability
    noise["r_mask"][1, 2, 3, 0] = 1.5
    ids = maskgit_corrupt(tokens, noise, cfg)["input_ids"].reshape(shape)
    masked = (ids == cfg.mask_token_id).nonzero().tolist()
    # frame 2 of example 1 has the smallest r_mask - mask_prob there is
    u = noise["u_mask"]
    margin = torch.cos(u * (np.pi / 2))[:, :, None, None] - noise["r_mask"]
    margin[:, 0] = -np.inf
    assert masked == [list(np.unravel_index(int(margin.argmax()), shape))]


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup",
                                  "linear", "cosine", "custom_cosine"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedules(name, warmup):
    """Each schedule at a few steps: rtol 1e-6 plus 1e-6 of the peak (the JAX
    side computes in fp32, and the cosine cancels near its end)."""
    want = jax_schedule(name, 3e-4, warmup, 20)
    got = build_lr_schedule(name, 3e-4, warmup, 20)
    for step in (0, 1, 4, 5, 6, 12, 19, 20, 30):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=3e-10, err_msg=f"step {step}")


def run_both(steps, opt_kw, seed=0, **cfg_kw):
    """`steps` train steps of each package from the same weights, token
    batches and corruption draws. Returns (per-step metrics of each, final
    parameters of each by the port's names)."""
    jcfg, cfg, np_params, model = setup(seed=seed, attn_impl="xla", **cfg_kw)
    tx = jax_optimizer(jcfg, **opt_kw)
    params = as_jnp(np_params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(7))
    jstep = jax_train_step(JaxModel(jcfg), tx, jcfg, donate=False)
    step = make_train_step(model, TrainOptimizer(model, cfg, **opt_kw), cfg,
                           device="cpu")
    side = cfg.latent_side_len
    rng = np.random.default_rng(seed + 100)
    jm, tm = [], []
    for i in range(steps):
        tokens = rng.integers(0, cfg.image_vocab_size,
                              (B, cfg.T, side, side)).astype(np.int32)
        noise = jax_noise(jax.random.fold_in(state.rng, i), tokens.shape, cfg)
        state, m = jstep(state, jnp.asarray(tokens))
        jm.append({k: float(v) for k, v in m.items()})
        out = step(torch.from_numpy(tokens), noise=noise)
        tm.append({k: float(v) for k, v in out.items()})
    assert step.state.step == steps
    want = params_from_jax(jax.device_get(state.params), cfg)
    got = {n: p.detach() for n, p in model.named_parameters()}
    return jm, tm, want, got, (model, cfg)


def test_one_train_step():
    """Loss, grad norm (rtol 1e-5) and every parameter after one clipped
    AdamW update with weight decay: atol 5e-6 at a learning rate of 1e-3,
    0.5% of the largest possible step."""
    opt = dict(learning_rate=1e-3, weight_decay=0.1, max_grad_norm=0.5,
               lr_scheduler_type="cosine", num_warmup_steps=2,
               num_training_steps=10)
    jm, tm, want, got, (model, cfg) = run_both(1, opt)
    assert jm[0]["grad_norm"] > 0.5  # the clip is active
    for key in ("loss", "acc", "grad_norm"):
        np.testing.assert_allclose(tm[0][key], jm[0][key], rtol=1e-5,
                                   err_msg=key)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=5e-6, rtol=0, err_msg=name)
    # the eval step: the training corruption, no update
    before = {n: p.clone() for n, p in got.items()}
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (B, cfg.T, side, side))
    ev = make_eval_step(model, cfg, device="cpu")(
        tokens, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(ev["loss"])) and 0.0 <= float(ev["acc"]) <= 1.0
    assert all(torch.equal(before[n], got[n]) for n in got)


@pytest.mark.parametrize("accumulate,mup", [(1, False), (2, True)],
                         ids=["plain", "accumulate2-mup"])
def test_loss_trajectory_50_steps(accumulate, mup):
    """50 steps, weight decay on, clip active, warmup then cosine decay;
    one case accumulates over 2 micro-batches under muP's two learning-rate
    groups. Loss within 2e-4 at every step (rounding differences feed
    forward through AdamW), parameters within 2e-4 at the end."""
    opt = dict(learning_rate=2e-3, weight_decay=0.05, max_grad_norm=0.3,
               lr_scheduler_type="custom_cosine", num_warmup_steps=5,
               num_training_steps=50 // accumulate,
               gradient_accumulation_steps=accumulate, mu_transfer=mup)
    kw = dict(use_mup=True, mup_base_d_model=16) if mup else {}
    jm, tm, want, got, _ = run_both(50, opt, **kw)
    assert max(m["grad_norm"] for m in jm) > 0.3
    np.testing.assert_allclose([m["loss"] for m in tm],
                               [m["loss"] for m in jm], atol=2e-4, rtol=0)
    np.testing.assert_allclose([m["grad_norm"] for m in tm],
                               [m["grad_norm"] for m in jm], rtol=2e-3)
    assert jm[-1]["loss"] < jm[0]["loss"]
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=2e-4, rtol=0, err_msg=name)


def test_train_step_defaults_to_the_card():
    """No card here: the default device raises; nothing falls back."""
    cfg = genie_tiny(**SIZE)
    model = STMaskGIT(cfg)
    opt = TrainOptimizer(model, cfg, learning_rate=1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_train_step(model, opt, cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            make_eval_step(model, cfg)


def test_unported_training_paths_raise():
    """Dropout is not ported: a rate above 0 raises in training mode and is
    ignored in eval mode, as dropout is."""
    cfg = genie_tiny(**SIZE, mlp_drop=0.1)
    model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
    ids, labels, _ = batch(cfg, 0)
    with pytest.raises(NotImplementedError, match="dropout"):
        model.train()(tensor(ids), tensor(labels))
    out = model.eval()(tensor(ids), tensor(labels))
    assert np.isfinite(float(out["loss"].detach()))
