"""The port's evaluation path against the JAX package's, on the CPU.

At genie_tiny(T=4) in fp32 (the JAX evaluator tests' size), weights drawn
with numpy from a seed go into the JAX model and, through
`params_from_jax`, into the port, where every op takes its plain version.
Held: the factored ids and labels, the metrics, the uncached sampler
(`maskgit_generate`, `generate`; greedy unmasking, so that no random draw
enters: tokens equal, step-0 logits atol 1e-4 rtol 1e-3), `score_policies`
(rtol 1e-4) and `rank_policies`, `RolloutEngine(decode="full")`, the
evaluator's cached and rows paths (logits atol 1e-4 rtol 1e-3; samples
equal at maskgit_steps=1, where no random draw decides a token, since the
port cannot reproduce `jax.random`; also for qk_norm), `evaluate_dataset`
with a padded tail batch, and `load_model_checkpoint` from directories the
JAX package writes.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.data.token_store import RawTokenDataset as JaxDataset
from tpu1x.data.token_store import write_token_dataset as jax_write
from tpu1x.eval import metrics as jax_metrics
from tpu1x.eval.evaluate import GenieEvaluator as JaxEvaluator
from tpu1x.eval.evaluate import evaluate_dataset as jax_evaluate_dataset
from tpu1x.model_zoo import genie_tiny as jax_tiny
from tpu1x.models import factorization as jax_fact
from tpu1x.models import sampler as jax_sampler
from tpu1x.models.st_maskgit import STMaskGIT as JaxModel
from tpu1x.rollout.engine import RolloutEngine as JaxRollout
from tpu1x.train.checkpoint import save_pretrained, save_pretrained_torch
from tpu1x_torch import kernels
from tpu1x_torch.data.token_store import RawTokenDataset
from tpu1x_torch.eval import metrics
from tpu1x_torch.eval.evaluate import (GenieEvaluator, evaluate_dataset,
                                       load_model_checkpoint)
from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models import factorization as fact
from tpu1x_torch.models import sampler
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.weights import params_from_jax

torch.set_num_threads(2)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-3)
B = 3


def random_tree(tree, seed):
    """Every leaf drawn with numpy; the head and embeddings get large
    scales, so that logits are far from uniform and greedy argmax has clear
    winners."""
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


def build(seed=0, **overrides):
    jcfg, cfg = jax_tiny(T=4, **overrides), genie_tiny(T=4, **overrides)
    jmodel = JaxModel(jcfg)
    dummy = jnp.zeros((1, jcfg.T * jcfg.S), jnp.int32)
    act = (jnp.zeros((1, jcfg.T), jnp.int32)
           if jcfg.action_vocab_size else None)
    tree = jmodel.init(jax.random.PRNGKey(0), dummy, dummy, act)["params"]
    params = random_tree(jax.device_get(tree), seed)
    model = STMaskGIT(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.image_vocab_size, (B, cfg.T * cfg.S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params,
                jparams=jax.tree_util.tree_map(jnp.asarray, params),
                model=model.eval(), tokens=tokens)


@pytest.fixture(scope="module")
def tiny():
    return build()


@pytest.fixture(scope="module")
def tiny_qk():
    return build(seed=2, qk_norm=True)


@pytest.fixture(scope="module")
def tiny_actions():
    return build(seed=4, action_vocab_size=5)


@pytest.fixture(autouse=True)
def no_launches():
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def t(a):
    return torch.from_numpy(np.array(a))


def jax_logits_fn(s, actions=None):
    return lambda x: s["jmodel"].apply({"params": s["jparams"]}, x, actions,
                                       method=JaxModel.compute_logits)


def test_factorization_matches_jax():
    ids = np.random.default_rng(0).integers(0, 512 ** 2, (2, 3, 4, 4))
    got = fact.factorize_labels(t(ids), 2, 512)
    want = jax_fact.factorize_labels(jnp.asarray(ids, jnp.int32), 2, 512)
    assert tuple(got.shape) == (2, 2, 3, 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    digits = fact.factorize_token_ids(t(ids), 2, 512)
    np.testing.assert_array_equal(
        fact.unfactorize_token_ids(digits, 2, 512).numpy(), ids)
    np.testing.assert_array_equal(
        fact.unfactorize_token_ids(digits, 2, 512).numpy(),
        np.asarray(jax_fact.unfactorize_token_ids(
            jnp.asarray(digits.numpy(), jnp.int32), 2, 512)))


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    V, Fv, T, h = 8, 2, 4, 3
    labels = rng.integers(0, V ** Fv, (2, T * h * h)).astype(np.int32)
    logits = rng.standard_normal((2, V, Fv, T - 1, h, h)).astype(np.float32)
    np.testing.assert_allclose(
        metrics.compute_loss(labels, logits, Fv, V),
        jax_metrics.compute_loss(labels, logits, Fv, V), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.compute_loss(t(labels), t(logits), Fv, V),
        jax_metrics.compute_loss(labels, logits, Fv, V), rtol=1e-6)
    gt = labels.reshape(2, T, h, h)
    samples = np.where(rng.random((2, T - 1, h, h)) < 0.4, gt[:, 1:], 0)
    assert (metrics.token_accuracy(gt, samples)
            == pytest.approx(jax_metrics.token_accuracy(gt, samples)))
    got, want = metrics.AvgMetric(), jax_metrics.AvgMetric()
    for m in (got, want):
        m.update(2.5, 3)
        m.update_list(np.array([1.0, 4.0]))
    assert (got.total, got.count, got.mean()) == (want.total, want.count,
                                                  want.mean())
    with pytest.raises(ValueError):
        metrics.compute_loss(labels, logits, Fv, V + 1)


def test_maskgit_generate_matches_jax(tiny):
    cfg, h = tiny["cfg"], tiny["cfg"].latent_side_len
    tokens = tiny["tokens"].reshape(B, cfg.T, h, h)
    out_t = np.array([1, 3, 2], np.int32)  # per row
    frame_idx = np.arange(cfg.T)[None, :, None, None]
    masked = np.where(frame_idx < out_t[:, None, None, None], tokens,
                      cfg.mask_token_id).astype(np.int32)
    kw = dict(maskgit_steps=3, temperature=0.0, unmask_mode="greedy")
    with torch.no_grad():
        got_s, got_l = sampler.maskgit_generate(
            tiny["model"].compute_logits, t(masked).long(), t(out_t), None,
            cfg, **kw)
    want_s, want_l = jax_sampler.maskgit_generate(
        jax_logits_fn(tiny), jnp.asarray(masked), jnp.asarray(out_t),
        jax.random.PRNGKey(0), tiny["jcfg"], **kw)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               **LOGITS_TOL)


def test_generate_matches_jax(tiny):
    cfg = tiny["cfg"]
    prompt = tiny["tokens"][:, :cfg.S]  # one prompt frame, three new
    kw = dict(maskgit_steps=2, temperature=0.0, unmask_mode="greedy")
    with torch.no_grad():
        got_t, got_l = sampler.generate(tiny["model"].compute_logits,
                                        t(prompt), 3, None, cfg, **kw)
    want_t, want_l = jax_sampler.generate(
        jax_logits_fn(tiny), jnp.asarray(prompt), 3, jax.random.PRNGKey(0),
        tiny["jcfg"], **kw)
    assert tuple(got_l.shape) == (B, cfg.factored_vocab_size, 2, 3, 4, 4)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               **LOGITS_TOL)


def test_full_decode_rollout_matches_jax_and_cached(tiny):
    """decode="full" against the JAX engine's at one MaskGIT step (no random
    draw), and against the port's cached rollout with greedy unmasking."""
    cfg, h = tiny["cfg"], tiny["cfg"].latent_side_len
    prompt = tiny["tokens"].reshape(B, cfg.T, h, h)[:, :2]
    got = RolloutEngine(tiny["model"], cfg, device="cpu", maskgit_steps=1,
                        decode="full").rollout(t(prompt), 2)
    want = JaxRollout(tiny["jmodel"], tiny["jparams"], tiny["jcfg"],
                      maskgit_steps=1, decode="full").rollout(
        jnp.asarray(prompt), 2, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    outs = [RolloutEngine(tiny["model"], cfg, device="cpu",
                          unmask_mode="greedy", decode=d).rollout(
        t(prompt), 2, num_futures=2) for d in ("full", "cached")]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    with pytest.raises(ValueError):
        RolloutEngine(tiny["model"], cfg, device="cpu", decode="fast")


@pytest.mark.parametrize("with_actions", [False, True])
def test_score_policies_match_jax(tiny, tiny_actions, with_actions):
    s = tiny_actions if with_actions else tiny
    cfg, h = s["cfg"], s["cfg"].latent_side_len
    rng = np.random.default_rng(5)
    T_ctx, P = 1, 4
    ctx = rng.integers(0, cfg.image_vocab_size, (T_ctx, h, h)).astype(np.int32)
    conts = rng.integers(0, cfg.image_vocab_size,
                         (P, cfg.T - T_ctx, h, h)).astype(np.int32)
    actions = (rng.integers(0, cfg.action_vocab_size, (P, cfg.T)).astype(
        np.int32) if with_actions else None)
    engine = RolloutEngine(s["model"], cfg, device="cpu")
    jengine = JaxRollout(s["jmodel"], s["jparams"], s["jcfg"])
    got = engine.score_policies(t(ctx), t(conts), None if actions is None
                                else t(actions), per_frame=True)
    want = jengine.score_policies(jnp.asarray(ctx), jnp.asarray(conts),
                                  None if actions is None
                                  else jnp.asarray(actions), per_frame=True)
    assert tuple(got[0].shape) == (P,)
    assert tuple(got[1].shape) == (P, cfg.T - T_ctx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
    np.testing.assert_allclose(
        engine.score_policies(t(ctx), t(conts), None if actions is None
                              else t(actions)).numpy(),
        got[1].numpy().mean(1), rtol=1e-6)


def test_rank_policies_match_jax(tiny):
    """A clear order: the head's bias favours digit 0 of both factors, so
    token 0 is likely everywhere, and continuation k has k eighths of its
    tokens random, the rest 0."""
    cfg, h = tiny["cfg"], tiny["cfg"].latent_side_len
    params = jax.tree_util.tree_map(np.array, tiny["params"])
    bias = params["out_x_proj"]["bias"]
    bias[::cfg.factored_vocab_size] += 6.0  # column f V + 0 of each factor
    state = params_from_jax(params, cfg)
    T_ctx, P = 2, 8
    rng = np.random.default_rng(6)
    ctx = np.zeros((T_ctx, h, h), np.int32)
    conts = np.zeros((P, cfg.T - T_ctx, h, h), np.int32)
    for k in range(P):
        cells = rng.permutation(conts[k].size)[:k * conts[k].size // P]
        conts[k].reshape(-1)[cells] = rng.integers(1, cfg.image_vocab_size,
                                                   len(cells))
    perm = rng.permutation(P)  # the best is not simply the first
    got = RolloutEngine(state, cfg, device="cpu").rank_policies(
        t(ctx), t(conts[perm]))
    want = JaxRollout(tiny["jmodel"], jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                      tiny["jcfg"]).rank_policies(jnp.asarray(ctx),
                                                  jnp.asarray(conts[perm]))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(perm[got], np.arange(P))


@pytest.mark.parametrize("which", ["pre_ln", "qk_norm"])
@pytest.mark.parametrize("use_cache", [True, False])
def test_evaluator_matches_jax(tiny, tiny_qk, which, use_cache):
    s = tiny if which == "pre_ln" else tiny_qk
    ev = GenieEvaluator(s["model"], s["cfg"], device="cpu", maskgit_steps=1,
                        rows_per_chunk=5, use_cache=use_cache)
    jev = JaxEvaluator(s["jmodel"], s["jparams"], s["jcfg"], maskgit_steps=1,
                       rows_per_chunk=5, use_cache=use_cache)
    got_s, got_l = ev.predict_zframe_logits(s["tokens"])
    want_s, want_l = jev.predict_zframe_logits(s["tokens"],
                                               jax.random.PRNGKey(0))
    assert got_l.shape == want_l.shape == (B, s["cfg"].factored_vocab_size,
                                           2, s["cfg"].T - 1, 4, 4)
    np.testing.assert_allclose(got_l, np.asarray(want_l), **LOGITS_TOL)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    if use_cache:  # CE and accuracy reduced where the logits lie
        got = ev.predict_metrics(s["tokens"])
        want = jev.predict_metrics(s["tokens"], jax.random.PRNGKey(0))
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-4)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    else:
        with pytest.raises(ValueError):
            ev.predict_metrics(s["tokens"])


def test_multi_step_logits_match_across_paths(tiny):
    """The step-0 logits, and so the CE, do not depend on the later steps'
    random draws: the cached and rows paths agree at three steps."""
    cfg = tiny["cfg"]
    logits = [GenieEvaluator(tiny["model"], cfg, device="cpu",
                             maskgit_steps=3, use_cache=c
                             ).predict_zframe_logits(tiny["tokens"])[1]
              for c in (True, False)]
    np.testing.assert_allclose(logits[0], logits[1], **LOGITS_TOL)


def test_evaluate_dataset_with_tail_batch_matches_jax(tiny, tmp_path):
    cfg, h = tiny["cfg"], tiny["cfg"].latent_side_len
    frames = tiny["tokens"].reshape(-1, h, h)
    jax_write(tmp_path, frames, vocab_size=cfg.image_vocab_size,
              segment_ids=np.zeros(len(frames), np.int32))
    kw = dict(window_size=cfg.T, stride=1, filter_overlaps=True)
    ds, jds = RawTokenDataset(tmp_path, **kw), JaxDataset(tmp_path, **kw)
    assert len(ds) == 3
    ev = GenieEvaluator(tiny["model"], cfg, device="cpu", maskgit_steps=1)
    jev = JaxEvaluator(tiny["jmodel"], tiny["jparams"], tiny["jcfg"],
                       maskgit_steps=1)
    got = evaluate_dataset(ev, ds, batch_size=2, verbose=False)
    want = jax_evaluate_dataset(jev, jds, batch_size=2, verbose=False)
    one = evaluate_dataset(ev, ds, batch_size=1, verbose=False)
    assert got["count"] == want["count"] == one["count"] == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    assert got["gen_time"] > 0
    # the host path (logits fetched and saved) gives the same metrics
    saved = evaluate_dataset(ev, ds, batch_size=2, verbose=False,
                             save_outputs_dir=str(tmp_path / "out"))
    np.testing.assert_allclose(saved["loss"], got["loss"], rtol=1e-5)
    np.testing.assert_allclose(saved["acc"], got["acc"], rtol=1e-6)
    assert np.load(tmp_path / "out" / "pred_logits.npy").shape == (
        3, cfg.factored_vocab_size, 2, cfg.T - 1, h, h)


@pytest.mark.parametrize("layout", ["msgpack", "safetensors", "torch_bin"])
def test_load_model_checkpoint(tiny, tmp_path, layout):
    """JAX `save_pretrained` (params.msgpack), JAX `save_pretrained_torch`
    (model.safetensors) and a reference torch directory
    (pytorch_model.bin): the same logits as the weights they hold."""
    if layout == "msgpack":
        save_pretrained(tmp_path, tiny["jparams"], tiny["jcfg"])
    elif layout == "safetensors":
        save_pretrained_torch(tmp_path, tiny["jparams"], tiny["jcfg"])
    else:
        (tmp_path / "config.json").write_text(json.dumps(
            dataclasses.asdict(tiny["cfg"])))
        torch.save(tiny["model"].state_dict(), tmp_path / "pytorch_model.bin")
    state, cfg = load_model_checkpoint(tmp_path)
    assert cfg == tiny["cfg"]
    model = STMaskGIT(cfg)
    model.load_state_dict(state)
    x = t(tiny["tokens"].reshape(B, cfg.T, 4, 4)).long()
    with torch.no_grad():
        np.testing.assert_array_equal(model.compute_logits(x).numpy(),
                                      tiny["model"].compute_logits(x).numpy())
