"""The port's tokenizer losses, schedules, optimizer and EMA against the JAX
package's, in this process (no convolution runs on either side).

Inputs are drawn with numpy from a seed. Held at atol 1e-6 (rtol 1e-6
where the value is large): every discriminator loss, the generator loss,
`adopt_weight`, LeCam's update and
regularization, `adaptive_gen_weight` (its clip at both ends), L1 and L2;
both schedules at every step of a range; the parameters after each
micro-step of `build_tokenizer_optimizer` against optax on the same
gradients, every scheduler type under accumulation 1 and 2, which holds
the learning rate of each update (its schedule counting updates, the
first at multiplier 0 under linear warm-up) and MultiSteps' averaging and
gating; `ema_update` with and without its warm-up.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu1x.tokenizer import losses as JL
from tpu1x.tokenizer import schedulers as JS
from tpu1x.tokenizer.vqmodel import ema_update as jax_ema_update
from tpu1x_torch.tokenizer import losses as L
from tpu1x_torch.tokenizer import schedulers as S
from tpu1x_torch.tokenizer.vqmodel import ema_init, ema_update

TOL = dict(atol=1e-6, rtol=1e-6)


def logits(seed, shape=(4, 3, 3, 1), scale=2.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(L.D_LOSSES))
def test_discriminator_losses_match_jax(name):
    assert sorted(L.D_LOSSES) == sorted(JL.D_LOSSES)
    for seed in range(3):
        both(L.D_LOSSES[name], JL.D_LOSSES[name], logits(seed),
             logits(seed + 10) - 0.5)


def test_non_saturate_d_loss_scores_the_real_logits():
    real, fake = logits(0), logits(1)
    got = float(L.non_saturate_discriminator_loss(torch.from_numpy(real),
                                                  torch.from_numpy(fake)))
    rm = real.reshape(4, -1).mean(-1)
    fm = fake.reshape(4, -1).mean(-1)
    want = np.mean(np.log1p(np.exp(-rm))) + np.mean(np.log1p(np.exp(fm)))
    assert got == pytest.approx(want, rel=1e-6)


def test_gen_loss_and_reconstruction_losses_match_jax():
    both(L.non_saturate_gen_loss, JL.non_saturate_gen_loss, logits(3))
    x, y = logits(4, (2, 8, 8, 3), 1.0), logits(5, (2, 8, 8, 3), 1.0)
    both(L.l1_loss, JL.l1_loss, x, y)
    both(L.l2_loss, JL.l2_loss, x, y)


@pytest.mark.parametrize("step", [0, 4, 5, 9])
def test_adopt_weight_matches_jax(step):
    want = float(JL.adopt_weight(1.0, jnp.asarray(step), 5))
    assert L.adopt_weight(1.0, step, 5) == want
    assert L.adopt_weight(0.3, step, 5, value=0.7) == pytest.approx(
        float(JL.adopt_weight(0.3, jnp.asarray(step), 5, value=0.7)))


def test_lecam_update_and_reg_match_jax():
    t_state, j_state = L.LeCamState.init(), JL.LeCamState.init()
    assert float(t_state.logits_real_ema) == 0
    assert float(j_state.logits_real_ema) == 0
    for seed in range(4):
        real, fake = logits(seed), logits(seed + 20)
        got = L.lecam_reg(torch.from_numpy(real), torch.from_numpy(fake),
                          t_state)
        want = JL.lecam_reg(jnp.asarray(real), jnp.asarray(fake), j_state)
        np.testing.assert_allclose(float(got), float(want), **TOL)
        t_state = L.lecam_update(t_state, torch.from_numpy(real),
                                 torch.from_numpy(fake))
        j_state = JL.lecam_update(j_state, jnp.asarray(real),
                                  jnp.asarray(fake))
        for a, b in zip(t_state, j_state):
            np.testing.assert_allclose(float(a), float(b), **TOL)


@pytest.mark.parametrize("nll,g", [(0.3, 0.7), (2.0, 1e-9), (0.0, 1.0),
                                   (1e9, 1e-3)])
def test_adaptive_gen_weight_matches_jax(nll, g):
    got = L.adaptive_gen_weight(torch.tensor(nll), torch.tensor(g), 0.8)
    want = JL.adaptive_gen_weight(jnp.float32(nll), jnp.float32(g), 0.8)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_schedules_match_jax():
    for got, want in (
            (S.linear_warmup(4), JS.linear_warmup(4)),
            (S.linear_warmup(0), JS.linear_warmup(0)),
            (S.linear_warmup_cosine_decay(3, 12, 0.1),
             JS.linear_warmup_cosine_decay(3, 12, 0.1)),
            (S.linear_warmup_cosine_decay(0, 5),
             JS.linear_warmup_cosine_decay(0, 5))):
        for step in range(16):
            np.testing.assert_allclose(got(step), float(want(step)), **TOL)


def test_unknown_scheduler_raises_as_jax_does():
    with pytest.raises(ValueError, match="unknown scheduler_type"):
        S.build_tokenizer_optimizer([torch.zeros(2)], 1e-3,
                                    scheduler_type="cosine")
    with pytest.raises(ValueError, match="unknown scheduler_type"):
        JS.build_tokenizer_optimizer(1e-3, scheduler_type="cosine")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("scheduler", ["none", "linear-warmup",
                                       "linear-warmup_cosine-decay"])
def test_optimizer_matches_optax(scheduler, accum):
    kw = dict(learning_rate=1e-2, scheduler_type=scheduler, warmup_steps=2,
              training_steps=5, min_learning_rate=1e-3,
              grad_accum_steps=accum)
    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    params = [torch.from_numpy(p0[k].copy()).requires_grad_() for k in "ab"]
    opt = S.build_tokenizer_optimizer(params, **kw)
    tx = JS.build_tokenizer_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    for micro in range(12):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        opt.step([torch.from_numpy(g[k]) for k in "ab"])
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in zip("ab", params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{k} after call {micro}")
        assert all(p.grad is None for p in params)
    assert opt.updates == 12 // accum
    moved = np.abs(params[0].detach().numpy() - p0["a"]).max()
    assert moved > 1e-3


def test_first_linear_warmup_update_is_at_multiplier_zero():
    p = torch.ones(3, requires_grad=True)
    opt = S.build_tokenizer_optimizer([p], 1e-2, warmup_steps=4,
                                      scheduler_type="linear-warmup")
    assert opt.lr() == 0.0
    opt.step([torch.ones(3)])
    assert torch.equal(p.detach(), torch.ones(3)) and opt.updates == 1
    assert opt.lr() == pytest.approx(1e-2 / 4)


@pytest.mark.parametrize("num_updates", [None, 0, 3, 5000])
def test_ema_update_matches_jax(num_updates):
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    ema = ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    jema = {k: jnp.asarray(v) for k, v in params.items()}
    for _ in range(3):
        new = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in params.items()}
        got = ema_update(ema, {k: torch.from_numpy(v) for k, v in new.items()},
                         decay=0.999, num_updates=num_updates)
        jema = jax_ema_update(
            jema, {k: jnp.asarray(v) for k, v in new.items()}, decay=0.999,
            num_updates=(None if num_updates is None
                         else jnp.float32(num_updates)))
        assert got is ema and all(v.dtype == torch.float32
                                  for v in ema.values())
        for k in params:
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(jema[k]),
                                       **TOL)
