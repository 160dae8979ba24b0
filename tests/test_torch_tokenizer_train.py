"""The port's tokenizer training (`tpu1x_torch/tokenizer/train_tokenizer.py`,
the discriminator, the weight converters, the CLI) against the JAX
package's, on the CPU.

The JAX side's steps run once, in a fresh interpreter (in-process JAX and
torch convolutions have segfaulted in this suite), which draws every weight
with numpy from a seed (the generator, the discriminator and its running
statistics, a random VGG-LPIPS) and writes them, with its metrics,
gradients, states and the cotangent each step's backward sends to the
latents (observed through a custom_vjp identity in front of its LFQ), to
an .npz. The tiny config: 32 px, base 32, ch_mult (1, 2), z 6, one res
block, `disc_num_layers` 3, B = 2, lr 1e-4, three micro-steps on three
seeded batches, in four setups:

1. "bn": BatchNorm, adaptive weight, `disc_start` 1 (crossed at step 2);
2. "actnorm": ActNorm initialized from the first batch on each side,
   vanilla discriminator loss, linear warm-up (its first update at 0);
3. "fixed": `gen_loss_weight` 0.8, MultiSteps 2, linear warm-up and cosine
   decay, the non-saturating discriminator loss;
4. "bn_bf16": setup 1 in bf16.

The LFQ entropy's gradient at temperature 0.01 cancels two ~1 terms per
latent, and XLA's fp32 tanh is 4 ulp off: the JAX side's cotangent at the
latents is ~1e-4 from a float64 evaluation, the port's ~1e-6 (held here).
Adam's first update, lr g / |g| elementwise, turns that into a different
step wherever the encoder's gradient is small. So the port as it is is
held on the first step: every metric within 1e-4 relative (1e-6
absolute), its latent cotangent within 5e-4 of the JAX side's. The
trajectory is held from the same latent cotangents (the port's latents
take the JAX step's in the backward, `Latents`): every metric of every
step within 1e-4 relative (1e-6 absolute); the first step's gradient of
every generator and discriminator parameter within 1e-4 relative L2; the
parameter updates p - p0 after three steps within 1e-3 relative L2 (less
the elements whose first update's sign is a rounding's, `undecided`, at
most 1e-3 of them); the running mean and var, the LeCam EMAs and the EMA
parameters within 1e-5; ActNorm's initial loc and scale within 1e-5. In
bf16 the first step's metrics within 2e-2, the later steps' within 5e-2,
and the first gradients as far from fp32 as the JAX package's are (1.25x
+ 0.02). The discriminator's converters are held in this process:
`disc_params_from_jax` / `disc_params_to_jax` round-trip exactly, and a
reference-named `main.{i}` state dict (with a `discriminator.` prefix)
loads strictly and matches the JAX package's
`convert_discriminator_state_dict`, with BatchNorm and with ActNorm. The
port's CLI runs here with `--device cpu` on a tiny .npy before the child
starts: its batches are `RandomState(seed)`'s, it prints the JAX CLI's
lines, it saves the EMA, and the JAX package's `load_tokenizer` reads its
output in the child.
"""

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu1x.tokenizer.checkpoint import (
    convert_discriminator_state_dict as jax_convert_disc)
from tpu1x_torch.config import VQConfig
from tpu1x_torch.tokenizer import train_tokenizer as tt
from tpu1x_torch.tokenizer.checkpoint import convert_discriminator_state_dict
from tpu1x_torch.tokenizer.discriminator import NLayerDiscriminator
from tpu1x_torch.tokenizer.lpips import LPIPS, lpips_params_from_flax
from tpu1x_torch.tokenizer.schedulers import build_tokenizer_optimizer
from tpu1x_torch.tokenizer.vqmodel import VQModel, ema_init
from tpu1x_torch.weights import (disc_params_from_jax, disc_params_to_jax,
                                 vq_params_from_jax, vq_params_to_jax)

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)
SMALL = dict(resolution=32, base_channels=32, ch_mult=(1, 2), z_channels=6,
             codebook_size=64, num_res_blocks=1)
SETUPS = {
    "bn": dict(dtype="float32", disc_start=1, use_actnorm=False,
               gen_loss_weight=None, disc_loss="hinge",
               opt=dict(learning_rate=1e-4)),
    "actnorm": dict(dtype="float32", disc_start=0, use_actnorm=True,
                    gen_loss_weight=None, disc_loss="vanilla",
                    opt=dict(learning_rate=1e-4,
                             scheduler_type="linear-warmup", warmup_steps=2)),
    "fixed": dict(dtype="float32", disc_start=0, use_actnorm=False,
                  gen_loss_weight=0.8, disc_loss="non_saturate",
                  opt=dict(learning_rate=1e-4,
                           scheduler_type="linear-warmup_cosine-decay",
                           warmup_steps=0, training_steps=3,
                           min_learning_rate=1e-5, grad_accum_steps=2)),
    "bn_bf16": dict(dtype="bfloat16", disc_start=1, use_actnorm=False,
                    gen_loss_weight=None, disc_loss="hinge",
                    opt=dict(learning_rate=1e-4)),
}
FP32 = ["bn", "actnorm", "fixed"]
STEPS, B = 3, 2

CHILD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import optax
from pathlib import Path
from tpu1x.config import VQConfig
from tpu1x.tokenizer import losses as L
from tpu1x.tokenizer.checkpoint import load_tokenizer
from tpu1x.tokenizer.discriminator import NLayerDiscriminator
from tpu1x.tokenizer.lfq import LFQ
from tpu1x.tokenizer.lpips import LPIPS
from tpu1x.tokenizer.schedulers import build_tokenizer_optimizer
from tpu1x.tokenizer.train_tokenizer import (TokenizerTrainState,
                                             make_tokenizer_train_step)
from tpu1x.tokenizer.vqmodel import VQModel, ema_init

work = Path(sys.argv[1])
setups = json.loads((work / "setups.json").read_text())
small = json.loads((work / "small.json").read_text())
small["ch_mult"] = tuple(small["ch_mult"])
batches = np.load(work / "inputs.npz")["batches"]
x0 = jnp.asarray(batches[0])
key = jax.random.PRNGKey(0)
out = {}
rng = np.random.default_rng(0)

def name_of(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

def flat(tree, prefix):
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from flat(v, p)
        else:
            yield p, np.asarray(v)

def save(tree, prefix):
    for k, v in flat(tree, prefix):
        out[k] = v

def draw(path, leaf):
    name, shape = name_of(path), leaf.shape
    if name.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape)
                / np.sqrt(fan_in)).astype(np.float32)
    if name.endswith("scale"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name.endswith("var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if "lin_" in name:
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)

def drawn(fn):
    tree = jax.eval_shape(fn)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.tree_util.tree_map_with_path(draw, tree))

cfg0 = VQConfig(**small, dtype="float32")
gen0 = drawn(lambda: VQModel(cfg0).init(key, x0))["params"]
save(gen0, "gen0")
lp_model = LPIPS(net="vgg")
lp = drawn(lambda: lp_model.init(key, x0, x0))["params"]
save(lp, "lpips")

def lpips_apply(x, y):
    return lp_model.apply({"params": lp}, x, y)

def recording(tx):
    # the gradients each update call receives, kept in the state
    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params),
                tx.init(params))
    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[1], params)
        return upd, (grads, inner)
    return optax.GradientTransformation(init, update)

# the cotangent that the step's backward sends to the latents, observed
seen = []

@jax.custom_vjp
def observe(z):
    return z

def observe_bwd(_, g):
    jax.debug.callback(lambda g: seen.append(np.asarray(g)), g)
    return (g,)

observe.defvjp(lambda z: (z, None), observe_bwd)
lfq_call = LFQ.__call__
LFQ.__call__ = lambda self, z, *a, **kw: lfq_call(self, observe(z), *a, **kw)

disc_vars = {}
for name, s in setups.items():
    cfg = VQConfig(**small, dtype=s["dtype"], disc_start=s["disc_start"],
                   use_actnorm=s["use_actnorm"],
                   gen_loss_weight=s["gen_loss_weight"],
                   disc_loss=s["disc_loss"])
    disc = NLayerDiscriminator(input_nc=3, n_layers=3,
                               use_actnorm=cfg.use_actnorm,
                               dtype=jnp.dtype(cfg.dtype))
    if cfg.use_actnorm not in disc_vars:
        v = drawn(lambda: disc.init(key, x0, train=True))
        disc_vars[cfg.use_actnorm] = (v["params"], v.get("batch_stats", {}))
    dparams, dstats = disc_vars[cfg.use_actnorm]
    if cfg.use_actnorm:  # flax's data-dependent init, from the conv weights
        convs = {k: v for k, v in dparams.items() if not k.startswith("an_")}
        _, mut = disc.apply({"params": convs}, x0, train=True,
                            mutable=["params"], rngs={"params": key})
        dparams = jax.tree_util.tree_map(np.asarray, mut["params"])
    save(dparams, f"{name}/disc0/params")
    save(dstats, f"{name}/disc0/stats")
    gen_tx = recording(build_tokenizer_optimizer(**s["opt"]))
    disc_tx = recording(build_tokenizer_optimizer(**s["opt"]))
    state = TokenizerTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen0,
        gen_opt=gen_tx.init(gen0), ema_params=ema_init(gen0),
        disc_params=dparams, disc_stats=dstats,
        disc_opt=disc_tx.init(dparams), lecam=L.LeCamState.init(), rng=key)
    step = make_tokenizer_train_step(VQModel(cfg), disc, gen_tx, disc_tx,
                                     cfg, lpips_apply=lpips_apply)
    for i in range(len(batches)):
        state, metrics = step(state, jnp.asarray(batches[i]))
        for k, v in metrics.items():
            out[f"{name}/metrics/{i}/{k}"] = np.asarray(v)
        jax.effects_barrier()
        out[f"{name}/dz/{i}"] = seen.pop()
        assert not seen
        save(state.gen_opt[0], f"{name}/grad/{i}/gen")
        save(state.disc_opt[0], f"{name}/grad/{i}/disc")
    save(state.gen_params, f"{name}/final/gen")
    save(state.disc_params, f"{name}/final/disc")
    save(state.disc_stats, f"{name}/final/stats")
    save(state.ema_params, f"{name}/final/ema")
    out[f"{name}/final/lecam"] = np.asarray(
        [state.lecam.logits_real_ema, state.lecam.logits_fake_ema])

# the port CLI's tokenizer, read by the JAX package
params, cfg = load_tokenizer(work / "cli_tok")
assert cfg == VQConfig(resolution=32), cfg
want = jax.eval_shape(lambda: VQModel(cfg).init(
    key, jnp.zeros((1, cfg.resolution, cfg.resolution, 3))))["params"]
want = {name_of(p): tuple(s.shape)
        for p, s in jax.tree_util.tree_flatten_with_path(want)[0]}
assert {k[1:]: v.shape for k, v in flat(params, "")} == want
for k, v in flat(params, "cli"):
    out[k + "/sum"] = np.float64(v.astype(np.float64).sum())
np.savez(work / "out.npz", **out)
print("child done")
"""


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def subtree(out, prefix):
    n = len(prefix) + 1
    return unflatten({k[n:]: v for k, v in out.items()
                      if k.startswith(prefix + "/")})


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def run_cli(work):
    """The port's CLI on 6 seeded 32 px images at the default (full-width)
    config: its batches, stdout and what it saves, recorded."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    np.save(work / "images.npy", images)
    seen, saved = [], []
    real_make, real_save = tt.make_tokenizer_train_step, tt.save_tokenizer

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def recorded(state, batch):
            seen.append(batch.clone())
            return step(state, batch)
        return recorded

    def save(path, params, config):
        saved.append(params)
        real_save(path, params, config)

    tt.make_tokenizer_train_step, tt.save_tokenizer = make, save
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), pytest.warns(
                UserWarning, match="RANDOMLY INITIALIZED"):
            tt.main(["--images_npy", str(work / "images.npy"), "--output_dir",
                     str(work / "cli_tok"), "--batch_size", "2",
                     "--max_train_steps", "4", "--accumulate_grad_batches",
                     "2", "--lpips_ckpt", "random", "--seed", "3",
                     "--device", "cpu"])
    finally:
        tt.make_tokenizer_train_step, tt.save_tokenizer = real_make, real_save
    return dict(images=images, seen=seen, saved=saved,
                log=buf.getvalue().splitlines())


class _Cotangent(torch.autograd.Function):
    """z in the forward; `g` in place of z's gradient in the backward."""

    @staticmethod
    def forward(ctx, z, g):
        ctx.save_for_backward(g)
        return z.view_as(z)

    @staticmethod
    def backward(ctx, grad):
        return ctx.saved_tensors[0], None


class Latents:
    """The port's quantizer, recording the cotangent that the step's
    backward sends to the latents; with `grads`, the latents take those
    (the JAX step's, observed in the child) in its place, so that the
    encoder's backward starts from the same cotangent on both sides. The
    forward and the metrics stay the port's."""

    def __init__(self, quantizer, grads=None):
        self.quantizer, self.grads, self.seen = quantizer, grads, []

    def __call__(self, z, training=True):
        if self.grads is not None:
            z = _Cotangent.apply(z, torch.from_numpy(
                self.grads[len(self.seen)]))
        z.register_hook(lambda g: self.seen.append(g.clone()))
        return self.quantizer(z, training=training)


def port_run(ref, name, matched):
    """The port's three micro-steps of setup `name` from the child's
    weights: metrics, every call's gradients, the latents' cotangents, the
    final state. `matched`: the latents take the JAX step's cotangents."""
    s, out = SETUPS[name], ref["out"]
    cfg = VQConfig(**SMALL, dtype=s["dtype"], disc_start=s["disc_start"],
                   use_actnorm=s["use_actnorm"],
                   gen_loss_weight=s["gen_loss_weight"],
                   disc_loss=s["disc_loss"])
    opt = functools.partial(build_tokenizer_optimizer, **s["opt"])
    state = tt.create_tokenizer_state(cfg, opt, opt, seed=0, image_size=32,
                                      device="cpu")
    state.model.load_state_dict(vq_params_from_jax(subtree(out, "gen0"), cfg))
    d0 = (subtree(out, f"{name}/disc0/params"),
          subtree(out, f"{name}/disc0/stats"))
    state.disc.load_state_dict(disc_params_from_jax(*d0))
    batches = torch.from_numpy(ref["batches"])
    if cfg.use_actnorm:
        state.disc.init_actnorm(batches[0])
    init = {k: v.clone() for k, v in state.disc.state_dict().items()}
    state.ema_params = ema_init(state.model)
    latents = Latents(state.model.quantizer, [
        out[f"{name}/dz/{i}"] for i in range(STEPS)] if matched else None)
    state.model.quantizer = latents
    p0 = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    grads = {"gen": [], "disc": []}
    for which, module, opt_ in (("gen", state.model, state.gen_opt),
                                ("disc", state.disc, state.disc_opt)):
        names = [n for n, _ in module.named_parameters()]
        real = opt_.step

        def record(g, which=which, names=names, real=real):
            grads[which].append({n: t.clone() for n, t in zip(names, g)})
            real(g)
        opt_.step = record
    lpips = LPIPS("vgg")
    lpips.load_state_dict(lpips_params_from_flax(ref["lpips"]))
    step = tt.make_tokenizer_train_step(cfg,
                                        lpips.requires_grad_(False).eval())
    metrics = []
    for i in range(STEPS):
        state, m = step(state, batches[i])
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, state=state, metrics=metrics, grads=grads, p0=p0,
                disc_init=init, dz=latents.seen,
                accum=s["opt"].get("grad_accum_steps", 1))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("tokenizer_train")
    rng = np.random.default_rng(1)
    batches = rng.uniform(-1, 1, (STEPS, B, 32, 32, 3)).astype(np.float32)
    np.savez(work / "inputs.npz", batches=batches)
    (work / "setups.json").write_text(json.dumps(SETUPS))
    (work / "small.json").write_text(json.dumps(SMALL))
    cli = run_cli(work)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", CHILD, str(work)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(work / "out.npz") as z:
        out = dict(z)
    return dict(work=work, out=out, batches=batches, cli=cli,
                lpips=subtree(out, "lpips"), runs={})


def port(ref, name, matched=True):
    if (name, matched) not in ref["runs"]:
        ref["runs"][name, matched] = port_run(ref, name, matched)
    return ref["runs"][name, matched]


def metrics_match(got, want, rel, abs_):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rel, abs=abs_), (
            f"{k}: {got[k]} against {want[k]}")


def jax_metrics(ref, name, i):
    prefix = f"{name}/metrics/{i}/"
    return {k[len(prefix):]: float(v) for k, v in ref["out"].items()
            if k.startswith(prefix)}


def jax_grads(ref, name, which, cfg):
    """The JAX step's gradients of every call, under the port's names."""
    out = ref["out"]
    if which == "gen":
        return [vq_params_from_jax(subtree(out, f"{name}/grad/{i}/gen"), cfg)
                for i in range(STEPS)]
    stats = subtree(out, f"{name}/disc0/stats")
    return [disc_params_from_jax(subtree(out, f"{name}/grad/{i}/disc"), stats)
            for i in range(STEPS)]


def undecided(run, want, which):
    """The elements whose first update's direction is a rounding's: in the
    first accumulation window whose gradients are not all 0 (the
    discriminator's starts at `disc_start`), the window's mean gradient is
    below 1e-5 of its tensor's rms, or the two sides' means differ in sign.
    Adam's first update is lr g / (|g| + 1e-8), the sign of g, so there the
    two updates part by up to 2 lr whatever the rest does."""
    got = run["grads"][which]
    start = next(i for i, c in enumerate(want) if any(
        np.any(c[k].numpy()) for k in got[0]))
    window = range(start, start + run["accum"])
    out = {}
    for k in got[0]:
        g = sum(got[i][k] for i in window) / len(window)
        w = sum(want[i][k] for i in window) / len(window)
        out[k] = ((w.abs() < 1e-5 * w.square().mean().sqrt())
                  | (torch.sign(g) != torch.sign(w)))
    return out


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("name", FP32)
def test_first_step_metrics_match_jax(ref, name):
    """The port as it is (no cotangent passed across): the first step."""
    got = port(ref, name, matched=False)["metrics"][0]
    metrics_match(got, jax_metrics(ref, name, 0), 1e-4, 1e-6)


@pytest.mark.parametrize("name", FP32)
def test_latent_cotangent_matches_jax(ref, name):
    """The first step's cotangent at the latents, the port's own against
    the JAX step's: within 5e-4 relative L2. It carries the LFQ terms'
    gradient, which on the JAX side is off by the error of XLA's fp32 tanh
    (see `test_lfq_gradient_is_nearer_float64_than_jax`)."""
    got = port(ref, name, matched=False)["dz"][0]
    assert rel_l2(got, ref["out"][f"{name}/dz/0"]) <= 5e-4


def lfq_loss_float64(z, cfg):
    """The LFQ terms (entropy weight 0.1, commit 0.25) in float64, written
    out: the exact per-sample entropy, the full codebook's entropy, the
    commit MSE."""
    t, d = cfg.entropy_temperature, cfg.z_channels
    a = 2 * z / t
    sample = (a.abs() + torch.log1p(torch.exp(-2 * a.abs()))
              - a * torch.tanh(a)).sum(-1).mean()
    flat_a = a.reshape(-1, d)
    bits = ((torch.arange(2 ** d)[:, None] >> torch.arange(d)) & 1).double()
    logp = (F.logsigmoid(2 * flat_a) @ bits.T
            + F.logsigmoid(-2 * flat_a) @ (1 - bits).T)
    probs = logp.exp().mean(0)
    codebook = -(probs * torch.log(probs + 1e-5)).sum()
    commit = (z - torch.where(z > 0, 1.0, -1.0).double()).square().mean()
    return (cfg.entropy_loss_weight * (sample - codebook)
            + cfg.commit_loss_weight * commit)


def test_lfq_gradient_is_nearer_float64_than_jax(ref):
    """The LFQ terms' gradient at the first step's latents (entropy at
    temperature 0.01, whose per-sample term cancels two ~1 terms in its
    derivative), the port's and the JAX package's in fp32 against a
    float64 evaluation: the port's within 1e-5 relative L2, and nearer than
    the JAX package's, whose XLA tanh is 4 ulp off."""
    import jax
    import jax.numpy as jnp
    from tpu1x.config import VQConfig as JaxVQConfig
    from tpu1x.tokenizer.lfq import LFQ as JaxLFQ
    from tpu1x_torch.tokenizer.lfq import LFQ
    cfg = VQConfig(**SMALL, dtype="float32")
    model = VQModel(cfg)
    model.load_state_dict(vq_params_from_jax(subtree(ref["out"], "gen0"), cfg))
    with torch.no_grad():
        z = model.encoder(torch.from_numpy(ref["batches"][0]).permute(
            0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()

    def loss(lfq, z):
        res = lfq(z, training=True)
        return (cfg.entropy_loss_weight * res.entropy_loss
                + cfg.commit_loss_weight * res.commit_loss)

    z32 = z.clone().requires_grad_()
    port_g = torch.autograd.grad(loss(LFQ(cfg), z32), z32)[0]
    z64 = z.double().requires_grad_()
    exact = torch.autograd.grad(lfq_loss_float64(z64, cfg), z64)[0]
    jax_cfg = JaxVQConfig(**{**SMALL, "ch_mult": (1, 2)}, dtype="float32")
    jax_g = np.asarray(jax.grad(lambda z: loss(JaxLFQ(jax_cfg), z))(
        jnp.asarray(z.numpy())))
    port_err, jax_err = rel_l2(port_g, exact), rel_l2(jax_g, exact)
    assert port_err <= 1e-5 and port_err < jax_err, (port_err, jax_err)


def test_disc_start_gates_the_first_step(ref):
    first, second = port(ref, "bn")["metrics"][:2]
    assert first["disc_loss"] == 0.0 and first["d_loss"] > 0
    assert second["disc_loss"] > 0 and first["d_weight"] > 0
    assert not any(torch.any(g) for g in port(ref, "bn")["grads"]["disc"][0]
                   .values())


@pytest.mark.parametrize("name", FP32)
def test_metrics_match_jax(ref, name):
    """Every metric of every step, from the same latent cotangents."""
    for i, got in enumerate(port(ref, name)["metrics"]):
        metrics_match(got, jax_metrics(ref, name, i), 1e-4, 1e-6)


@pytest.mark.parametrize("name", FP32)
def test_first_step_gradients_match_jax(ref, name):
    run, out = port(ref, name), ref["out"]
    gen = jax_grads(ref, name, "gen", run["cfg"])[0]
    disc = jax_grads(ref, name, "disc", run["cfg"])[0]
    for which, want, module in (("gen", gen, run["state"].model),
                                ("disc", disc, run["state"].disc)):
        got = run["grads"][which][0]
        assert list(got) == [k for k, _ in module.named_parameters()]
        for k, g in got.items():
            if not np.any(want[k].numpy()):
                assert not torch.any(g), (which, k)
                continue
            assert rel_l2(g, want[k]) <= 1e-4, (which, k, rel_l2(g, want[k]))


@pytest.mark.parametrize("name", FP32)
def test_parameter_updates_match_jax(ref, name):
    """p - p0 after three steps within 1e-3 relative L2, over the elements
    whose first update's direction is not a rounding's (`undecided`: at
    most 1e-3 of each model's elements)."""
    run, out, cfg = port(ref, name), ref["out"], port(ref, name)["cfg"]
    gen0 = vq_params_from_jax(subtree(out, "gen0"), cfg)
    gen1 = vq_params_from_jax(subtree(out, f"{name}/final/gen"), cfg)
    d0 = disc_params_from_jax(subtree(out, f"{name}/disc0/params"),
                              subtree(out, f"{name}/disc0/stats"))
    d1 = disc_params_from_jax(subtree(out, f"{name}/final/disc"),
                              subtree(out, f"{name}/final/stats"))
    for which, module, start, want0, want1 in (
            ("gen", run["state"].model, run["p0"], gen0, gen1),
            ("disc", run["state"].disc, run["disc_init"], d0, d1)):
        names = [k for k, _ in module.named_parameters()]
        skip = undecided(run, jax_grads(ref, name, which, cfg), which)
        assert list(skip) == names
        assert sum(int(m.sum()) for m in skip.values()) <= 1e-3 * sum(
            m.numel() for m in skip.values())
        for k, p in module.named_parameters():
            got, want = p.detach() - start[k], want1[k] - want0[k]
            assert np.any(want.numpy()), k
            if which == "gen":
                assert torch.equal(start[k], want0[k])
            keep = ~skip[k]
            assert rel_l2(got[keep], want[keep]) <= 1e-3, (which, k)


@pytest.mark.parametrize("name", FP32)
def test_statistics_lecam_and_ema_match_jax(ref, name):
    run, out = port(ref, name), ref["out"]
    state = run["state"]
    want = disc_params_from_jax(subtree(out, f"{name}/final/disc"),
                                subtree(out, f"{name}/final/stats"))
    buffers = dict(state.disc.named_buffers())
    stats = [k for k in buffers if "running" in k]
    assert len(stats) == (0 if run["cfg"].use_actnorm else 6)
    for k in stats:
        np.testing.assert_allclose(buffers[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
        assert not torch.equal(buffers[k], run["disc_init"][k]), k
    if not run["cfg"].use_actnorm:
        assert int(buffers["main.3.num_batches_tracked"]) == 2 * STEPS
    np.testing.assert_allclose(
        [float(state.lecam.logits_real_ema),
         float(state.lecam.logits_fake_ema)],
        out[f"{name}/final/lecam"], atol=1e-5, rtol=0)
    ema = vq_params_from_jax(subtree(out, f"{name}/final/ema"), run["cfg"])
    skip = undecided(run, jax_grads(ref, name, "gen", run["cfg"]), "gen")
    assert state.ema_params.keys() == ema.keys()
    for k, v in state.ema_params.items():
        keep = ~skip[k]
        np.testing.assert_allclose(v[keep].numpy(), ema[k][keep].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert state.step == STEPS
    # the generator's gradients are taken over its parameters alone
    for p in list(state.model.parameters()) + list(state.disc.parameters()):
        assert p.grad is None


def test_actnorm_init_matches_jax(ref):
    run = port(ref, "actnorm")
    want = subtree(ref["out"], "actnorm/disc0/params")
    for n in (1, 2, 3):
        for k in ("loc", "scale"):
            got = run["disc_init"][f"main.{3 * n}.{k}"]
            assert got.shape == (1, want[f"an_{n}"][k].size, 1, 1)
            np.testing.assert_allclose(got.reshape(-1).numpy(),
                                       want[f"an_{n}"][k], atol=1e-5,
                                       rtol=1e-5, err_msg=f"an_{n} {k}")
        assert int(run["disc_init"][f"main.{3 * n}.initialized"]) == 1


def test_bf16_metrics_match_jax(ref):
    """Setup 1 in bf16, from the same latent cotangents: the first step's
    metrics (the forward, the port's as it is) within 2e-2 (relative, or
    absolute on the O(1) losses); the later steps within 5e-2. The two
    sides round to bf16 at the same places but sum in other orders, so
    their gradients are ~1e-2 apart, and Adam's first update, lr g / |g|
    elementwise, turns that into a different step: the adaptive weight of
    step 3 moves by 4%."""
    run = port(ref, "bn_bf16")
    assert run["state"].disc.dtype == torch.bfloat16
    for i, got in enumerate(run["metrics"]):
        tol = 2e-2 if i == 0 else 5e-2
        metrics_match(got, jax_metrics(ref, "bn_bf16", i), tol, tol)


def test_bf16_gradients_as_far_from_fp32_as_jax(ref):
    """The first step's gradients in bf16 against fp32 (setups 4 and 1,
    each package as it is), by group: the port's no farther from its fp32
    ones than 1.25x the JAX package's distance + 0.02. Neither is near:
    a latent near 0 takes the other code in bf16 (the decoder's input),
    and the encoder's gradient is the LFQ entropy's, large only there."""
    out, cfg = ref["out"], VQConfig(**SMALL)
    jax32 = jax_grads(ref, "bn", "gen", cfg)[0]
    jax16 = jax_grads(ref, "bn_bf16", "gen", cfg)[0]
    port32 = port(ref, "bn", matched=False)["grads"]["gen"][0]
    port16 = port(ref, "bn_bf16", matched=False)["grads"]["gen"][0]

    def group(grads, prefix):
        return torch.cat([grads[k].double().flatten() for k in sorted(grads)
                          if k.startswith(prefix)])

    for prefix in ("encoder.", "decoder."):
        mine = rel_l2(group(port16, prefix), group(port32, prefix))
        theirs = rel_l2(group(jax16, prefix), group(jax32, prefix))
        assert mine <= 1.25 * theirs + 0.02, (prefix, mine, theirs)


# ------------------------------------------------------ weights across

def reference_disc_state_dict(use_actnorm, seed):
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in NLayerDiscriminator(
            use_actnorm=use_actnorm).state_dict().items()}
    sd = {}
    for k, (shape, dtype) in shapes.items():
        if dtype != torch.float32:
            sd[k] = torch.ones(shape, dtype=dtype) * 5
        elif k.endswith("running_var") or k.endswith("scale"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(
                np.float32))
        else:
            sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
    return sd


@pytest.mark.parametrize("use_actnorm", [False, True])
def test_reference_discriminator_loads_strict_and_matches_jax(use_actnorm):
    sd = reference_disc_state_dict(use_actnorm, 3)
    ckpt = {"discriminator." + k: v for k, v in sd.items()}
    got = convert_discriminator_state_dict(ckpt)
    disc = NLayerDiscriminator(use_actnorm=use_actnorm)
    disc.load_state_dict(got, strict=True)
    for k, v in disc.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k
    params, stats = jax_convert_disc(ckpt)
    mine, my_stats = disc_params_to_jax(disc.state_dict())
    for tree, want in ((mine, params), (my_stats, stats)):
        flat_got = dict(flatten(tree))
        flat_want = {k: np.asarray(v) for k, v in flatten(want)}
        assert flat_got.keys() == flat_want.keys()
        for k in flat_want:
            np.testing.assert_array_equal(flat_got[k], flat_want[k],
                                          err_msg=k)


def flatten(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flatten(v, p)
        else:
            yield p, np.asarray(v)


@pytest.mark.parametrize("name", ["bn", "actnorm"])
def test_disc_params_round_trip_exactly(ref, name):
    params = subtree(ref["out"], f"{name}/disc0/params")
    stats = subtree(ref["out"], f"{name}/disc0/stats")
    sd = disc_params_from_jax(params, stats)
    disc = NLayerDiscriminator(use_actnorm=name == "actnorm")
    disc.load_state_dict(sd, strict=True)
    back, back_stats = disc_params_to_jax(disc.state_dict())
    for got, want in ((back, params), (back_stats, stats)):
        g, w = dict(flatten(got)), dict(flatten(want))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_discriminator_layout_is_the_reference_sequential():
    disc = NLayerDiscriminator(n_layers=3)
    kinds = [type(m).__name__ for m in disc.main]
    assert kinds == ["Conv2d", "LeakyReLU"] + [
        "Conv2d", "FlaxBatchNorm2d", "LeakyReLU"] * 3 + ["Conv2d"]
    assert [disc.main[i].bias is None for i in (0, 2, 5, 8, 11)] == [
        False, True, True, True, False]
    act = NLayerDiscriminator(n_layers=3, use_actnorm=True)
    assert all(act.main[i].bias is not None for i in (0, 2, 5, 8, 11))
    out = disc(torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 2, 2, 1) and out.dtype == torch.float32


def test_flax_batchnorm_updates_with_the_biased_variance():
    bn = NLayerDiscriminator(n_layers=1, dtype=torch.float32).main[3]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 128, 3, 3)).astype(np.float32))
    bn(x)
    xf = x.double().transpose(0, 1).reshape(128, -1)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.01 * xf.mean(1).numpy(), atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.99 + 0.01 * xf.var(1, unbiased=False).numpy(),
                               atol=1e-6)


# ------------------------------------------------------------- the CLI

def test_cli_draws_the_jax_cli_batches(ref):
    cli = ref["cli"]
    rng = np.random.RandomState(3)
    assert len(cli["seen"]) == 4
    for batch in cli["seen"]:
        idx = rng.randint(0, len(cli["images"]), 2)
        want = cli["images"][idx].astype(np.float32) / 127.5 - 1.0
        np.testing.assert_array_equal(batch.numpy(), want)


def test_cli_prints_the_jax_cli_lines(ref, tmp_path):
    log = ref["cli"]["log"]
    assert re.fullmatch(r"step 0 gen -?\d+\.\d{4} rec \d+\.\d{4} "
                        r"disc -?\d+\.\d{4}", log[0]), log
    assert log[-1] == f"saved tokenizer to {ref['work'] / 'cli_tok'}"
    assert len(log) == 2


def test_cli_saves_the_ema_and_the_jax_package_reads_it(ref):
    saved = ref["cli"]["saved"]
    assert len(saved) == 1 and isinstance(saved[0], dict)  # the EMA
    tree = vq_params_to_jax(saved[0], VQConfig(resolution=32))
    sums = {k: float(v) for k, v in ref["out"].items()
            if k.startswith("cli/")}
    got = {f"cli/{k}/sum": float(v.astype(np.float64).sum())
           for k, v in flatten(tree)}
    assert got == sums


def test_cli_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    np.save(tmp_path / "x.npy", np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="cuda"):
        tt.main(["--images_npy", str(tmp_path / "x.npy"), "--output_dir",
                 str(tmp_path / "out"), "--max_train_steps", "1"])


def test_vq_model_state_dict_is_its_parameters():
    """The EMA's names are the state dict's: `save_tokenizer` takes it."""
    cfg = VQConfig(**SMALL)
    with torch.device("meta"):
        model = VQModel(cfg)
    assert list(model.state_dict()) == [k for k, _ in model.named_parameters()]
