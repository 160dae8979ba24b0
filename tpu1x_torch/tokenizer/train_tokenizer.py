"""The MAGVIT2/LFQ tokenizer's GAN training on the card: the JAX package's
`tpu1x/tokenizer/train_tokenizer.py` in PyTorch (the reference's Lightning
`training_step`, `magvit2/models/lfqgan.py:145-183`, with
`VQLPIPSWithDiscriminator`, `magvit2/modules/losses/vqperceptual.py`).

    python -m tpu1x_torch.tokenizer.train_tokenizer --images_npy IMAGES.npy \\
        --output_dir TOK --lpips_ckpt vgg.pth [--device cpu]

One micro-step (`make_tokenizer_train_step`):
- the generator: L1 reconstruction + VGG-LPIPS + the non-saturating GAN
  loss against the discriminator *before* its update, in eval mode on its
  running statistics, times the adaptive weight ||grad nll|| / ||grad g||
  at the decoder's last conv weight (or the config's fixed
  `gen_loss_weight`) and `adopt_weight`'s gate + entropy (0.1) and commit
  (0.25) terms; its optimizer steps on the gradients;
- the discriminator on the real batch, then on the reconstruction of the
  generator's pre-update parameters (each in train mode, so BatchNorm's
  running statistics move twice), hinge (the default) + LeCam, all gated
  by `adopt_weight`: before `disc_start` its loss is 0, yet its statistics
  and the LeCam EMAs move and its Adam steps on zero gradients;
- the LeCam EMAs, then the EMA of the generator's parameters (decay
  min(ema_decay, (1+n)/(10+n)), n the micro-steps before this one).

`state.step`, `adopt_weight` and the EMA count micro-batches; the
optimizers' schedules count updates (every `grad_accum_steps` calls).

The adaptive weight's gradients are taken on the main graph
(`torch.autograd.grad(nll, w, retain_graph=True)`, the reference's way):
the weight touches only the last layer, so this equals the JAX package's
recomputed decode from the stopped quantized codes. The generator's
gradients are taken with `torch.autograd.grad` over its parameters alone,
so the discriminator's `.grad` stays empty.

The step runs with cuDNN's TF32 off: LPIPS is fp32 (as `make_lpips_fn`
runs it), and an fp32 config's convolutions stay fp32. The metrics are 0-d
tensors on the device: nothing in the step waits for the device.

The JAX state's `rng` has no counterpart: its step draws nothing. There is
no trainer checkpoint or resume: the CLI saves the final parameters (the
EMA's, else the generator's) with `save_tokenizer`, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import functools
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpu1x_torch.config import VQConfig
from tpu1x_torch.serving import resolve_device
from tpu1x_torch.tokenizer import losses as L
from tpu1x_torch.tokenizer.checkpoint import save_tokenizer
from tpu1x_torch.tokenizer.discriminator import NLayerDiscriminator
from tpu1x_torch.tokenizer.lpips import LPIPS, resolve_lpips_params
from tpu1x_torch.tokenizer.schedulers import (TokenizerOptimizer,
                                              build_tokenizer_optimizer)
from tpu1x_torch.tokenizer.vqmodel import VQModel, ema_init, ema_update


@dataclass
class TokenizerTrainState:
    """The JAX state's fields, torch's way: the generator's parameters are
    `model`'s, the discriminator's parameters and BatchNorm statistics
    `disc`'s parameters and buffers; each optimizer binds its module's
    parameters."""
    step: int                     # micro-batches taken
    model: VQModel
    gen_opt: TokenizerOptimizer
    ema_params: Optional[Dict[str, torch.Tensor]]
    disc: NLayerDiscriminator
    disc_opt: TokenizerOptimizer
    lecam: L.LeCamState


def create_tokenizer_state(config: VQConfig,
                           gen_tx: Callable[[list], TokenizerOptimizer],
                           disc_tx: Callable[[list], TokenizerOptimizer],
                           seed: int = 0, image_size: Optional[int] = None,
                           disc_init_batch=None, device="cuda"
                           ) -> TokenizerTrainState:
    """Seeded weights (drawn on the CPU, so that a seed gives the same
    weights on every device) on `device` (the card unless asked otherwise;
    raises without one). `gen_tx` / `disc_tx` build an optimizer over a
    list of parameters (`build_tokenizer_optimizer` with its arguments
    bound). With `config.use_actnorm`, ActNorm is initialized from
    `disc_init_batch` ((B, H, W, C) in [-1, 1]), or, without one, from a
    standard-normal batch of 4 drawn from the seed's generator."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = VQModel(config).init_weights(g).to(dev)
    disc = NLayerDiscriminator(
        config.disc_in_channels, n_layers=config.disc_num_layers,
        use_actnorm=config.use_actnorm,
        dtype=getattr(torch, config.dtype)).init_weights(g).to(dev)
    if config.use_actnorm:
        batch = disc_init_batch
        if batch is None:
            size = image_size or config.resolution
            batch = torch.randn(4, size, size, config.in_channels, generator=g)
        disc.init_actnorm(torch.as_tensor(batch, dtype=torch.float32).to(dev))
    return TokenizerTrainState(
        step=0, model=model, gen_opt=gen_tx(list(model.parameters())),
        ema_params=ema_init(model) if config.use_ema else None, disc=disc,
        disc_opt=disc_tx(list(disc.parameters())),
        lecam=L.LeCamState.init(dev))


def make_tokenizer_train_step(config: VQConfig,
                              lpips_apply: Optional[Callable] = None):
    """(state, images (B, H, W, C) in [-1, 1] on the state's device) ->
    (state, metrics): the state updated in place, the metrics the JAX
    step's keys as detached 0-d tensors."""
    recon_loss_fn = L.l1_loss if config.recon_loss == "l1" else L.l2_loss
    d_loss_fn = L.D_LOSSES[config.disc_loss]

    def perceptual(x, y):
        if lpips_apply is None or config.perceptual_weight == 0:
            return torch.zeros((), device=x.device)
        return lpips_apply(x, y).mean() * config.perceptual_weight

    def step(state: TokenizerTrainState, images: torch.Tensor):
        model, disc = state.model, state.disc
        gen_params = state.gen_opt.params
        disc_factor = L.adopt_weight(1.0, state.step, config.disc_start)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            # ---------------- generator
            recon, res = model(images, training=True)
            rec = recon_loss_fn(images, recon)
            p_loss = perceptual(images, recon)
            nll = rec + p_loss
            disc.eval()
            g_loss = L.non_saturate_gen_loss(disc(recon))
            if config.gen_loss_weight is None:
                w = model.decoder.conv_out.weight
                nll_g = torch.autograd.grad(nll, w, retain_graph=True)[0]
                g_g = torch.autograd.grad(g_loss, w, retain_graph=True)[0]
                d_weight = L.adaptive_gen_weight(
                    nll_g.norm(), g_g.norm(), config.disc_weight)
            else:
                d_weight = torch.full((), float(config.gen_loss_weight),
                                      device=images.device)
            gen_loss = (nll + d_weight * disc_factor * g_loss
                        + config.entropy_loss_weight * res.entropy_loss
                        + config.commit_loss_weight * res.commit_loss)
            state.gen_opt.step(torch.autograd.grad(gen_loss, gen_params))

            # ---------------- discriminator
            disc.train()
            logits_real = disc(images)
            logits_fake = disc(recon.detach())
            d_loss = d_loss_fn(logits_real, logits_fake)
            lecam = L.lecam_reg(logits_real, logits_fake, state.lecam)
            disc_loss = disc_factor * (d_loss + config.lecam_weight * lecam)
            state.disc_opt.step(torch.autograd.grad(disc_loss,
                                                    state.disc_opt.params))

        state.lecam = L.lecam_update(state.lecam, logits_real.detach(),
                                     logits_fake.detach())
        if state.ema_params is not None:
            ema_update(state.ema_params, model, decay=config.ema_decay,
                       num_updates=state.step)
        metrics = {
            "gen_loss": gen_loss, "disc_loss": disc_loss, "d_loss": d_loss,
            "lecam": lecam, "rec_loss": rec, "nll_loss": nll,
            "p_loss": p_loss, "g_loss": g_loss, "d_weight": d_weight,
            "entropy_loss": res.entropy_loss,
            "commit_loss": res.commit_loss,
            "per_sample_entropy": res.per_sample_entropy,
            "codebook_entropy": res.codebook_entropy}
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def build_lpips_apply(lpips_ckpt, net: str = "vgg", device="cuda") -> LPIPS:
    """The perceptual term's LPIPS (the reference's vqperceptual.py:152-158)
    on `device`, frozen: gradients flow only through its inputs. Called as
    fn(x, y) on [-1, 1] NHWC images -> per-image distances. `lpips_ckpt` as
    `resolve_lpips_params` takes it ("random" for smoke tests; None
    raises: the trunk is required)."""
    model = LPIPS(net=net, device=resolve_device(device))
    model.load_state_dict(resolve_lpips_params(model, lpips_ckpt, net))
    return model.requires_grad_(False).eval()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the MAGVIT2 LFQ tokenizer "
                                            "with the PyTorch port.")
    p.add_argument("--images_npy", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--max_train_steps", type=int, default=1000,
                   help="number of micro-batches (optimizer updates happen "
                        "every --accumulate_grad_batches of these)")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--disc_start", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--accumulate_grad_batches", type=int, default=1,
                   help="both optimizers step every N micro-batches "
                        "(lfqgan.py:161)")
    p.add_argument("--adam_beta_1", type=float, default=0.5)
    p.add_argument("--adam_beta_2", type=float, default=0.9)
    p.add_argument("--scheduler_type", type=str, default="none",
                   choices=["none", "linear-warmup",
                            "linear-warmup_cosine-decay"],
                   help="LR schedule attached to BOTH optimizers "
                        "(lfqgan.py:227-238)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="warmup updates (the reference derives this from "
                        "warmup_epochs * steps_per_epoch)")
    p.add_argument("--min_learning_rate", type=float, default=0.0,
                   help="cosine floor; multiplier_min = min_lr / lr "
                        "(lfqgan.py:232-234)")
    p.add_argument("--use_actnorm", action="store_true",
                   help="ActNorm discriminator instead of BatchNorm "
                        "(discriminator/model.py:30-36)")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="VGG-LPIPS weights for the perceptual loss (the "
                        "reference's vgg.pth, a torchvision VGG16 state dict "
                        "or the JAX package's flax .msgpack), or 'random' "
                        "for random trunk weights (smoke tests only). The "
                        "reference trains with perceptual_weight=1.0 "
                        "(vqperceptual.py:152-158); without this the "
                        "perceptual term is 0.")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Train on a .npy of uint8 images (N, H, W, 3); save the tokenizer."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    config = VQConfig(disc_start=args.disc_start,
                      use_actnorm=args.use_actnorm)
    images = np.load(args.images_npy, mmap_mode="r")
    size = args.image_size or images.shape[1]
    config.resolution = size

    def to_batch(u8):
        return torch.from_numpy(np.asarray(u8).astype(np.float32)
                                / 127.5 - 1.0).to(dev)

    num_updates = args.max_train_steps // max(args.accumulate_grad_batches, 1)
    opt = functools.partial(
        build_tokenizer_optimizer, learning_rate=args.learning_rate,
        beta1=args.adam_beta_1, beta2=args.adam_beta_2,
        scheduler_type=args.scheduler_type, warmup_steps=args.warmup_steps,
        training_steps=num_updates, min_learning_rate=args.min_learning_rate,
        grad_accum_steps=args.accumulate_grad_batches)
    state = create_tokenizer_state(
        config, opt, opt, args.seed, image_size=size,
        disc_init_batch=to_batch(images[:min(8, len(images))]), device=dev)
    lpips_apply = None
    if args.lpips_ckpt:
        lpips_apply = build_lpips_apply(args.lpips_ckpt, device=dev)
    elif config.perceptual_weight:
        warnings.warn(
            "Training WITHOUT the LPIPS perceptual loss (no --lpips_ckpt): "
            "the reference's generator loss is L1 + VGG-LPIPS at weight "
            f"{config.perceptual_weight} (vqperceptual.py:152-158) — "
            "dynamics will diverge from the reference. Pass --lpips_ckpt "
            "vgg.pth (or 'random' for smoke tests).", stacklevel=1)
    step_fn = make_tokenizer_train_step(config, lpips_apply=lpips_apply)

    rng = np.random.RandomState(args.seed)
    for i in range(args.max_train_steps):
        idx = rng.randint(0, len(images), args.batch_size)
        state, metrics = step_fn(state, to_batch(images[idx]))
        if i % 20 == 0:
            print(f"step {i} gen {float(metrics['gen_loss']):.4f} "
                  f"rec {float(metrics['rec_loss']):.4f} "
                  f"disc {float(metrics['disc_loss']):.4f}")

    save_tokenizer(args.output_dir, state.ema_params
                   if state.ema_params is not None else state.model, config)
    print(f"saved tokenizer to {args.output_dir}")


if __name__ == "__main__":
    main()
