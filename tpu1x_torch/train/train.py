"""Training CLI of the port: the JAX package's `tpu1x/train/train.py`, flag
for flag, on the card.

    python -m tpu1x_torch.train.train --genie_config configs/genie_138m.json \
        --train_data_dir DATA --val_data_dir VAL --output_dir OUT

The loop is the JAX trainer's: `ShardedBatchLoader` epochs (skipping the
batches already consumed on resume), the background prefetcher, gradient
accumulation through `TrainOptimizer`, logging at update 1 and every 10th
(device metrics read on the host only there), `step_N` full-state
checkpoints beside `step_N_hf` model exports, eval every n updates,
`visualize`'s KV-cached rollout written as a token dataset (`vis_step_N`;
with `--tokenizer_ckpt` also decoded to `pred_vs_gtruth.png`, and with
`--lpips_ckpt` the train-time LPIPS logged),
a collective preemption flag checked at every update, and at the end
`final_checkpt` and `final_checkpt_hf` in both model layouts (the JAX
package's `params.msgpack` and the reference's `model.safetensors`).
Metrics go to `{output_dir}/metrics.jsonl`, and to wandb where it imports.

Beside the JAX flags: `--device` (`cuda`, the default, or `cpu`, which runs
the plain versions). `--no_compile` is accepted and does nothing, as in JAX.
With several processes (torchrun, or the JAX trainer's `TPU1X_MULTIHOST`
variables; see `parallel/mesh.py`) the ranks form a (data, model) mesh of
world / tp x tp: with `--tp N` each layer's heads and MLP columns split over
N consecutive ranks (`parallel/tensor.py`), which read the same rows of
each batch, and the model trains under DDP over the data axis, or FSDP2
with `--fsdp`; in one process `--fsdp` changes nothing, as a one-device
mesh does in JAX. The JAX trainer keeps its tp inside a process (devices);
here a rank is a process, so `--tp` must divide the world size and the
heads. The global batch is per_device x world x accumulation, as the JAX
CLI's per_device x devices.

    torchrun --nproc_per_node 2 -m tpu1x_torch.train.train --device cpu \
        --tp 2 ...

Where the JAX trainer counts its step in micro-batches (its resume after
accumulation skips `accumulation` times too many batches; ROADMAP queue C),
this one counts updates, and a resumed run continues where the saved one
stopped. With accumulation above 1 the two resumed trajectories differ.
"""

from __future__ import annotations

import argparse
import json
import math
import signal
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.data.token_store import (RawTokenDataset, ShardedBatchLoader,
                                          write_token_dataset)
from tpu1x_torch.models.st_maskgit import (STMaskGIT, count_params,
                                           flops_per_update_step)
from tpu1x_torch.parallel import mesh, sharding
from tpu1x_torch.serving import resolve_device
from tpu1x_torch.eval.evaluate import load_model_checkpoint
from tpu1x_torch.eval.metrics import make_lpips_fn
from tpu1x_torch.eval.visualize import decode_latents_wrapper
from tpu1x_torch.train.checkpoint import (Checkpointer, save_pretrained,
                                          save_pretrained_torch)
from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.prefetch import DevicePrefetcher
from tpu1x_torch.train.step import (TrainState, make_eval_step,
                                    make_train_step, shard_train_state)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train a spatial-temporal MaskGIT world model with the "
                    "PyTorch port.")
    # data
    p.add_argument("--train_data_dir", type=str, default="data/train_v1.1")
    p.add_argument("--val_data_dir", type=str, default="data/val_v1.1")
    p.add_argument("--window_size", type=int, default=16)
    p.add_argument("--stride", type=int, default=15)
    p.add_argument("--filter_overlaps", action="store_true")
    # model
    p.add_argument("--genie_config", type=str, required=True)
    p.add_argument("--warmstart_path", type=str, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    # training
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--per_device_eval_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="force remat on (default follows config.remat)")
    p.add_argument("--remat_policy", type=str, default=None,
                   choices=["none", "attn_outs", "dots", "dots_no_batch"],
                   help="what per-block remat keeps for the backward "
                        "(default from the config, 'attn_outs')")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--max_eval_steps", type=int, default=int(1e10))
    p.add_argument("--eval_every_n_steps", type=int, default=1000)
    p.add_argument("--vis_every_n_steps", type=int, default=1000)
    p.add_argument("--lr_scheduler_type", type=str, default="linear",
                   choices=["linear", "cosine", "constant",
                            "constant_with_warmup", "custom_cosine"])
    p.add_argument("--num_warmup_steps", type=int, default=0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--attention_dropout", type=float, default=0.0)
    p.add_argument("--adam_beta_1", type=float, default=0.9)
    p.add_argument("--adam_beta_2", type=float, default=0.999)
    p.add_argument("--adam_eps", type=float, default=1e-8)
    # misc
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--checkpointing_steps", type=str, default="1000")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--overfit_first_batch", action="store_true")
    p.add_argument("--report_to", type=str, default="jsonl",
                   choices=["jsonl", "wandb", "none"])
    p.add_argument("--mu_transfer", action="store_true")
    p.add_argument("--no_compile", action="store_true",
                   help="accepted for the reference CLI's sake; no-op")
    p.add_argument("--tokenizer_ckpt", type=str, default=None,
                   help="MAGVIT2 tokenizer checkpoint: visualize decodes "
                        "the generated and ground-truth frames to "
                        "pred_vs_gtruth.png")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="LPIPS (AlexNet) weights, with --tokenizer_ckpt: "
                        "visualize logs the train-time lpips; 'random' for "
                        "random weights (smoke only)")
    # parallelism
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: the ranks each layer's "
                        "heads and MLP columns split over")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters, gradients and moments over the "
                        "ranks (FSDP2)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


class MetricsLogger:
    def __init__(self, output_dir, report_to: str, experiment_config: dict):
        self.report_to = report_to
        self.wandb = None
        self.path = Path(output_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if report_to == "wandb":
            try:
                import wandb
                self.wandb = wandb.init(project="1XGPT_tpu1x_torch",
                                        config=experiment_config)
            except Exception as e:  # no wandb, or no account
                print(f"wandb unavailable ({e}); falling back to jsonl")
        with open(self.path, "a") as f:
            f.write(json.dumps({"experiment_config": {
                k: v for k, v in experiment_config.items()
                if isinstance(v, (int, float, str, bool, type(None)))}}) + "\n")

    def log(self, metrics: dict, step: int):
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)
        if self.report_to != "none":
            with open(self.path, "a") as f:
                f.write(json.dumps({"step": step, **metrics}) + "\n")


def _any_rank(flag: bool, device) -> bool:
    """True on every rank when it is true on any (the preemption vote)."""
    if mesh.process_count() == 1:
        return flag
    t = torch.tensor(int(flag), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def main(argv=None):
    args = parse_args(argv)
    np.random.seed(args.seed)
    resolve_device(args.device)
    owns_group = mesh.init_distributed(args.device)
    try:
        _train(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args):
    process_index, process_count = mesh.process_index(), mesh.process_count()
    if args.tp < 1 or process_count % args.tp:
        raise ValueError(f"--tp {args.tp} must divide the {process_count} "
                         f"processes")
    # the loaders read by data rank: a model group's ranks share their rows
    data_index, data_count = process_index // args.tp, \
        process_count // args.tp
    device = mesh.local_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    train_dataset = RawTokenDataset(args.train_data_dir,
                                    window_size=args.window_size,
                                    stride=args.stride,
                                    filter_overlaps=args.filter_overlaps)
    if not args.overfit_first_batch:
        eval_dataset = RawTokenDataset(args.val_data_dir,
                                       window_size=args.window_size,
                                       stride=args.stride, filter_overlaps=True)
    else:
        gbs = args.per_device_train_batch_size * process_count \
            * args.gradient_accumulation_steps
        train_dataset.valid_start_inds = train_dataset.valid_start_inds[:gbs]
        eval_dataset = train_dataset

    metadata = train_dataset.metadata
    config = GenieConfig.from_pretrained(args.genie_config)
    # --mu_transfer opts in to muP; a config that declares it keeps it
    if args.mu_transfer:
        config.use_mup = True
    elif config.use_mup:
        print("warning: config declares use_mup=true; honoring it although "
              "--mu_transfer was not passed (optimizer muP scaling follows "
              "the config)")
        args.mu_transfer = True
    config.image_vocab_size = metadata["vocab_size"]
    config.T = args.window_size
    config.S = metadata["s"] ** 2
    config.attn_drop = args.attention_dropout
    if args.gradient_checkpointing:
        config.remat = True
    if args.remat_policy is not None:
        config.remat_policy = args.remat_policy
    config.__post_init__()
    if config.num_heads % args.tp:
        raise ValueError(f"--tp {args.tp} must divide the {config.num_heads} "
                         f"heads")

    global_batch_size = args.per_device_train_batch_size * process_count
    effective_batch_size = global_batch_size * args.gradient_accumulation_steps
    seq_len = config.T * config.S

    with_actions = (train_dataset.actions is not None
                    and config.action_vocab_size > 0)
    loader = ShardedBatchLoader(train_dataset, global_batch_size,
                                data_index, data_count, seed=args.seed,
                                with_actions=with_actions)
    eval_loader = ShardedBatchLoader(
        eval_dataset, args.per_device_eval_batch_size * process_count,
        data_index, data_count, seed=0, shuffle=False)

    if len(train_dataset) == 0:
        raise ValueError(
            f"train dataset at {args.train_data_dir} yields 0 examples: "
            f"window_size={args.window_size} x stride={args.stride} spans "
            f"{(args.window_size - 1) * args.stride + 1} frames but the "
            f"dataset has {metadata['num_images']}")
    steps_per_epoch = max(len(loader) // args.gradient_accumulation_steps, 1)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
    num_epochs = math.ceil(args.max_train_steps / steps_per_epoch)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = STMaskGIT(config, device=device).init_weights(
        torch.Generator(device=device).manual_seed(args.seed))
    if args.warmstart_path:
        model.load_state_dict(
            load_model_checkpoint(args.warmstart_path)[0])
    optimizer = TrainOptimizer(
        model, config, args.learning_rate, weight_decay=args.weight_decay,
        beta1=args.adam_beta_1, beta2=args.adam_beta_2, eps=args.adam_eps,
        max_grad_norm=args.max_grad_norm,
        lr_scheduler_type=args.lr_scheduler_type,
        num_warmup_steps=args.num_warmup_steps,
        num_training_steps=args.max_train_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        mu_transfer=args.mu_transfer)
    num_params = count_params(model)
    state = TrainState(0, model, optimizer, generator)
    if process_count > 1:  # one process trains unwrapped, as on one device
        state = shard_train_state(state, device, fsdp=args.fsdp, tp=args.tp)
    train_step = make_train_step(state.model, state.optimizer, config,
                                 device=device, generator=state.generator)
    state = train_step.state
    eval_step = make_eval_step(state.model, config, device=device)

    ckpt = Checkpointer(args.output_dir)
    if args.resume_from_checkpoint:
        restore_name = Path(args.resume_from_checkpoint).name
        state = ckpt.restore(Path(args.resume_from_checkpoint).resolve(),
                             state)
        print(f"resumed from {restore_name} at step "
              f"{state.optimizer.updates}")
    # the loader's position: the epoch and the micro-batches it consumed
    first_epoch, start_batch = divmod(state.step, max(len(loader), 1))

    experiment_config = vars(args) | {
        "model_parameters": num_params,
        "model_parameters_M": round(num_params / 1e6),
        "seq_len": seq_len,
        "hz": metadata.get("hz", 30) / args.stride,
        "effective_batch_size": effective_batch_size,
        "effective_batch_size_tokens": effective_batch_size * seq_len,
        "num_devices": process_count,
        "mesh": str(sharding.mesh_of(state.model).shape),
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
    }
    flops_per_step = flops_per_update_step(
        num_params, experiment_config["effective_batch_size_tokens"])
    experiment_config["FLOPs_per_update_step"] = flops_per_step
    logger = (MetricsLogger(args.output_dir, args.report_to,
                            experiment_config) if process_index == 0 else None)
    print(f"***** Running training ***** params={num_params/1e6:.1f}M "
          f"examples={len(train_dataset)} steps={args.max_train_steps} "
          f"ranks={process_count} device={device} "
          f"mesh={sharding.mesh_of(state.model).shape}")

    checkpointing_steps = (int(args.checkpointing_steps)
                           if args.checkpointing_steps.isdigit() else None)

    def save_hf(dir_, torch_layout=False):
        """The model-only exports, written by rank 0 from the whole
        weights (gathered from every rank under FSDP2)."""
        sd = sharding.full_state_dict(state.model)
        if process_index == 0:
            save_pretrained(dir_, sd, config)
            if torch_layout:
                save_pretrained_torch(dir_, sd, config)

    # on SIGTERM / SIGINT: finish the update, checkpoint, stop
    preempted = {"flag": False}

    def _handle(sig, frame):
        print(f"received signal {sig}; checkpointing at next step boundary")
        preempted["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handle)
        except ValueError:
            pass  # not in the main thread

    completed_steps = state.optimizer.updates
    # device metrics are read on the host only at log boundaries
    pending_metrics = []
    _t = time.time()
    done = completed_steps >= args.max_train_steps
    for epoch in range(first_epoch, num_epochs):
        if done:
            break
        skip, start_batch = start_batch, 0
        with DevicePrefetcher(loader.epoch(epoch, start_batch=skip),
                              device) as batches:
            for tokens, actions in batches:
                metrics = train_step(tokens, actions)
                pending_metrics.append(metrics)
                if state.optimizer.micro != 0:
                    continue
                completed_steps = state.optimizer.updates

                if completed_steps % 10 == 0 or completed_steps == 1:
                    losses = [float(m["loss"]) for m in pending_metrics]
                    batch_time = (time.time() - _t) / len(losses) \
                        * args.gradient_accumulation_steps
                    avg_loss = sum(losses) / len(losses)
                    log = {
                        "train_loss": avg_loss,
                        "train_perplexity": math.exp(min(avg_loss, 50)),
                        "train_acc": float(metrics["acc"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "epoch": epoch,
                        "examples_processed":
                            completed_steps * effective_batch_size,
                        "flops": completed_steps * flops_per_step,
                        "throughput_examples":
                            effective_batch_size / batch_time,
                    }
                    if logger is not None:
                        logger.log(log, step=completed_steps)
                    print(f"step {completed_steps} loss {avg_loss:.4f} "
                          f"acc {log['train_acc']:.4f} "
                          f"({log['throughput_examples']:.1f} ex/s)")
                    pending_metrics = []
                    _t = time.time()

                if checkpointing_steps and \
                        completed_steps % checkpointing_steps == 0:
                    ckpt.save(state, f"step_{completed_steps}")
                    save_hf(Path(args.output_dir)
                            / f"step_{completed_steps}_hf")

                if completed_steps % args.eval_every_n_steps == 0:
                    eval_metrics = run_eval(eval_step, eval_loader, device,
                                            args.max_eval_steps, args.seed)
                    if logger is not None:
                        logger.log(eval_metrics, step=completed_steps)
                    print(f"step {completed_steps} {eval_metrics}")

                if completed_steps % args.vis_every_n_steps == 0:
                    sd = sharding.full_state_dict(state.model)
                    if process_index == 0:
                        visualize(sd, config, eval_dataset, args,
                                  completed_steps, device, logger)

                # agree on preemption collectively: a rank that stops to
                # checkpoint while another enters the next step deadlocks
                if _any_rank(preempted["flag"], device):
                    ckpt.save(state, f"step_{completed_steps}", wait=True)
                    print(f"preemption checkpoint saved at step "
                          f"{completed_steps}")
                    done = True
                    break

                if completed_steps >= args.max_train_steps:
                    done = True
                    break
        if args.checkpointing_steps == "epoch":
            ckpt.save(state, f"epoch_{epoch}")

    ckpt.save(state, "final_checkpt", wait=True)
    save_hf(Path(args.output_dir) / "final_checkpt_hf", torch_layout=True)
    ckpt.close()
    print("training done")


def visualize(state_dict, config, eval_dataset, args, step, device,
              logger=None):
    """Autoregressive rollouts of up to 4 eval windows from half a window
    of prompt (KV-cached, 2 MaskGIT steps, on `DecodeEngine`), written as
    a token dataset [prediction | ground truth] under `vis_step_{step}`;
    with `--tokenizer_ckpt`, `decode_figures` too. A failure is printed
    and training goes on, as in the JAX trainer."""
    import functools

    from tpu1x_torch.models.sampler import generate_cached
    from tpu1x_torch.serving import DecodeEngine, prepare_serving_params

    try:
        n = min(4, len(eval_dataset))
        if n == 0:
            return
        tokens = eval_dataset.get_batch(np.arange(n))  # (n, T, H, W)
        num_prompt = args.window_size // 2
        model = STMaskGIT(config, device=device)
        model.load_state_dict(state_dict)
        engine = DecodeEngine(config, device=device)
        params = prepare_serving_params(model.eval(), config,
                                        compute_dtype=engine.dtype,
                                        device=device)
        del model
        prompt = torch.from_numpy(tokens[:, :num_prompt].reshape(n, -1)).to(
            device).long()
        with torch.no_grad():
            out, _ = generate_cached(
                functools.partial(engine.prefill, params),
                functools.partial(engine.decode_frame, params), prompt,
                args.window_size - num_prompt,
                torch.Generator(device=device).manual_seed(step), config,
                maskgit_steps=2)
        h = config.latent_side_len
        pred = out.cpu().numpy().reshape(n, args.window_size, h, h)
        stream = np.concatenate([pred, tokens[:, num_prompt:]],
                                axis=1).reshape(-1, h, h)
        vis_dir = Path(args.output_dir) / f"vis_step_{step}"
        write_token_dataset(
            vis_dir, stream, vocab_size=config.image_vocab_size,
            extra_metadata={"num_prompt_frames": num_prompt,
                            "window_size": args.window_size})
        if args.tokenizer_ckpt:
            decode_figures(pred[:, num_prompt:], tokens[:, num_prompt:],
                           vis_dir, args, step, device, logger)
    except Exception:  # visualization must never kill training
        print(f"visualization failed at step {step}:")
        traceback.print_exc()


def decode_figures(pred_tokens, gtruth_tokens, vis_dir, args, step, device,
                   logger=None):
    """The generated frames (n, t, h, w) and their ground truth decoded
    with `--tokenizer_ckpt`, written as one grid, each example's generated
    row above its ground-truth row, (n 2 H, t W, 3), to `pred_vs_gtruth.png`
    (`.npy` without PIL); with `--lpips_ckpt`, the mean LPIPS of the
    generated frames from the ground truth, printed and logged as `lpips`."""
    decode = decode_latents_wrapper(ckpt_path=args.tokenizer_ckpt,
                                    device=device)
    n, t = pred_tokens.shape[:2]
    pred_frames = decode(pred_tokens.reshape(-1, *pred_tokens.shape[2:]))
    gtruth_frames = decode(gtruth_tokens.reshape(-1, *gtruth_tokens.shape[2:]))
    fh, fw = pred_frames.shape[1:3]

    def rows(frames):  # (n t, H, W, 3) -> (n, H, t W, 3)
        return frames.reshape(n, t, fh, fw, 3).transpose(
            0, 2, 1, 3, 4).reshape(n, fh, t * fw, 3)
    grid = np.concatenate([rows(pred_frames), rows(gtruth_frames)],
                          axis=1).reshape(n * 2 * fh, t * fw, 3)
    try:
        from PIL import Image
        Image.fromarray(grid).save(vis_dir / "pred_vs_gtruth.png")
    except ImportError:
        np.save(vis_dir / "pred_vs_gtruth.npy", grid)

    if args.lpips_ckpt:
        lpips_fn = make_lpips_fn(args.lpips_ckpt, device=device)
        lpips_val = float(np.mean(lpips_fn(gtruth_frames, pred_frames)))
        if logger is not None:
            logger.log({"lpips": lpips_val}, step=step)
        print(f"step {step} train-time lpips {lpips_val:.4f}")


def run_eval(eval_step, eval_loader, device, max_eval_steps, seed):
    losses, accs = [], []
    generator = torch.Generator(device=device).manual_seed(seed)
    for i, batch in enumerate(eval_loader.epoch(0)):
        if i >= max_eval_steps:
            break
        tokens = mesh.put_global_batch(batch["tokens"], device)
        m = eval_step(tokens, generator=generator)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    if not losses:
        return {}
    eval_loss = float(np.mean(losses))
    return {"eval_loss": eval_loss,
            "eval_perplexity": math.exp(min(eval_loss, 50)),
            "eval_teacher_acc": float(np.mean(accs))}


if __name__ == "__main__":
    main()
