"""Teacher-forced evaluator: the compression challenge's protocol.

For each frame t in [1, T) of an example, condition on the ground-truth
frames before t and MaskGIT-decode frame t. The metrics are the challenge
CE of the step-0 factored logits (`metrics.compute_loss`), the exact-token
accuracy of the samples, and the generation time per frame, `gen_time`:
the wall time of a batch over (T - 1) x its real examples.

Two paths:
- KV-cached (the default, `eval_all_frames`): one prefill of all T
  ground-truth frames per batch, then for each t = 1 .. T-1 the MaskGIT
  steps of frame t against the cache at t_B = t, each a single-frame
  `DecodeEngine.decode_frame` that reads only the cache slots before t
  (the slots from t on hold later ground truth and are never read).
- Rows (`use_cache=False`): each example expands into T - 1 batch rows,
  row t holding the ground truth before frame t and masks from t on; rows
  are padded to `rows_per_chunk` and every chunk runs `maskgit_generate`,
  a whole-sequence forward per step.

The step-0 logits depend on the ground truth alone, so both paths give the
same CE. On the card every op launches the port's kernels; on the CPU each
takes its plain version.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.data.token_store import RawTokenDataset
from tpu1x_torch.eval.metrics import (AvgMetric, compute_loss, factored_ce,
                                      token_accuracy)
from tpu1x_torch.models.sampler import (maskgit_generate,
                                        maskgit_generate_cached)
from tpu1x_torch.rollout.engine import model_on
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params


def eval_all_frames(engine: DecodeEngine, params, tokens_BTHW: torch.Tensor,
                    generator, config: GenieConfig, maskgit_steps: int = 2,
                    temperature: float = 0.0):
    """The cached path over `engine`: prefill the ground truth (B, T, H, W),
    then decode every frame t = 1 .. T-1 at t_B = t.

    Returns (frames (T-1, B, S) int64, step-0 logits (T-1, B, V, F, h, w)
    fp32), on the engine's device.
    """
    B = tokens_BTHW.shape[0]
    cache = engine.prefill(params, tokens_BTHW)
    decode = functools.partial(engine.decode_frame, params, return_kv=False)
    frames, flogits = [], []
    for t in range(1, config.T):
        frame, logits, _ = maskgit_generate_cached(
            decode, cache, t, generator, config, maskgit_steps=maskgit_steps,
            temperature=temperature, batch_size=B)
        frames.append(frame)
        flogits.append(logits)
    return torch.stack(frames), torch.stack(flogits)


def frame_metrics(tokens_BTHW: torch.Tensor, frames: torch.Tensor,
                  flogits: torch.Tensor, config: GenieConfig):
    """`eval_all_frames`' output -> (samples (B, T-1, h, w), per-example CE
    (B,), per-example accuracy (B,)), computed where the inputs lie: the
    CE summed over the factors and averaged over (T-1, h, w)."""
    B, T, h, w = tokens_BTHW.shape
    # (T-1, B, V, F, h, w) -> the reference's (B, V, F, T-1, h, w), a view
    ce = factored_ce(tokens_BTHW, flogits.permute(1, 2, 3, 0, 4, 5))
    samples = frames.transpose(0, 1).reshape(B, T - 1, h, w)
    acc = (tokens_BTHW[:, 1:] == samples).float().mean((1, 2, 3))
    return samples, ce.mean((1, 2, 3)), acc


class GenieEvaluator:
    """Batched teacher-forced evaluator of an `STMaskGIT` (or its state
    dict) on `device`.

    use_cache: the KV-cached path over `DecodeEngine` (weights prepared once
    by `prepare_serving_params`); else the rows path over the model's
    `compute_logits`, `rows_per_chunk` rows at a time.
    """

    def __init__(self, model, config: GenieConfig, device="cuda",
                 maskgit_steps: int = 2, temperature: float = 0.0,
                 rows_per_chunk: int = 64, use_cache: bool = True):
        self.config = config
        self.maskgit_steps = maskgit_steps
        self.temperature = temperature
        self.rows_per_chunk = rows_per_chunk
        self.use_cache = use_cache
        if use_cache:
            self.engine = DecodeEngine(config, device=device)
            self.device = self.engine.device
            self.params = prepare_serving_params(
                model, config, compute_dtype=self.engine.dtype,
                device=self.device)
        else:
            self.model = model_on(model, config, device)
            self.device = self.model.pos_embed_TSC.device

    def _tokens(self, input_ids) -> torch.Tensor:
        cfg = self.config
        h = cfg.latent_side_len
        x = torch.as_tensor(np.asarray(input_ids), dtype=torch.long)
        return x.reshape(x.shape[0], cfg.T, h, h).to(self.device)

    def _sampling(self):
        return dict(maskgit_steps=self.maskgit_steps,
                    temperature=self.temperature)

    @torch.no_grad()
    def predict_metrics(self, input_ids, generator=None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(B, T*H*W) ids -> (samples (B, T-1, h, w), per-example CE (B,),
        per-example accuracy (B,)) as numpy, on the cached path. CE and
        accuracy are reduced on the device: the (T-1, B, V, F, h, w) logits
        never leave it."""
        if not self.use_cache:
            raise ValueError("predict_metrics takes the KV-cached path")
        tokens = self._tokens(input_ids)
        frames, flogits = eval_all_frames(self.engine, self.params, tokens,
                                          generator, self.config,
                                          **self._sampling())
        return tuple(x.cpu().numpy() for x in frame_metrics(
            tokens, frames, flogits, self.config))

    @torch.no_grad()
    def predict_zframe_logits(self, input_ids, generator=None
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T*H*W) ids -> (samples (B, T-1, h, w), step-0 logits (B, V,
        F, T-1, h, w)) as numpy."""
        tokens = self._tokens(input_ids)
        if not self.use_cache:
            return self._predict_rows(tokens, generator)
        frames, flogits = eval_all_frames(self.engine, self.params, tokens,
                                          generator, self.config,
                                          **self._sampling())
        B, T, h, w = tokens.shape
        samples = frames.transpose(0, 1).reshape(B, T - 1, h, w)
        return (samples.cpu().numpy(),
                flogits.permute(1, 2, 3, 0, 4, 5).cpu().numpy())

    def _predict_rows(self, tokens: torch.Tensor, generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """All T - 1 frame tasks of every example as batch rows."""
        cfg = self.config
        B, T, h, w = tokens.shape
        rows = tokens.repeat_interleave(T - 1, dim=0)  # (B (T-1), T, h, w)
        out_t = torch.arange(1, T, device=self.device).repeat(B)
        frame_idx = torch.arange(T, device=self.device)
        masked = torch.where(
            (frame_idx[None, :] < out_t[:, None])[:, :, None, None], rows,
            cfg.mask_token_id)
        n_rows, chunk = masked.shape[0], self.rows_per_chunk
        samples, logits = [], []
        for lo in range(0, n_rows, chunk):
            hi = min(lo + chunk, n_rows)
            pad = chunk - (hi - lo)
            part, part_t = masked[lo:hi], out_t[lo:hi]
            if pad:  # every chunk at one size, as in the JAX evaluator
                part = torch.cat([part, part[-1:].expand(pad, -1, -1, -1)])
                part_t = torch.cat([part_t, part_t[-1:].expand(pad)])
            s, lg = maskgit_generate(self.model.compute_logits, part, part_t,
                                     generator, cfg, **self._sampling())
            samples.append(s[:hi - lo])
            logits.append(lg[:hi - lo])
        samples = torch.cat(samples).reshape(B, T - 1, h, w)
        logits = torch.cat(logits)  # (B (T-1), V, F, h, w)
        V, Fv = logits.shape[1:3]
        logits = logits.reshape(B, T - 1, V, Fv, h, w).permute(
            0, 2, 3, 1, 4, 5)
        return samples.cpu().numpy(), logits.cpu().numpy()


def evaluate_dataset(evaluator: GenieEvaluator, dataset: RawTokenDataset,
                     batch_size: int = 16, max_examples: Optional[int] = None,
                     save_outputs_dir: Optional[str] = None, seed: int = 42,
                     verbose: bool = True) -> dict:
    """The challenge metrics over a token dataset.

    Every batch has `batch_size` examples: the tail batch is padded with
    copies of its last example, and every metric is weighted by the real
    example count. CE and accuracy are reduced on the device unless
    `save_outputs_dir` asks for the logits (saved with the ground truth and
    the samples as .npy). Returns the means of `loss`, `acc` and `gen_time`
    (s per generated frame: the batch's wall time, read after the device
    has finished, over (T-1) x its real examples), and `count`, the
    examples evaluated. Frame decode and LPIPS wait for the tokenizer.
    """
    cfg = evaluator.config
    dev = evaluator.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    metrics = {k: AvgMetric() for k in ("loss", "acc", "gen_time")}
    outputs = {k: [] for k in ("pred_logits", "gtruth_tokens",
                               "pred_tokens")}
    device_metrics = evaluator.use_cache and save_outputs_dir is None

    n = len(dataset) if max_examples is None else min(len(dataset),
                                                      max_examples)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        real = hi - lo
        tokens_BTHW = dataset.get_batch(np.arange(lo, hi))
        padded = tokens_BTHW
        if real < batch_size:
            padded = np.concatenate([tokens_BTHW, np.repeat(
                tokens_BTHW[-1:], batch_size - real, axis=0)])
        input_ids = padded.reshape(batch_size, -1)

        start = time.perf_counter()
        if device_metrics:
            samples, loss_B, acc_B = evaluator.predict_metrics(input_ids,
                                                               generator)
        else:
            samples, factored_logits = evaluator.predict_zframe_logits(
                input_ids, generator)
            factored_logits = factored_logits[:real]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # over the real frames: the padded rows' work stays in the wall time
        metrics["gen_time"].update(
            (time.perf_counter() - start) / ((cfg.T - 1) * real), real)
        samples = samples[:real]

        if device_metrics:
            metrics["loss"].update_list(loss_B[:real])
            metrics["acc"].update_list(acc_B[:real])
        else:
            metrics["loss"].update(compute_loss(
                input_ids[:real], factored_logits, cfg.num_factored_vocabs,
                cfg.factored_vocab_size), real)
            metrics["acc"].update(token_accuracy(tokens_BTHW, samples), real)

        if save_outputs_dir is not None:
            outputs["pred_logits"].append(factored_logits)
            outputs["gtruth_tokens"].append(tokens_BTHW)
            outputs["pred_tokens"].append(samples)

        if verbose:
            print({k: round(v.mean(), 4) for k, v in metrics.items()})

    if save_outputs_dir is not None:
        out = Path(save_outputs_dir)
        out.mkdir(parents=True, exist_ok=True)
        for key, vals in outputs.items():
            np.save(out / f"{key}.npy", np.concatenate(vals, axis=0))

    results = {k: v.mean() for k, v in metrics.items()}
    results["count"] = metrics["loss"].count
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a GENIE-style model "
                                            "with the PyTorch port.")
    p.add_argument("--val_data_dir", type=str, default="data/val_v1.1")
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="a JAX-package save_pretrained directory, or a "
                        "reference torch checkpoint directory")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--maskgit_steps", type=int, default=2)
    p.add_argument("--temperature", type=float, default=0)
    p.add_argument("--save_outputs_dir", type=str)
    p.add_argument("--max_examples", type=int)
    p.add_argument("--window_size", type=int, default=16)
    p.add_argument("--stride", type=int, default=15)
    p.add_argument("--rows_per_chunk", type=int, default=64)
    p.add_argument("--no_kv_cache", action="store_true",
                   help="decode all frame tasks as batch rows of full "
                        "forwards instead of against the KV cache")
    p.add_argument("--tokenizer_ckpt", type=str, default=None,
                   help="MAGVIT2 tokenizer checkpoint for frame decode; "
                        "not ported yet")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="LPIPS weights; not ported yet")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def load_model_checkpoint(checkpoint_dir
                          ) -> Tuple[dict, GenieConfig]:
    """A JAX-package `save_pretrained` directory (params.msgpack) or a
    reference torch checkpoint directory (model.safetensors or
    pytorch_model.bin, beside config.json) -> (state dict, config)."""
    from tpu1x_torch.train.checkpoint import (load_pretrained,
                                              load_torch_checkpoint)
    path = Path(checkpoint_dir)
    if (path / "params.msgpack").exists():
        return load_pretrained(path)
    config = GenieConfig.from_pretrained(path / "config.json")
    return load_torch_checkpoint(path, config), config


def main(argv=None):
    args = parse_args(argv)
    if args.tokenizer_ckpt or args.lpips_ckpt:
        raise NotImplementedError(
            "frame decode and LPIPS need the tokenizer, which the port does "
            "not have yet (ROADMAP queue A5)")
    dataset = RawTokenDataset(args.val_data_dir, window_size=args.window_size,
                              stride=args.stride, filter_overlaps=True)
    state, config = load_model_checkpoint(args.checkpoint_dir)
    evaluator = GenieEvaluator(state, config, device=args.device,
                               maskgit_steps=args.maskgit_steps,
                               temperature=args.temperature,
                               rows_per_chunk=args.rows_per_chunk,
                               use_cache=not args.no_kv_cache)
    results = evaluate_dataset(
        evaluator, dataset, batch_size=args.batch_size,
        max_examples=args.max_examples,
        save_outputs_dir=args.save_outputs_dir)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
