"""Generation CLI: roll out the frames after a prompt for one or more
examples of a token dataset, with the PyTorch port.

Keeps `num_prompt_frames` frames of each example, generates the rest of the
window frame by frame with MaskGIT (`RolloutEngine`: KV-cached by default,
whole-sequence forwards with `--no_kv_cache`) and writes the token stream
[prompt | predicted | ground truth] of every example to
`output_dir/video.bin`, with `num_prompt_frames` and `window_size` in its
`metadata.json` for the visualizer.

    python -m tpu1x_torch.eval.generate --val_data_dir DATA \\
        --checkpoint_dir CKPT --output_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from tpu1x_torch.data.token_store import RawTokenDataset, write_token_dataset
from tpu1x_torch.eval.evaluate import load_model_checkpoint
from tpu1x_torch.rollout.engine import RolloutEngine


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate frames with a "
                                            "GENIE-style model and the "
                                            "PyTorch port.")
    p.add_argument("--val_data_dir", type=str, default="data/val_v1.1")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--num_prompt_frames", type=int, default=8)
    p.add_argument("--window_size", type=int, default=16)
    p.add_argument("--stride", type=int, default=15)
    p.add_argument("--example_ind", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=1,
                   help="generate this many consecutive examples at once")
    p.add_argument("--maskgit_steps", type=int, default=2)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_kv_cache", action="store_true",
                   help="whole-sequence forwards instead of the KV-cached "
                        "decode")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dataset = RawTokenDataset(args.val_data_dir, window_size=args.window_size,
                              stride=args.stride)
    state, config = load_model_checkpoint(args.checkpoint_dir)
    engine = RolloutEngine(state, config, device=args.device,
                           maskgit_steps=args.maskgit_steps,
                           temperature=args.temperature,
                           decode="full" if args.no_kv_cache else "cached")

    idx = np.arange(args.example_ind, args.example_ind + args.batch_size)
    tokens_BTHW = dataset.get_batch(idx)  # (B, T, H, W)
    B, P = tokens_BTHW.shape[0], args.num_prompt_frames
    n_new = args.window_size - P
    prompt = torch.from_numpy(tokens_BTHW[:, :P])
    generator = torch.Generator(device=engine.device).manual_seed(args.seed)
    start = time.perf_counter()
    out = engine.rollout(prompt, n_new, generator)[:, 0].cpu().numpy()
    print(f"generated {B}x{n_new} frames in "
          f"{time.perf_counter() - start:.2f}s")

    h = config.latent_side_len
    stream = np.concatenate([out, tokens_BTHW[:, P:]], axis=1).reshape(
        -1, h, h)
    write_token_dataset(
        args.output_dir, stream,
        hz=dataset.metadata.get("hz", 30) / args.stride,
        vocab_size=config.image_vocab_size,
        token_dtype=dataset.metadata.get("token_dtype", "uint32"),
        extra_metadata={"num_prompt_frames": P,
                        "window_size": args.window_size})
    print(f"wrote {Path(args.output_dir) / 'video.bin'}")


if __name__ == "__main__":
    main()
