"""Tokenize CLI: raw video frames -> a token dataset (`video.bin`,
`metadata.json`, `segment_ids.bin`), with the port's MAGVIT2 encoder and
LFQ on the card; the JAX package's `tpu1x/tokenizer/tokenize.py`.

    python -m tpu1x_torch.tokenizer.tokenize --frames frames.npy \\
        --tokenizer_ckpt TOK --output_dir data/my_tokens [--device cpu]

Input: a .npy of uint8 frames (N, H, W, 3), or a directory of such files
taken in sorted order, each file one segment. The ids use the dataset bit
convention, which `decode_tokens` and the visualizer read back
(`tokenizer/lfq.py`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tpu1x_torch.data.token_store import write_token_dataset
from tpu1x_torch.serving import resolve_device
from tpu1x_torch.tokenizer.checkpoint import load_tokenizer
from tpu1x_torch.tokenizer.vqmodel import VQModel


@torch.no_grad()
def encode_frames(model: VQModel, frames_u8: np.ndarray,
                  batch_size: int = 16, device="cuda") -> np.ndarray:
    """uint8 (N, H, W, 3) -> int32 token ids (N, h, w), `batch_size`
    frames a call (the tail padded with copies of its last frame), on
    `device` (the card unless asked otherwise; raises without one). The
    model is moved there."""
    dev = resolve_device(device)
    model.to(dev).eval()
    out = []
    n = len(frames_u8)
    for lo in range(0, n, batch_size):
        chunk = frames_u8[lo:lo + batch_size]
        real = len(chunk)
        if real < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - real, 0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev).float()
        ids = model.encode(x / 127.5 - 1.0).indices
        out.append(ids[:real].cpu().numpy())
    return np.concatenate(out)


def load_frames(path) -> list:
    """[(segment name, uint8 array (N, H, W, 3)), ...]: one .npy, or every
    .npy of a directory in sorted order."""
    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.iterdir() if p.suffix == ".npy")
        if not files:
            raise FileNotFoundError(f"no .npy files under {path}")
        return [(p.stem, np.load(p)) for p in files]
    return [(path.stem, np.load(path))]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Tokenize raw video frames into a video.bin dataset "
                    "with the PyTorch port.")
    p.add_argument("--frames", type=str, required=True,
                   help=".npy of uint8 (N,H,W,3) frames, or a directory of "
                        "such files (one segment each)")
    p.add_argument("--tokenizer_ckpt", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--hz", type=float, default=30.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    state, config = load_tokenizer(args.tokenizer_ckpt)
    model = VQModel(config, device=dev)
    model.load_state_dict(state)

    all_ids, segment_ids = [], []
    for seg, (name, frames) in enumerate(load_frames(args.frames)):
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"{name}: frames of shape {frames.shape}, "
                             f"expected (N, H, W, 3)")
        ids = encode_frames(model, frames.astype(np.uint8), args.batch_size,
                            dev)
        all_ids.append(ids)
        segment_ids.append(np.full(len(ids), seg, dtype=np.int32))
        print(f"segment {seg} ({name}): {len(ids)} frames -> "
              f"{ids.shape[1]}x{ids.shape[2]} tokens")

    tokens = np.concatenate(all_ids)
    write_token_dataset(args.output_dir, tokens, hz=args.hz,
                        vocab_size=config.codebook_size,
                        segment_ids=np.concatenate(segment_ids))
    print(f"wrote {len(tokens)} token frames to {args.output_dir}")


if __name__ == "__main__":
    main()
