"""Visualization: decode token frames to images, export GIFs and comic
grids; the JAX package's `tpu1x/eval/visualize.py` with the port.

- `decode_latents_wrapper`: ids (N, h, w) -> uint8 frames (N, H, W, 3)
  through the MAGVIT2 decoder on the card (the config's dtype, bf16 by
  default), `batch_size` frames a call, the tail padded; ids in the
  dataset bit order (`tokenizer/lfq.py`).
- `export_to_gif` at 2 fps; `make_comic`, the two-row PNG grid of a
  generate CLI stream [prompt | predicted | ground truth] with Prompt /
  Generated / Ground truth captions (`metadata.json`'s `num_prompt_frames`
  and `window_size`). PIL is imported inside these functions.

    python -m tpu1x_torch.eval.visualize --token_dir OUT \\
        --tokenizer_ckpt TOK [--device cpu]
"""

from __future__ import annotations

import argparse
import warnings
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from tpu1x_torch.config import VQConfig
from tpu1x_torch.data.token_store import RawTokenDataset
from tpu1x_torch.serving import resolve_device
from tpu1x_torch.tokenizer.checkpoint import load_tokenizer
from tpu1x_torch.tokenizer.vqmodel import VQModel, rescale_magvit_output


def decode_latents_wrapper(ckpt_path: Optional[str] = None,
                           batch_size: int = 16,
                           config: Optional[VQConfig] = None,
                           device="cuda") -> Callable:
    """A decoder of token frames on `device` (the card unless asked
    otherwise; raises without one).

    ckpt_path: a tokenizer checkpoint (`tokenizer/checkpoint.py`: either
    package's directory, or the reference's `.ckpt`). None decodes with
    seeded random weights at `config` (default `VQConfig()`), with a
    warning: the frames, and any LPIPS of them, are meaningless.
    Returns fn: (N, h, w) int ids -> (N, H, W, 3) uint8 numpy frames.
    """
    dev = resolve_device(device)
    if ckpt_path is not None:
        state, config = load_tokenizer(ckpt_path)
        model = VQModel(config, device=dev)
        model.load_state_dict(state)
    else:
        warnings.warn(
            "decode_latents_wrapper: no tokenizer checkpoint given — "
            "decoding with RANDOMLY INITIALIZED weights; frames (and any "
            "LPIPS computed from them) are garbage. Pass ckpt_path for real "
            "output.",
            stacklevel=2)
        model = VQModel(config or VQConfig(), device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(0))
    model.eval()

    @torch.no_grad()
    def wrapper(ids_NHW) -> np.ndarray:
        ids = np.asarray(ids_NHW, dtype=np.int32)
        out = []
        for lo in range(0, len(ids), batch_size):
            chunk = ids[lo:lo + batch_size]
            real = len(chunk)
            if real < batch_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], batch_size - real, 0)])
            frames = rescale_magvit_output(model.decode_tokens(
                torch.from_numpy(chunk).to(dev)))
            out.append(frames[:real].cpu().numpy())
        return np.concatenate(out)

    return wrapper


def export_to_gif(frames: List[np.ndarray], output_path, fps: int = 2) -> None:
    from PIL import Image
    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(str(output_path), save_all=True, append_images=imgs[1:],
                 duration=1000 // fps, loop=0)


def caption_image(img: np.ndarray, text: str) -> np.ndarray:
    """The frame under a 24-pixel white caption strip."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(img)
    strip = Image.new("RGB", (im.width, 24), (255, 255, 255))
    ImageDraw.Draw(strip).text((4, 4), text, fill=(0, 0, 0))
    out = Image.new("RGB", (im.width, im.height + 24))
    out.paste(strip, (0, 0))
    out.paste(im, (0, 24))
    return np.asarray(out)


def caption_for_frame(i: int, num_prompt_frames: int, window_size: int) -> str:
    """Caption of frame i of a stream [prompt | predicted | ground truth]."""
    if i < num_prompt_frames:
        return "Prompt"
    if i < window_size:
        return "Generated"
    return "Ground truth"


def make_comic(frames: np.ndarray, num_prompt_frames: int, window_size: int
               ) -> np.ndarray:
    """Two rows from a stream [prompt (P) | predicted (W-P) | ground truth
    (W-P)]: the top row Prompt + Generated, the bottom row Prompt + Ground
    truth, ground-truth frame i at column i - W + P; blank frames fill the
    shorter row."""
    P, W = num_prompt_frames, window_size
    n = len(frames)
    top, bot = [], []
    for i in range(min(P, n)):
        top.append(caption_image(frames[i], "Prompt"))
        bot.append(caption_image(frames[i], "Prompt"))
    for i in range(P, min(W, n)):
        top.append(caption_image(frames[i], caption_for_frame(i, P, W)))
    for i in range(W, n):
        bot.append(caption_image(frames[i], "Ground truth"))
    blank = caption_image(np.full_like(frames[0], 255), "")
    while len(bot) < len(top):
        bot.append(blank)
    while len(top) < len(bot):
        top.append(blank)
    return np.concatenate([np.concatenate(top, axis=1),
                           np.concatenate(bot, axis=1)], axis=0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualize generated tokens "
                                            "with the PyTorch port.")
    p.add_argument("--token_dir", type=str, required=True,
                   help="directory with video.bin/metadata.json (e.g. the "
                        "generate CLI's output)")
    p.add_argument("--output_prefix", type=str, default=None)
    p.add_argument("--tokenizer_ckpt", type=str, default=None)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ds = RawTokenDataset(args.token_dir, window_size=1,
                         filter_interrupts=False)
    ids = np.asarray(ds.data[:args.max_images]).astype(np.int32)
    frames = decode_latents_wrapper(ckpt_path=args.tokenizer_ckpt,
                                    device=args.device)(ids)

    prefix = args.output_prefix or str(Path(args.token_dir) / "vis")
    meta = ds.metadata
    # the generate CLI writes these keys; a ground-truth dataset has none
    is_generated = "num_prompt_frames" in meta and "window_size" in meta
    if is_generated:
        P, W = meta["num_prompt_frames"], meta["window_size"]
        gif_frames = [caption_image(f, caption_for_frame(i, P, W))
                      for i, f in enumerate(frames)]
    else:
        gif_frames = list(frames)
    export_to_gif(gif_frames, f"{prefix}.gif", fps=args.fps)
    if is_generated:
        from PIL import Image
        Image.fromarray(make_comic(frames, P, W)).save(f"{prefix}_comic.png")
    print(f"wrote {prefix}.gif")


if __name__ == "__main__":
    main()
