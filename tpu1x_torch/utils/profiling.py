"""Tracing and timing: the JAX package's `tpu1x/utils/profiling.py` on
torch.

- `profile_trace`: a `torch.profiler` trace of the enclosed block (host and
  card), written as a Chrome trace.
- `Stopwatch`: steady-state seconds per call, the card synchronized around
  the timed calls.
- analytic FLOPs of training (6 N D) and of a MaskGIT rollout.
- `device_peak_flops`: the H100's data-sheet peak, for MFU.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

# NVIDIA H100 data sheet, dense (without sparsity), FLOP/s by dtype: the SXM
# part at its 700 W limit and the PCIe part
H100_PEAKS = {
    "sxm": {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
            "tfloat32": 495e12, "float32": 67e12},
    "pcie": {"bfloat16": 756e12, "float16": 756e12, "float8": 1513e12,
             "tfloat32": 378e12, "float32": 51e12},
}


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU, and CUDA where there is a card) and
    write `logdir/trace.json`, viewable in Perfetto or chrome://tracing."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Stopwatch:
    """Measure the steady-state time of a callable that launches work on
    the card: the card is synchronized after the warm-up and after the
    timed calls, so the time covers the device's work, not its enqueue."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, warmup: int = 1, iters: int = 10,
                 **kw) -> float:
        for _ in range(warmup):
            self.fn(*args, **kw)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.fn(*args, **kw)
        _sync()
        return (time.perf_counter() - t0) / iters


def training_flops(num_params: int, tokens: int) -> int:
    """6 N D per update step."""
    return 6 * num_params * tokens


def generation_flops(num_params: int, batch: int, seq_tokens: int,
                     num_frames: int, maskgit_steps: int) -> int:
    """Forward FLOPs of a MaskGIT rollout: one full forward (2 N per token)
    per frame per MaskGIT step."""
    return 2 * num_params * batch * seq_tokens * num_frames * maskgit_steps


def device_peak_flops(dtype: str = "bfloat16",
                      device: int = 0) -> Optional[float]:
    """The data-sheet peak FLOP/s of card `device` in `dtype` ("bfloat16",
    "float16", "float8", "tfloat32", "float32"): an H100 SXM or PCIe by
    `torch.cuda.get_device_name`; None for another card or without one."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" not in name:
        return None
    part = "pcie" if "PCIe" in name else "sxm" if (
        "SXM" in name or "HBM3" in name) else None
    return None if part is None else H100_PEAKS[part].get(dtype)
