"""Drive the PyTorch/CUDA port (tpu1x_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the versions.
2. Builds every kernel from tpu1x_torch/csrc with nvcc, all in parallel.
3. Holds each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes of the GENIE_138M rollout (B=16, 8 prompt frames):
   atol = rtol = 3e-2 on outputs. The temporal+MLP block (K2, K3) is held
   as the prefill is (`held_to_plain`): elementwise (3e-2; 2e-2 on its k/v
   outputs, one bf16 product away from the inputs) where it and the plain
   bf16 path agree, all but 1e-4 of the elements, and as a whole within
   3e-2 relative L2 of the plain path and no farther from an fp32 run of
   the plain version than the plain path is.
   Times each kernel, its plain version and, where one PyTorch call computes
   the same function, that call (only timed here, never used by the port),
   and computes each kernel's bound from the H100 SXM data sheet: the larger
   of its bytes over the memory rate, its bf16 products over the tensor
   cores' rate and its fp32 arithmetic over the fp32 units' rate. The
   spatial block also at C = 256 (GENIE_35M's width); the temporal+MLP
   block (one frame and the pair) with the tanh and the exact-erf GELU, at
   C = 512 and at C = 256 with 8 heads; the GEMM of csrc/gemm_sm90.cuh
   alone at the spatial block's two products and the temporal+MLP block's
   two MLP products (fc1 with either GELU, fc2) against a plain product
   with the same rounding, beside torch.matmul. The decode attention (K7,
   K8, both caches) at B = 16, 17, 272 and 16 in turn, and K2 at B = 16
   then 17: a batch must not fail after another.
4. Runs RolloutEngine.rollout at GENIE_138M (random weights from a seed,
   B=16, 8 prompt + 8 new frames, maskgit_steps 2, temperature 0), with
   the launch counters set to 0 just before and read just after; checks
   the counts and the output; times it (median of three runs) and the
   plain path (`PlainDecodeEngine`, this script's own oracle); profiles one
   more run for device time by kernel (which must show the cache attention
   on `decode_ring_kernel` and no `decode_attention_kernel`, the design
   before it); and holds the prefill cache and the
   first step-0 logits against the plain path on the card (see
   `check_prefill_and_logits` for the tolerance).
5. Holds the training kernels against their plain versions' autograd on the
   card at the GENIE_138M train shapes (B=8: 128 rows of (256, 512);
   (8, 16, 256, 512)): the spatial train block's backward, the temporal and
   MLP train blocks forward and backward, and the temporal attention's
   backward, causal and not. Outputs within atol = rtol = 3e-2; every
   gradient elementwise within 3e-2 max|want| + 3e-2 |want| and within 2e-2
   in relative L2 (both paths round to bf16 at several places between the
   products, each rounding 2^-9 relative; the weight gradients sum 32768
   rows in fp32, in another order and, with atomics, in an order that
   changes from run to run). The three train blocks also at C = 256 with 8
   heads (the MLP block with and without LN, both GELUs), and a profile of
   the MLP block's forward and backward must show no GEMM of the port but
   csrc/gemm_sm90.cuh's; then each training form of csrc/gemm_sm90.cuh
   alone at the three blocks' products against its plain version, with its
   TFLOP/s beside torch.matmul's. Last, a training-form GEMM launch and the
   fused attention's backward each as the first card call of a new thread
   (no CUDA context current there, as in autograd's backward thread), held
   against their plain versions.
6. Trains GENIE_138M (random weights and tokens from seed 0, B=8, T=16)
   through `make_train_step` on the card: the launch counters are set to 0
   before the first step and read after it; ten steps on the one batch and
   corruption at a constant learning rate must give a finite loss that
   starts within 1.5 of 2 ln 512 and falls; prints the median step time of
   the last five, the device's busy share and device time by kernel over one
   more step (which must show K9's and K10's kernels, no kernel of
   spatial_block.cu's own and no GEMM but csrc/gemm_sm90.cuh's), and the
   peak memory. Then holds the loss, the gradient norm and
   every parameter's gradient of the kernel path against the plain path and
   an fp32 plain run on the card (see `check_step_against_plain`).
7. The qk_norm=True model and the int8 KV cache, which take each decode
   layer op by op: holds the decode attention kernels (one frame and the
   [prev, cur] pair, bf16 and int8 cache, t_B mixed in 0..15, two layers of
   a (16, 32, 16, 256, 512) cache; and at the pre-LN rollout's t_B, one
   frame 8..15 and the pair 8..14, on the thirds of one (B, frames, S, 3C)
   qkv tensor as K2 and K3 launch them, with their device time and bound),
   the spatial block with the qk-LN, the
   fused attention forward and backward (causal and not, at (128, 256, 16,
   32), SDPA forward and backward as the library time; the forward's lse
   against `mha_lse_reference`, the backward also against
   `flash_mha_bwd_plain` on the forward's residuals) and the MLP train
   block without LN against their plain versions, by the gates of 3 and 5.
   Runs the rollout of 4 on `genie_138m(qk_norm=True)` with the int8 cache
   at full depth (exact launch counts, times, device time by kernel, the
   dequantized prefill cache and the logits against the plain path), and on
   the two other combinations (qk_norm=True with the bf16 cache,
   qk_norm=False with the int8 cache) at 8 layers. Trains
   `genie_138m(qk_norm=True)` as in 6, with its own launch counts, and holds
   the step's gradients against the plain path and an fp32 run.
8. Action conditioning, at 8 layers of GENIE_138M with 16 action ids and
   seeded actions: the rollout of 4 (launch counts, the prefill cache and
   the step-0 logits against the plain path), one `make_train_step` step
   through the kernels and through the plain train blocks (launch counts,
   loss, gradient norm), and the step's gradients as in 6.
9. The evaluation path: K4 through the serving wrapper at the evaluator
   prefill's (16, 16, 256, 512) (on the thirds of one qkv tensor and on
   separate tensors), K1 at its N = 256 and K2 at t_B mixed 1..15 against
   a cache full in every slot, by the gates of 3, on inputs of their own;
   then at GENIE_138M `score_policies` (16 policies, 8 + 8 frames),
   `evaluate_dataset` over 20 synthetic windows at B = 16, the evaluator's
   rows path, `RolloutEngine(decode="full")`, the evaluate and generate
   CLIs on a reference-layout checkpoint, and the qk_norm evaluator at 8
   layers: exact launch counts, each against the plain path (see
   `check_evaluation`), `gen_time` (the reference's s/frame), policies
   per second and the evaluator's device time by kernel.
   Inside it, the MAGVIT2 tokenizer's inference path (`check_tokenizer`)
   at `VQConfig()` (256 px, base 128, ch_mult (1, 1, 2, 2, 4), z 18, bf16;
   seeded random weights): `save_tokenizer` / `load_tokenizer` bitwise; the
   card's fp32 path with TF32 off against the CPU's on 2 frames (latents
   and decoded images within 1e-4 relative L2); at 16 synthetic frames the
   bf16 path against the fp32 oracle (latents and decoded images within
   3e-2 relative L2, LFQ bits equal where |z32| > 0.05 rms and on 99% of
   all, decode_tokens(ids) == decode(quantized) in each dtype); encode and
   decode ms a frame (events and device time), TFLOP/s, the decode's peak
   memory, LPIPS (alex) pairs a second with TF32 off and on; the tokenize
   CLI on two segments of 24 frames (ids equal to `encode_frames`', vocab
   2^18, the segments; no kernel launched); the evaluate CLI with
   `--tokenizer_ckpt` and `--lpips_ckpt random` on those windows (exact
   launches of one evaluator batch, `dec_time` and `pred_lpips`, the latter
   within 1e-4 relative of the CPU's fp32 LPIPS on its saved frames);
   `evaluate_dataset` with decode and LPIPS over a batch of 16 windows (its
   wall, gen_time, dec_time, busy share); `decode_latents_wrapper` over the
   generate CLI's video.bin equal to `decode_tokens` + `rescale_magvit_output`.
10. The training runtime (`check_training_runtime`), in a temporary
   directory it removes: the train CLI (`tpu1x_torch.train.train.main`) on
   configs/genie_138m.json at full depth over a synthetic dataset
   (`--overfit_first_batch`, B=8, accumulation 2, 6 updates, a checkpoint
   and an eval at 3, visualize at 6 with `--tokenizer_ckpt` and
   `--lpips_ckpt random`) with exact launch counts per micro-batch, eval
   and visualize call, a falling loss, metrics.jsonl and vis_step_6 read
   back (its decoded `pred_vs_gtruth` figure, (4 x 2 x 256, 8 x 256, 3),
   and the printed train-time lpips), its s/update beside the bare step's
   and the busy share over two updates; `Checkpointer.restore` of step_3 bit for
   bit and a resumed run to step 6 whose update from step 3 is within 2e-2
   relative L2 of the uninterrupted run's; both exports of
   final_checkpt_hf read back bit for bit, and the evaluate CLI on them;
   one process group of world size 1 over NCCL, one update through DDP
   and one through FSDP2 against the unwrapped step, and an FSDP2
   checkpoint round trip; remat (qk_norm off / "attn_outs" / "none",
   pre-LN off / "attn_outs") with launch counts, peak memory, step time
   and gradients against remat off; dropout at 8 layers through the
   kernels and the plain path with one seed.
11. Prints the `kernels` JSON line (with each kernel's `eval_launches`,
   `evaluate_cli_decoded` among them, and `train_cli_launches`), the card
   line, and last the result line.

K1 (both modes), K2, K3, K5, K9, K10 and K13 carry a profiler device time
(`device_ms`; their library calls `library_device_ms`) beside the event
time, as K7 and K8 do.

Any failure exits non-zero without the result line, as does a run without a
CUDA device or outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from tpu1x_torch import kernels
from tpu1x_torch.data.corruption import draw_noise, maskgit_corrupt
from tpu1x_torch.data.token_store import RawTokenDataset, write_token_dataset
from tpu1x_torch.eval import evaluate as ev_cli
from tpu1x_torch.eval import generate as gen_cli
from tpu1x_torch.eval.evaluate import (GenieEvaluator, eval_all_frames,
                                       evaluate_dataset, frame_metrics)
from tpu1x_torch.model_zoo import genie_138m
from tpu1x_torch.models.sampler import generate_cached_fused, maskgit_generate
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.models.st_transformer import STBlock
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import attention as attn
from tpu1x_torch.ops import decode_attention as da
from tpu1x_torch.ops import mlp_train_block as mtb
from tpu1x_torch.ops import spatial_block as sb
from tpu1x_torch.ops import spatial_train_block as stb
from tpu1x_torch.ops import temporal_attention as ta
from tpu1x_torch.ops import temporal_train_block as ttb
from tpu1x_torch.ops.layernorm import layer_norm, layer_norm_plain
from tpu1x_torch.ops.spatial_block import spatial_block, spatial_block_plain
from tpu1x_torch.ops.temporal_attention import (temporal_attention,
                                                temporal_attention_plain)
from tpu1x_torch.ops.temporal_mlp_block import (
    plain_on_cache, temporal_mlp_block, temporal_mlp_block_pair,
    temporal_mlp_block_pair_plain, temporal_mlp_block_plain)
from tpu1x_torch.rollout.engine import RolloutEngine
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params
from tpu1x_torch.config import GenieConfig, VQConfig
from tpu1x_torch.eval.metrics import make_lpips_fn
from tpu1x_torch.eval.visualize import decode_latents_wrapper
from tpu1x_torch.parallel.mesh import init_distributed
from tpu1x_torch.parallel.sharding import full_state_dict
from tpu1x_torch.train import train as train_cli
from tpu1x_torch.train.checkpoint import (Checkpointer, _state_tensors,
                                          load_pretrained,
                                          load_torch_checkpoint)
from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.step import (TrainState, make_train_step,
                                    shard_train_state)
from tpu1x_torch.tokenizer import tokenize as tok_cli
from tpu1x_torch.tokenizer.checkpoint import load_tokenizer, save_tokenizer
from tpu1x_torch.tokenizer.lpips import LPIPS
from tpu1x_torch.tokenizer.tokenize import encode_frames
from tpu1x_torch.tokenizer.vqmodel import VQModel, rescale_magvit_output
from tpu1x_torch.utils.profiling import H100_PEAKS

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_TENSOR = H100_PEAKS["sxm"]["bfloat16"]
PEAK_FP32 = H100_PEAKS["sxm"]["float32"]
PEAK_BYTES = 3.35e12

B, P, NEW, STEPS = 16, 8, 8, 2
# the training phase; at random init the gradient norm is above 1000, and
# a learning rate of 1e-4 overshoots in the first steps
TB, TRAIN_STEPS, TRAIN_LR = 8, 10, 1e-5
CB = 2  # batch of the whole-step comparison with the plain paths
SOURCES = {
    "spatial_block": ("tpu1x_torch/csrc/spatial_block.cu",
                      "tpu1x/ops/spatial_block.py:150"),
    "temporal_mlp_block": ("tpu1x_torch/csrc/temporal_mlp_block.cu",
                           "tpu1x/ops/temporal_mlp_block.py:284"),
    "temporal_mlp_block_pair": ("tpu1x_torch/csrc/temporal_mlp_block.cu",
                                "tpu1x/ops/temporal_mlp_block.py:311"),
    "temporal_attention": ("tpu1x_torch/csrc/temporal_attention.cu",
                           "tpu1x/ops/temporal_attention.py:130"),
    "layer_norm": ("tpu1x_torch/csrc/layer_norm.cu",
                   "tpu1x/ops/layernorm.py:45"),
    "temporal_attention_bwd": ("tpu1x_torch/csrc/temporal_attention.cu",
                               "tpu1x/ops/temporal_attention.py:154"),
    "spatial_train_block_bwd": ("tpu1x_torch/csrc/train_block.cu",
                                "tpu1x/ops/spatial_train_block.py:256"),
    "temporal_train_block": ("tpu1x_torch/csrc/train_block.cu",
                             "tpu1x/ops/temporal_train_block.py:213"),
    "temporal_train_block_bwd": ("tpu1x_torch/csrc/train_block.cu",
                                 "tpu1x/ops/temporal_train_block.py:254"),
    "mlp_train_block": ("tpu1x_torch/csrc/train_block.cu",
                        "tpu1x/ops/mlp_train_block.py:219"),
    "mlp_train_block_bwd": ("tpu1x_torch/csrc/train_block.cu",
                            "tpu1x/ops/mlp_train_block.py:260"),
    "temporal_decode_attention": ("tpu1x_torch/csrc/decode_attention.cu",
                                  "tpu1x/ops/decode_attention.py:349"),
    "temporal_decode2_attention": ("tpu1x_torch/csrc/decode_attention.cu",
                                   "tpu1x/ops/decode_attention.py:282"),
    "flash_mha": ("tpu1x_torch/csrc/flash_attention.cu",
                  "tpu1x/ops/pallas_attention.py:65"),
    "flash_mha_bwd": ("tpu1x_torch/csrc/flash_attention.cu",
                      "tpu1x/ops/pallas_attention.py:132"),
}
# launches per layer in one rollout: the prefill, 9 single-frame decodes
# (2 steps of the first new frame, then step 1 of the other 7), 7 pairs
PER_LAYER = {"spatial_block": 1 + 9 + 7, "temporal_mlp_block": 9,
             "temporal_mlp_block_pair": 7, "temporal_attention": 1,
             "layer_norm": 1}
# the same rollout op by op (qk_norm, or the int8 cache): the decode
# attention kernels take the temporal+MLP block's place; without qk_norm
# the prefill keeps its temporal attention and LN2, and each of the 16
# decodes launches LN2 as well
PER_LAYER_QK = {"spatial_block": 1 + 9 + 7, "temporal_decode_attention": 9,
                "temporal_decode2_attention": 7}
PER_LAYER_INT8 = dict(PER_LAYER_QK, temporal_attention=1, layer_norm=1 + 16)
# launches per layer in one train step; the temporal train block launches
# the temporal attention forward in its forward and the backward in its
# backward, which writes the attention output (for dWproj) beside the
# gradients; the spatial train block's backward launches the fused
# attention forward (recompute) and backward once each
TRAIN_PER_LAYER = {"spatial_block": 1, "spatial_train_block_bwd": 1,
                   "temporal_train_block": 1, "temporal_train_block_bwd": 1,
                   "mlp_train_block": 1, "mlp_train_block_bwd": 1,
                   "temporal_attention": 1, "temporal_attention_bwd": 1,
                   "flash_mha": 1, "flash_mha_bwd": 1}
# under qk_norm: the fused attention pair on the spatial axis, the MLP train
# block without LN; the rest is plain torch under autograd
TRAIN_PER_LAYER_QK = {"flash_mha": 1, "flash_mha_bwd": 1,
                      "mlp_train_block": 1, "mlp_train_block_bwd": 1}
# the evaluation phase. One `compute_logits` under no_grad (a policy score,
# a MaskGIT step of the rows path or of decode="full"): the train blocks'
# forwards, the temporal one launching K4
LOGITS_PER_LAYER = {"spatial_block": 1, "temporal_train_block": 1,
                    "temporal_attention": 1, "mlp_train_block": 1}
# one evaluator batch: the prefill of all T = 16 frames, then 2 MaskGIT
# steps of each of the 15 frame tasks; op by op under qk_norm (the prefill's
# temporal attention plain, no LN2)
EVAL_PER_LAYER = {"spatial_block": 1 + 30, "temporal_mlp_block": 30,
                  "temporal_attention": 1, "layer_norm": 1}
EVAL_PER_LAYER_QK = {"spatial_block": 1 + 30, "temporal_decode_attention": 30}
NP, CTX = 16, 8  # policies scored, frames of their shared context
WINDOWS = 20  # evaluator windows: a batch of B and a tail of 4, padded


def expected_launches(per_layer, layers):
    return {k: per_layer.get(k, 0) * layers for k in kernels.LAUNCHES}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, windows: int = 3):
    """Device time of one call of `fn`, from torch.profiler: its kernels
    alone, the median over `windows` profiler windows. `time_ms` includes
    the wrapper's host time, which is the longer of the two for the
    smallest kernels. The profiler now and then reports no device time for
    a window, or only part of it (once a quarter of K10's, below its
    event time): a window with none is dropped, and the median outvotes a
    short one. None if every window came back empty (no number rather
    than a wrong one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(a.self_device_time_total for a in prof.key_averages()
                    if a.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            got.append(total / 1e3 / iters)
    # a lost event only shortens a window: of two, the longer
    return sorted(got)[len(got) // 2] if got else None


def tflops(flops: float, ms):
    """The rate in TFLOP/s of `flops` in `ms`, or None without a time."""
    return flops / ms / 1e9 if ms else None


def bound(nbytes: float, tensor_flops: float = 0.0, fp32_flops: float = 0.0):
    """The least time in ms, and what sets it: bytes over the memory rate,
    or operations. Products of bf16 operands (fp32 accumulation included)
    count at the tensor cores' rate, other fp32 arithmetic at the fp32
    units' rate; the two units run side by side, so the larger counts."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tensor_flops / PEAK_BF16_TENSOR, fp32_flops / PEAK_FP32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, atol, rtol):
    """Max abs error of got vs want; raises if any element is outside
    atol + rtol * |want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"atol {atol} rtol {rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def held_to_plain(name, got, want, want32, tol):
    """K2's and K3's outputs against the plain bf16 path (`want`) and an
    fp32 run of the plain version (`want32`): elementwise (atol = rtol =
    `tol`) where the two bf16 paths agree, which must be all but 1e-4 of
    the elements; and as a whole by relative L2, at most 3e-2 from the
    plain path and no farther from the fp32 run than the plain path is
    (1.25x + 1e-3), as the prefill is held. Two bf16 paths that round in
    another order part by more than the elementwise gate on a rare element
    (a residual that the MLP cancels): the plain path is as far from fp32
    there as the kernel (`chip_variants.py k2gate`)."""
    g, w, w32 = got.float(), want.float(), want32.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    apart = int((err > tol + tol * w.abs()).sum())
    out = {"max_abs_err": float(err.max()), "apart": apart,
           "elements": g.numel(), "kernel_vs_plain": rel_l2(g, w),
           "kernel_vs_fp32": rel_l2(g, w32), "plain_vs_fp32": rel_l2(w, w32)}
    if not (apart <= 1e-4 * g.numel() and out["kernel_vs_plain"] <= 3e-2
            and out["kernel_vs_fp32"] <= 1.25 * out["plain_vs_fp32"] + 1e-3):
        raise AssertionError(f"{name} against the plain path: {out}")
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


class Inputs:
    def __init__(self, seed: int, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def normal(self, *shape, std=1.0, dtype=torch.bfloat16, mean=0.0):
        t = torch.randn(*shape, generator=self.g, device=self.device)
        return (t * std + mean).to(dtype)


def check_layer_norm(inp, C):
    x = inp.normal(B, P, 256, C, std=1.0, mean=0.3)
    g = inp.normal(C, std=0.1, mean=1.0, dtype=torch.float32)
    b = inp.normal(C, std=0.1, dtype=torch.float32)
    err = compare("layer_norm", layer_norm(x, g, b), layer_norm_plain(x, g, b),
                  3e-2, 3e-2)
    gb, bb = g.to(x.dtype), b.to(x.dtype)
    rows = x.numel() // C
    bms, by = bound(nbytes(x, x, g, b), fp32_flops=7 * rows * C)

    def kernel():
        return layer_norm(x, g, b)

    def library():
        return F.layer_norm(x, (C,), gb, bb)
    return dict(max_abs_err=err, shape=list(x.shape), bound_ms=bms,
                bound_by=by, ms=time_ms(kernel), device_ms=device_ms(kernel),
                plain_ms=time_ms(lambda: layer_norm_plain(x, g, b)),
                library_ms=time_ms(library),
                library_device_ms=device_ms(library))


def temporal_bound(Bt, T, S, C, tensors, pairs, products):
    """The bound of K4 (4 tensors, 2 products) or K6 (7 tensors, 8 with o;
    5 products, 6 with o) at (Bt, T, S, C): bf16 tensors moved once, and
    products of 2 head_dim FLOP a (query, key) pair and channel group."""
    return bound(tensors * Bt * T * S * C * 2,
                 tensor_flops=2 * products * Bt * S * C * pairs)


def check_temporal_attention(inp, C, H, eval_shapes=False):
    """K4 on the thirds of one qkv tensor against its plain version: at the
    rollout prefill's (B, P, 256, C), causal (the entry this script reports
    for K4) and not (keys past T = 8 padded, masked in the kernel), at the
    pre-LN train step's (TB, 16, 256, C), causal and not (at C = 256, 8
    heads, the rollout prefill's two); with `eval_shapes` instead at the
    evaluator prefill's (B, 16, 256, C), causal, on the thirds and on three
    separate tensors; each with its event and device times, the bound, the
    plain version's and SDPA's."""
    out = {}
    cases = [("", B, P, True), ("[non-causal]", B, P, False),
             ("[train]", TB, 16, True), ("[train,non-causal]", TB, 16, False)]
    if C != 512:
        cases = [(f"[C={C}]", B, P, True), (f"[C={C},non-causal]", B, P, False)]
    if eval_shapes:
        cases = [("[eval prefill]", B, 16, True),
                 ("[eval prefill,separate]", B, 16, True)]
    scale = (C // H) ** -0.5
    for tag, Bt, T, causal in cases:
        qkv = inp.normal(Bt, T, 256, 3 * C)
        q, k, v = qkv.split(C, dim=-1)  # strided views, as both callers
        if "separate" in tag:  # three tensors of their own
            q, k, v = (x.contiguous() for x in (q, k, v))
        kw = dict(scale=scale, num_heads=H, causal=causal)
        err = compare("temporal_attention" + tag,
                      temporal_attention(q, k, v, **kw),
                      temporal_attention_plain(q, k, v, **kw), 3e-2, 3e-2)
        D = C // H

        def heads(t):  # (B, T, S, C) -> (B, S, H, T, D) view
            return t.reshape(Bt, T, 256, H, D).permute(0, 2, 3, 1, 4)
        qh, kh, vh = heads(q), heads(k), heads(v)
        pairs = T * (T + 1) // 2 if causal else T * T
        # q.k and, with probabilities rounded to bf16, p.v
        bms, by = temporal_bound(Bt, T, 256, C, 4, pairs, 2)

        def kernel():
            return ta.launch_forward(q, k, v, **kw)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal,
                                                  scale=scale)
        # the event time through the entry a caller uses, the device time
        # of the launch alone
        out["temporal_attention" + tag] = dict(
            max_abs_err=err, shape=list(q.shape), causal=causal,
            bound_ms=bms, bound_by=by,
            ms=time_ms(lambda: temporal_attention(q, k, v, **kw)),
            device_ms=device_ms(kernel),
            plain_ms=time_ms(lambda: temporal_attention_plain(q, k, v, **kw)),
            library_ms=time_ms(library), library_device_ms=device_ms(library))
    return out


def spatial_weights(inp, C):
    return dict(wqkv=inp.normal(C, 3 * C, std=0.05),
                wproj=inp.normal(C, C, std=0.05),
                bproj=inp.normal(C, std=0.1),
                ln_scale=inp.normal(C, std=0.1, mean=1.0, dtype=torch.float32),
                ln_bias=inp.normal(C, std=0.1, dtype=torch.float32))


def check_spatial_block(inp, C, H, N, qk_ln=False):
    w = spatial_weights(inp, C)
    if qk_ln:  # the qk_norm models: no pre-LN, one LN over head_dim
        w.update(ln_scale=None, ln_bias=None,
                 qk_ln_scale=inp.normal(C // H, std=0.1, mean=1.0,
                                        dtype=torch.float32),
                 qk_ln_bias=inp.normal(C // H, std=0.1, dtype=torch.float32))
    x = inp.normal(N, 256, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5, **w)
    err = compare(f"spatial_block N={N} qk_ln={qk_ln}", spatial_block(x, **kw),
                  spatial_block_plain(x, **kw), 3e-2, 3e-2)
    S = 256
    bms, by = bound(nbytes(x, x, *w.values()),
                    tensor_flops=2 * N * S * C * (4 * C + 2 * S))
    return dict(max_abs_err=err, shape=list(x.shape), bound_ms=bms,
                bound_by=by, ms=time_ms(lambda: spatial_block(x, **kw)),
                device_ms=device_ms(lambda: spatial_block(x, **kw)),
                plain_ms=time_ms(lambda: spatial_block_plain(x, **kw)),
                library_ms=None)


def block_weights(inp, C):
    F4 = 4 * C
    return dict(wqkv=inp.normal(C, 3 * C, std=0.05),
                wproj=inp.normal(C, C, std=0.05),
                bproj=inp.normal(C, std=0.1),
                ln_scale=inp.normal(C, std=0.1, mean=1.0, dtype=torch.float32),
                ln_bias=inp.normal(C, std=0.1, dtype=torch.float32),
                wfc1=inp.normal(C, F4, std=0.05), bfc1=inp.normal(F4, std=0.1),
                wfc2=inp.normal(F4, C, std=0.05), bfc2=inp.normal(C, std=0.1))


def check_temporal_mlp_block(inp, C, H, L, caches, pair, gelu_tanh=True,
                             timed=True, first=P):
    """K2 (one frame) or K3 (the pair) against its plain version at C
    channels and H heads, with the tanh or the exact-erf GELU (the two
    instantiations of the GEMM's GELU epilogue), t_B mixed from `first` to
    the last slot (P: the rollout's; 1: the evaluator's, which decodes
    against a cache whose every slot holds a frame, the slots at or past t_B
    included, and must read none of those); with `timed`, its event and
    device time, its plain version's and its bound."""
    kc, vc = caches
    T = kc.shape[0]
    w = block_weights(inp, C)
    frames = 2 if pair else 1
    x = inp.normal(B, frames, 256, C) if pair else inp.normal(B, 256, C)
    # a different frame index per row, and a layer other than 0
    t_B = (first + torch.arange(B, device=x.device)
           % (T - first - frames + 1)).to(torch.int32)
    layer = L // 2
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, gelu_tanh=gelu_tanh, **w)
    name = "temporal_mlp_block_pair" if pair else "temporal_mlp_block"
    name += f"[C={C},{'tanh' if gelu_tanh else 'erf'}]"
    kernel = temporal_mlp_block_pair if pair else temporal_mlp_block
    plain = temporal_mlp_block_pair_plain if pair else temporal_mlp_block_plain
    got = kernel(x, kc, vc, t_B, layer=layer, **kw)
    want = plain(x, kc[:, layer], vc[:, layer], t_B, **kw)
    f32 = {k: v.float() if torch.is_tensor(v) else v for k, v in kw.items()}
    y32 = plain(x.float(), kc[:, layer].float(), vc[:, layer].float(), t_B,
                **f32)
    held = {part: held_to_plain(f"{name} {part}", got[i], want[i], y32[i],
                                tol)
            for i, part, tol in ((0, "out", 3e-2), (1, "k", 2e-2),
                                 (2, "v", 2e-2))}
    err = held["out"]["max_abs_err"]
    # the decode engine's forms: k/v written into one layer of a (L, B, S,
    # C) stack, or not kept; the same bits as above
    kv = (torch.zeros(2, B, 256, C, dtype=x.dtype, device=x.device),
          torch.zeros(2, B, 256, C, dtype=x.dtype, device=x.device))
    into = kernel(x, kc, vc, t_B, layer=layer, kv_out=(kv[0][1], kv[1][1]),
                  **kw)
    dropped = kernel(x, kc, vc, t_B, layer=layer, return_kv=False, **kw)
    if not (torch.equal(into[0], got[0]) and torch.equal(kv[0][1], got[1])
            and torch.equal(kv[1][1], got[2]) and kv[0][0].eq(0).all()
            and torch.equal(dropped[0], got[0]) and dropped[1] is None):
        raise AssertionError(f"{name}: kv_out / return_kv change the output")
    if not timed:
        return dict(max_abs_err=err, shape=list(x.shape), held=held)
    S = 256
    slots = int(t_B.sum())  # this run's data: slots t < t_B[b] per row
    cache_bytes = 2 * slots * S * C * 2
    io = nbytes(x, x, t_B, *w.values()) + 2 * B * S * C * 2
    flops = 2 * frames * B * S * C * 12 * C  # the four weight products
    # q.k of bf16 operands for every logit; p.v with fp32 probabilities
    logit_macs = B * S * C * (frames * slots / B + frames * (frames + 1) / 2)
    bms, by = bound(cache_bytes + io, tensor_flops=flops + 2 * logit_macs,
                    fp32_flops=2 * logit_macs)

    def run():
        return kernel(x, kc, vc, t_B, layer=layer, **kw)
    return dict(max_abs_err=err, shape=list(x.shape), t_B=t_B.tolist(),
                layer=layer, held=held, bound_ms=bms, bound_by=by,
                ms=time_ms(run),
                device_ms=device_ms(run),
                plain_ms=time_ms(lambda: plain(x, kc[:, layer], vc[:, layer],
                                               t_B, **kw), iters=5),
                library_ms=None)


def quantize_cache(kc):
    """(T, L, B, S, C) bf16 -> (int8 cache, (L, B, T, S) fp32 scales), a
    layer at a time."""
    q = torch.empty_like(kc, dtype=torch.int8)
    T, L, Bc, S, _ = kc.shape
    scale = torch.empty(L, Bc, T, S, dtype=torch.float32, device=kc.device)
    for layer in range(L):
        q[:, layer], sc = da.quantize_kv(kc[:, layer])  # (T, B, S)
        scale[layer] = sc.transpose(0, 1)
    return q, scale


def check_decode_attention(inp, C, H, L, caches, scales, pair):
    """K7 (one frame) or K8 (the pair) against the plain version, on column
    views of one qkv product, at two layers, t_B mixed in 0..15 (0: no cache
    slot is valid); then timed, and held, also at the pre-LN rollout's t_B
    (one frame 8..15, the pair 8..14) on the thirds of one (B, frames, S,
    3C) qkv tensor, as K2 and K3 launch it (`rollout`). `scales`: None for
    the bf16 cache."""
    from chip_variants import decode_bound
    kc, vc = caches
    T, S = kc.shape[0], 256
    frames = 2 if pair else 1
    qkv = inp.normal(frames * B, S, 3 * C)
    q, k, v = qkv.split(C, dim=-1)
    t_B = (torch.arange(B, device=qkv.device) * 7 % (T - frames + 1)).to(
        torch.int32)
    kw = dict(scale=(C // H) ** -0.5, num_heads=H)
    if scales is not None:
        kw.update(k_scale=scales[0], v_scale=scales[1])
    name = ("temporal_decode2_attention" if pair
            else "temporal_decode_attention")
    name += "[int8]" if scales is not None else ""
    if pair:
        args = (q[:B], q[B:], kc, vc, k[:B], v[:B], k[B:], v[B:], t_B)
        kernel, plain = (da.temporal_decode2_attention,
                         da.temporal_decode2_attention_plain)
    else:
        args = (q, kc, vc, k, v, t_B)
        kernel, plain = (da.temporal_decode_attention,
                         da.temporal_decode_attention_plain)
    err = 0.0
    for layer in (L // 2, L - 1):
        got, want = kernel(*args, layer=layer, **kw), plain(*args, layer=layer,
                                                            **kw)
        if not pair:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            err = max(err, compare(f"{name} layer {layer}", g, w, 3e-2, 3e-2))
    layer = L // 2
    # the engine's forms: the output into halves of one tensor, k/v copied
    # into a layer of a stack; the same bits
    out = torch.zeros(frames * B, S, C, dtype=qkv.dtype, device=qkv.device)
    kv = torch.zeros(2, B, S, C, dtype=qkv.dtype, device=qkv.device)
    into = kernel(*args, layer=layer, kv_out=(kv[0], kv[1]),
                  out=(out[:B], out[B:]) if pair else out, **kw)
    ref = kernel(*args, layer=layer, **kw)
    same = (torch.equal(out, torch.cat(ref) if pair else ref)
            and torch.equal(kv[0], k[:B]) and torch.equal(kv[1], v[:B])
            and (into[0] if pair else into).data_ptr() == out.data_ptr())
    if not same:
        raise AssertionError(f"{name}: out / kv_out change the result")
    bms, by = decode_bound(t_B, S, C, frames, kc, scales)
    # the rollout's t_B, in K2's and K3's layout
    t_roll = (P + torch.arange(B, device=qkv.device)
              % (T - P - frames + 1)).to(torch.int32)
    qr, kr, vr = (x.unbind(1) for x in inp.normal(
        B, frames, S, 3 * C).split(C, dim=-1))
    roll = ((qr[0], qr[1], kc, vc, kr[0], vr[0], kr[1], vr[1], t_roll)
            if pair else (qr[0], kc, vc, kr[0], vr[0], t_roll))
    got, want = kernel(*roll, layer=layer, **kw), plain(*roll, layer=layer,
                                                        **kw)
    roll_err = max(compare(f"{name} rollout t_B", g, w, 3e-2, 3e-2)
                   for g, w in zip(*((got, want) if pair
                                     else ((got,), (want,)))))
    roll_bms, roll_by = decode_bound(t_roll, S, C, frames, kc, scales)
    return {name: dict(
        max_abs_err=err, shape=list(qkv.shape), t_B=t_B.tolist(),
        bound_ms=bms, bound_by=by,
        ms=time_ms(lambda: kernel(*args, layer=layer, **kw)),
        device_ms=device_ms(lambda: kernel(*args, layer=layer, **kw)),
        plain_ms=time_ms(lambda: plain(*args, layer=layer, **kw), iters=5),
        library_ms=None,
        rollout=dict(max_abs_err=roll_err, t_B=t_roll.tolist(),
                     bound_ms=roll_bms, bound_by=roll_by,
                     device_ms=device_ms(
                         lambda: kernel(*roll, layer=layer, **kw))))}


def check_flash_mha(inp, H):
    """K9 and K10 at the qk_norm train step's shape (128, 256, 16, 32),
    q, k, v as thirds of one qkv product, against `mha_reference` and its
    autograd; K9's lse against `mha_lse_reference` (atol 1e-2: the kernel
    sums the bf16-rounded p); K10 also against `flash_mha_bwd_plain` on the
    kernel forward's residuals, by the gradient gates, into new tensors and
    into the thirds of one (R, N, 3C) tensor (which must equal the former
    exactly, as the spatial train block's backward calls it). SDPA forward and
    backward are timed beside them, by events and by the profiler's device
    time. K9 and K10 are also held so at N = 64, 128 and 192 (4 rows),
    their other token counts, and at a negative scale. K10's bound is the TPU
    kernel's work (q, k, v, d_o read and dq, dk, dv written once, 7
    tensors), as in the rows before; `own_floor_ms` adds the residuals o
    and lse that this design reads."""
    R, N, D = TB * 16, 256, 32
    t = dict(qkv=inp.normal(R, N, 3, H, D))
    dout = inp.normal(R, N, H, D)
    scale = D ** -0.5
    out = {}
    for causal in (False, True):
        tag = "[causal]" if causal else ""
        kw = dict(scale=scale, causal=causal)
        # the forward and the backward at the kernel's other token counts
        # (the backward's key tiles split unevenly between its warpgroups,
        # or leave one idle at N = 64), and with a negative scale (the
        # forward's row max is the min of the raw logits), on 4 rows
        other_n, other_n_grads = {}, {}
        for n, sc in ((64, scale), (128, scale), (192, scale), (128, -scale)):
            q, k, v = t["qkv"][:4, :n].unbind(-3)
            g = dout[:4, :n]
            key = f"N={n}, scale={sc:.4f}"
            (o, lse), (wo, wl) = (
                f(q, k, v, scale=sc, causal=causal)
                for f in (attn.flash_mha_fwd, attn.mha_lse_reference))
            other_n[key] = compare(f"flash_mha{tag} {key}", o, wo, 3e-2, 3e-2)
            compare(f"flash_mha{tag} {key} lse", lse, wl, 1e-2, 0.0)
            errs = {
                f"d{c} (residuals)": grad_errors(
                    f"flash_mha_bwd{tag} {key} d{c} (residuals)", got, want)
                for c, got, want in zip(
                    "qkv",
                    attn.flash_mha_bwd(q, k, v, o, lse, g, scale=sc,
                                       causal=causal),
                    attn.flash_mha_bwd_plain(q, k, v, o, lse, g, scale=sc,
                                             causal=causal))}
            _, grads = both_paths(
                f"flash_mha{tag} {key}",
                lambda qkv: attn.flash_mha(*qkv.unbind(-3), scale=sc,
                                           causal=causal),
                lambda qkv: attn.mha_reference(*qkv.unbind(-3), scale=sc,
                                               causal=causal),
                dict(qkv=t["qkv"][:4, :n]), g)
            other_n_grads[key] = dict(errs, dqkv=grads["qkv"])

        def kernel(qkv):
            return attn.flash_mha(*qkv.unbind(-3), **kw)

        def plain(qkv):
            return attn.mha_reference(*qkv.unbind(-3), **kw)

        out_err, grads = both_paths("flash_mha" + tag, kernel, plain, t, dout)
        q, k, v = t["qkv"].unbind(-3)
        o, lse = attn.flash_mha_fwd(q, k, v, **kw)
        lse_err = compare(f"flash_mha{tag} lse", lse,
                          attn.mha_lse_reference(q, k, v, **kw)[1], 1e-2, 0.0)
        contiguous = attn.flash_mha_bwd(q, k, v, o, lse, dout, **kw)
        want = attn.flash_mha_bwd_plain(q, k, v, o, lse, dout, **kw)
        residual_grads = {
            f"d{n}": grad_errors(f"flash_mha_bwd{tag} d{n} (residuals)", g, w)
            for n, g, w in zip("qkv", contiguous, want)}
        # K10 writing dq, dk, dv into the thirds of one (R, N, 3C) tensor,
        # as the spatial train block's backward calls it: the contiguous
        # call's values exactly, and nothing written outside them
        dqkv = torch.full((R, N, 3 * H * D), float("nan"), dtype=dout.dtype,
                          device=dout.device)
        thirds = dqkv.view(R, N, 3, H, D).unbind(2)
        attn.flash_mha_bwd(q, k, v, o, lse, dout, out=thirds, **kw)
        if not torch.equal(dqkv.view(R, N, 3, H, D),
                           torch.stack(contiguous, 2)):
            raise AssertionError(f"flash_mha_bwd{tag} into the thirds of "
                                 f"dqkv differs from the contiguous call")
        residual_grads.update({
            f"d{n} (qkv thirds)": grad_errors(
                f"flash_mha_bwd{tag} d{n} (qkv thirds)", g, w)
            for n, g, w in zip("qkv", thirds, want)})
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))  # (R, H, N, D) views

        def sdpa():
            return F.scaled_dot_product_attention(lq, lk, lv,
                                                  is_causal=causal,
                                                  scale=scale)
        lib_out = sdpa()
        pairs = N * (N + 1) // 2 if causal else N * N
        io = R * N * H * D * 2
        fwd = bound(4 * io + nbytes(lse), tensor_flops=4 * R * H * pairs * D)
        # logits, dv, dp, dq, dk: five products of 2 D per (query, key)
        flops = 10 * R * H * pairs * D
        bwd = bound(7 * io, tensor_flops=flops)
        own_floor = bound(8 * io + nbytes(lse), tensor_flops=flops)

        def fwd_kernel():
            return attn.flash_mha_fwd(q, k, v, **kw)

        def bwd_kernel():
            return attn.flash_mha_bwd(q, k, v, o, lse, dout, **kw)

        def bwd_library():
            return torch.autograd.grad(lib_out, (lq, lk, lv),
                                       dout.transpose(1, 2), retain_graph=True)
        with torch.no_grad():
            fwd_ms = time_ms(fwd_kernel)
            lib_fwd = time_ms(sdpa)
            fwd_dev, lib_fwd_dev = device_ms(fwd_kernel), device_ms(sdpa)
        out["flash_mha" + tag] = entry(
            out_err, {}, q.shape, fwd_ms, plain_ms(plain, t), fwd,
            library_ms=lib_fwd, device_ms=fwd_dev,
            library_device_ms=lib_fwd_dev, other_n_max_abs_err=other_n,
            lse_max_abs_err=lse_err)
        out["flash_mha_bwd" + tag] = entry(
            grads["qkv"]["max_abs_err"], dict(grads, **residual_grads),
            q.shape, time_ms(bwd_kernel), plain_ms(plain, t, dout), bwd,
            library_ms=time_ms(bwd_library), device_ms=device_ms(bwd_kernel),
            library_device_ms=device_ms(bwd_library),
            own_floor_ms=own_floor[0], other_n_grads=other_n_grads)
    return out


def check_gemm_sm90(inp, C):
    """The GEMM of csrc/gemm_sm90.cuh alone, against `gemm_sm90_plain` (the
    same rounding chain; atol = rtol = 3e-2), by device time beside
    torch.matmul of the same operands: K1's products at its row counts (N =
    16, 32, 128 frames of 256 tokens), qkv = a Wqkv + b (C -> 3C) and proj =
    a Wproj + b + x (C -> C); K2's and K3's MLP products at theirs (4096 and
    8192 rows), fc1 = GELU(a Wfc1 + b) (C -> 4C, tanh and exact erf) and
    fc2 = h Wfc2 + b + x (4C -> C)."""
    F4 = 4 * C
    cases = []
    for N in (B, 2 * B, B * P):
        M = N * 256
        a, x = inp.normal(M, C), inp.normal(M, C)
        cases += [("qkv", a, inp.normal(C, 3 * C, std=0.05),
                   inp.normal(3 * C, std=0.1), None, None),
                  ("proj", a, inp.normal(C, C, std=0.05),
                   inp.normal(C, std=0.1), x, None)]
    for M in (B * 256, 2 * B * 256):
        a, x, h = inp.normal(M, C), inp.normal(M, C), inp.normal(M, F4)
        w1, b1 = inp.normal(C, F4, std=0.05), inp.normal(F4, std=0.1)
        cases += [("fc1[tanh]", a, w1, b1, None, "tanh"),
                  ("fc1[erf]", a, w1, b1, None, "erf"),
                  ("fc2", h, inp.normal(F4, C, std=0.05),
                   inp.normal(C, std=0.1), x, None)]
    out = {}
    for name, a, w, bias, resid, act in cases:
        M, K = a.shape
        n_out = w.shape[1]
        err = compare(f"gemm_sm90 {name} rows={M}",
                      sb.gemm_sm90(a, w, bias, resid, act),
                      sb.gemm_sm90_plain(a, w, bias, resid, act), 3e-2, 3e-2)
        flops = 2 * M * K * n_out
        bms, by = bound(nbytes(a, w, bias, resid) + M * n_out * 2,
                        tensor_flops=flops)
        dev = device_ms(lambda: sb.gemm_sm90(a, w, bias, resid, act))
        out[f"{name}[rows={M}]"] = dict(
            max_abs_err=err, bound_ms=bms, bound_by=by, device_ms=dev,
            tflops=tflops(flops, dev),
            library_device_ms=device_ms(lambda: torch.matmul(a, w)))
    return out


def check_op_path_kernels(C, H, L, device):
    """The kernels of the op-by-op paths (qk_norm, int8 cache)."""
    inp = Inputs(2, device)
    out = {}
    for N in (B, 2 * B, B * P):
        out[f"spatial_block[qk_ln,N={N}]"] = check_spatial_block(
            inp, C, H, N, qk_ln=True)
    T = 16
    caches = (inp.normal(T, L, B, 256, C), inp.normal(T, L, B, 256, C))
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, caches, None, pair))
    (kq, ks), (vq, vs) = quantize_cache(caches[0]), quantize_cache(caches[1])
    del caches
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, (kq, vq), (ks, vs),
                                          pair))
    del kq, vq, ks, vs
    out.update(check_flash_mha(inp, H))
    out.update(check_mlp_train_block(inp, C, ln=False))
    torch.cuda.empty_cache()
    for name, r in out.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    return out


def check_kernels(C, H, L, device):
    inp = Inputs(0, device)
    out = {}
    out["layer_norm"] = check_layer_norm(inp, C)
    out.update(check_temporal_attention(inp, C, H))
    out.update(check_temporal_attention(inp, 256, 8))
    for N in (B, 2 * B, B * P):
        out[f"spatial_block[N={N}]"] = check_spatial_block(inp, C, H, N)
    # GENIE_35M's width, which the kernel takes too
    out[f"spatial_block[C=256,N={B}]"] = check_spatial_block(inp, 256, 8, B)
    out["gemm_sm90"] = check_gemm_sm90(inp, C)
    T = 16
    caches = (inp.normal(T, L, B, 256, C), inp.normal(T, L, B, 256, C))
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        out[name] = check_temporal_mlp_block(inp, C, H, L, caches, pair)
        out[name + "[erf]"] = check_temporal_mlp_block(
            inp, C, H, L, caches, pair, gelu_tanh=False, timed=False)
    del caches
    # GENIE_35M's width, 8 heads, both GELU forms, on a 4-layer cache
    caches = (inp.normal(T, 4, B, 256, 256), inp.normal(T, 4, B, 256, 256))
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        for approx in (True, False):
            out[f"{name}[C=256,{'tanh' if approx else 'erf'}]"] = (
                check_temporal_mlp_block(inp, 256, 8, 4, caches, pair,
                                         gelu_tanh=approx, timed=False))
    del caches
    for name, r in out.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    return out


def check_eval_kernels(C, H, L, device):
    """The kernels at the evaluator's shapes, on inputs of their own: K4
    through the serving wrapper at the prefill's (B, 16, 256, C), K1 at its
    B T = 256 frames, and K2 at t_B mixed 1..15 on a (16, L, B, 256, C)
    cache with every slot filled (the slots at or past t_B must not be
    read), by the gates of the other checks."""
    inp = Inputs(5, device)
    out = check_temporal_attention(inp, C, H, eval_shapes=True)
    out[f"spatial_block[N={B * 16}]"] = check_spatial_block(inp, C, H, B * 16)
    caches = (inp.normal(16, L, B, 256, C), inp.normal(16, L, B, 256, C))
    out["temporal_mlp_block[eval t_B]"] = check_temporal_mlp_block(
        inp, C, H, L, caches, False, first=1)
    del caches
    for name, r in out.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    return out


class PlainDecodeEngine(DecodeEngine):
    """`DecodeEngine` with every op's plain version, on any device: the
    oracle that this script holds the kernel path against. The port itself
    has no way to the plain versions on the card."""

    _ops = SimpleNamespace(
        spatial_block=spatial_block_plain,
        temporal_attention=temporal_attention_plain,
        layer_norm=layer_norm_plain,
        temporal_mlp_block=functools.partial(plain_on_cache,
                                             temporal_mlp_block_plain),
        temporal_mlp_block_pair=functools.partial(
            plain_on_cache, temporal_mlp_block_pair_plain),
        temporal_decode_attention=da.temporal_decode_attention_plain,
        temporal_decode2_attention=da.temporal_decode2_attention_plain,
    )


def plain_rollout(cfg, engine, params, prompt, generator, actions=None):
    """What `RolloutEngine.rollout` does, through `engine`'s ops."""
    tokens, _ = generate_cached_fused(
        functools.partial(engine.prefill, params),
        functools.partial(engine.decode_frame, params, return_kv=False),
        functools.partial(engine.decode_frame_pair, params),
        prompt.reshape(B, -1), NEW, generator, cfg, maskgit_steps=STEPS,
        temperature=0.0, actions_BT=actions)
    return tokens.reshape(B, 1, P + NEW, *prompt.shape[2:])


def check_rollout(cfg, device, cache_dtype="bf16", per_layer=PER_LAYER,
                  full=True):
    """One configuration's rollout: counts, output, times, and the cache
    and logits against the plain path. `full` False (the combinations run
    at a cut depth) times one run and skips the profile. A configuration
    with an action vocabulary rolls out under seeded (B, P + NEW) actions."""
    g = torch.Generator(device=device).manual_seed(0)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    engine = RolloutEngine(model, cfg, device=device, maskgit_steps=STEPS,
                           temperature=0.0, cache_dtype=cache_dtype)
    plain = PlainDecodeEngine(cfg, device=device, cache_dtype=cache_dtype)
    side = cfg.latent_side_len
    prompt = torch.randint(0, cfg.image_vocab_size, (B, P, side, side),
                           generator=g, device=device)
    actions = (torch.randint(0, cfg.action_vocab_size, (B, P + NEW),
                             generator=g, device=device)
               if cfg.action_vocab_size > 0 else None)

    def seeded():
        return torch.Generator(device=device).manual_seed(1)

    def timed(rollout):
        t0 = time.perf_counter()
        out = rollout(seeded())
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def kernel_path(gen):
        return engine.rollout(prompt, NEW, gen, actions=actions)

    def plain_path(gen):
        return plain_rollout(cfg, plain, engine.params, prompt, gen, actions)

    kernel_path(seeded())  # first-call set-up, not timed
    torch.cuda.synchronize()
    kernels.reset_launches()
    out, wall = timed(kernel_path)
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(per_layer, cfg.num_layers)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    if tuple(out.shape) != (B, 1, P + NEW, side, side):
        raise AssertionError(f"rollout shape {tuple(out.shape)}")
    if not torch.equal(out[:, 0, :P], prompt):
        raise AssertionError("rollout changed the prompt frames")
    if int(out.min()) < 0 or int(out.max()) >= cfg.image_vocab_size:
        raise AssertionError("rollout tokens out of the vocabulary")

    walls = sorted([wall] + [timed(kernel_path)[1]
                             for _ in range(2 if full else 0)])
    wall = walls[len(walls) // 2]  # the median of three
    out_plain, wall_plain = timed(plain_path)
    agree = float((out[:, 0, P:] == out_plain[:, 0, P:]).float().mean())
    device_time = None
    if full:
        # every product of the rollout runs on csrc/gemm_sm90.cuh, and the
        # cache attention (inside K2 and K3, or K7 and K8) on the ring kernel
        device_time = profile_device(lambda: kernel_path(seeded()),
                                     must=("decode_ring_kernel",),
                                     must_not=("decode_attention_kernel",))

    return dict(launches=launches, rollout_s=wall, rollout_s_runs=walls,
                plain_rollout_s=wall_plain, s_per_frame=wall / NEW,
                s_per_frame_per_row=wall / (NEW * B), token_agreement=agree,
                layers=cfg.num_layers, qk_norm=cfg.qk_norm,
                cache_dtype=cache_dtype,
                action_vocab_size=cfg.action_vocab_size,
                device_time=device_time,
                **check_prefill_and_logits(model, cfg, prompt, engine, plain,
                                           actions))


# device kernels by kind, by what their names hold (first match wins)
KERNEL_KINDS = (("port", ("tpu1x::", "temporal_fwd_kernel",
                          "temporal_bwd_kernel")),
                ("convolution", ("fprop", "implicit_gemm", "cudnn", "conv",
                                 "nchwToNhwc", "nhwcToNchw")),
                ("gemm", ("gemm", "xmma", "cutlass", "nvjet")),
                ("reduction", ("reduce_kernel",)),
                ("elementwise", ("elementwise", "CatArrayBatched",
                                 "index", "copy")))


def profile_device(run, top: int = 12, must=(), must_not=()):
    """Device time by kernel over one call of `run` (one more rollout, one
    more train step), from torch.profiler: the total, its share of that
    call's wall time (the device's busy share; the profiler's own host cost
    is in the wall), the largest kernels in ms, and every kernel of this
    port (`tpu1x::`) with its calls and ms. Raises if a device kernel's
    name holds a string of `must_not`, or no kernel's holds one of
    `must`; and if a GEMM of the port other than csrc/gemm_sm90.cuh's ran
    (every product of the port is on it)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_summary(prof, wall, top, must, must_not)


def device_summary(prof, wall, top=12, must=(), must_not=()):
    """`profile_device`'s summary of a finished profile over `wall`
    seconds."""
    on_device = [a for a in prof.key_averages()
                 if a.device_type == torch.autograd.DeviceType.CUDA]
    names = [a.key for a in on_device]
    other_gemms = [k for k in names if "tpu1x::" in k and "gemm" in k
                   and "gemm90_kernel<" not in k]
    banned = [k for k in names for bad in must_not if bad in k]
    missing = [want for want in must if not any(want in k for k in names)]
    if other_gemms or banned or missing:
        raise AssertionError(f"profile: GEMMs off gemm_sm90.cuh {other_gemms}"
                             f", forbidden kernels {banned}, kernels that "
                             f"did not run {missing}")
    total = sum(a.self_device_time_total for a in on_device) / 1e3
    ranked = sorted(on_device, key=lambda a: -a.self_device_time_total)
    by_kind = {}
    for a in on_device:
        kind = next((k for k, marks in KERNEL_KINDS if any(
            m in a.key for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + a.self_device_time_total / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": total, "by_kind": by_kind,
            "busy_share": total / (wall * 1e3),
            "top": [[a.key[:60], a.count, a.self_device_time_total / 1e3]
                    for a in ranked[:top]],
            "port": {a.key: [a.count, a.self_device_time_total / 1e3]
                     for a in ranked if "tpu1x::" in a.key}}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_prefill_and_logits(model, cfg, prompt, engine, plain,
                             actions=None):
    """The prefill cache and the first new frame's step-0 logits of the
    kernel path against the plain path, each path on its own cache, under
    `actions` (B, P + NEW) where given.

    Layer 0 of the cache is held elementwise (atol = rtol = 3e-2). Deeper
    down, two bf16 paths drift apart by their rounding alone, so the whole
    cache and the logits are held by relative L2 error: at most 3e-2 from
    the plain path, and no farther from an fp32 plain run than the bf16
    plain path is (1.25x + 1e-3). An int8 cache is compared dequantized, by
    the same gates: every path quantizes its own k and v, so a value that
    the two bf16 paths round to neighbouring int8 steps differs by one step,
    amax / 127 of its token, which is inside the elementwise gate."""
    device = engine.device
    ref = PlainDecodeEngine(cfg, device=device, compute_dtype=torch.float32,
                            gelu="tanh", cache_dtype=plain.cache_dtype)
    ref_params = prepare_serving_params(model, cfg, torch.float32, device)
    masked = torch.full((B, cfg.S), cfg.mask_token_id, dtype=torch.long,
                        device=device)
    got = {}
    for name, eng, params in (("kernel", engine.engine, engine.params),
                              ("plain", plain, engine.params),
                              ("fp32", ref, ref_params)):
        cache = eng.prefill(params, prompt,
                            None if actions is None else actions[:, :P])
        logits, _ = eng.decode_frame(
            params, masked, P, cache,
            action_B=None if actions is None else actions[:, P],
            return_kv=False)
        got[name] = {"logits": logits}
        for key in ("k", "v"):
            got[name][key] = cache[key][:P]
            if key + "_scale" in cache:  # (L, B, T, S) -> (T, L, B, S)
                got[name][key] = da.dequantize_kv(
                    cache[key][:P],
                    cache[key + "_scale"].permute(2, 0, 1, 3)[:P])
        del cache
    out = {}
    for key in ("k", "v"):
        out[f"prefill_{key}_layer0_max_abs_err"] = compare(
            f"prefill cache {key} layer 0", got["kernel"][key][:, 0],
            got["plain"][key][:, 0], 3e-2, 3e-2)
    for key in ("k", "v", "logits"):
        kp = rel_l2(got["kernel"][key], got["plain"][key])
        k32 = rel_l2(got["kernel"][key], got["fp32"][key])
        p32 = rel_l2(got["plain"][key], got["fp32"][key])
        out[f"{key}_rel_l2"] = {"kernel_vs_plain": kp, "kernel_vs_fp32": k32,
                                "plain_vs_fp32": p32}
        if not (kp <= 3e-2 and k32 <= 1.25 * p32 + 1e-3):
            raise AssertionError(
                f"{key}: relative L2 errors {out[key + '_rel_l2']}")
    return out


# ---------------------------------------------------------------- training

def grad_errors(name, got, want):
    """A gradient against the plain path's: elementwise within 3e-2 of the
    largest magnitude plus 3e-2 relative, and within 2e-2 in relative L2."""
    scale = float(want.float().abs().max())
    err = compare(name, got, want, 3e-2 * scale, 3e-2)
    r = rel_l2(got, want)
    if not r <= 2e-2:
        raise AssertionError(f"{name}: relative L2 error {r:.3e} > 2e-2")
    return {"max_abs_err": err, "rel_l2": r}


def leaves_of(tensors):
    return {k: t.detach().clone().requires_grad_(True)
            for k, t in tensors.items()}


def both_paths(name, kernel_fn, plain_fn, tensors, dout):
    """The output and the gradient of sum(out * dout) for every tensor of
    `tensors` through the kernels' autograd.Function and through the plain
    version's ordinary autograd. Returns (output max abs error, {tensor:
    gradient errors})."""
    res = []
    for fn in (kernel_fn, plain_fn):
        leaves = leaves_of(tensors)
        out = fn(**leaves)
        grads = torch.autograd.grad(out, list(leaves.values()), dout)
        res.append((out.detach(), dict(zip(leaves, grads))))
    (out_k, g_k), (out_p, g_p) = res
    for k in tensors:
        if g_k[k].dtype != tensors[k].dtype:
            raise AssertionError(f"{name} d{k}: dtype {g_k[k].dtype}")
    return (compare(name, out_k, out_p, 3e-2, 3e-2),
            {k: grad_errors(f"{name} d{k}", g_k[k], g_p[k]) for k in tensors})


def plain_ms(plain_fn, tensors, dout=None):
    """Time of the plain forward (no graph), or with `dout` of its backward
    alone (the graph built once and kept)."""
    if dout is None:
        with torch.no_grad():
            return time_ms(lambda: plain_fn(**tensors), iters=5)
    leaves = leaves_of(tensors)
    out = plain_fn(**leaves)
    return time_ms(lambda: torch.autograd.grad(
        out, list(leaves.values()), dout, retain_graph=True), iters=5)


def entry(err, grads, shape, ms, plain, bnd, library_ms=None, **extra):
    """One kernel's result; `extra` adds keys such as device_ms and
    library_device_ms."""
    return dict(max_abs_err=err, grads=grads, shape=list(shape), ms=ms,
                plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms, **extra)


def check_spatial_train_block(inp, C, H, timed=True):
    """K11's backward (with K1's forward under autograd), values and every
    gradient, against `spatial_train_block_plain`'s autograd; with `timed`
    its event and device times, the plain backward's and the bound."""
    S, N = 256, TB * 16
    t = dict(x=inp.normal(N, S, C), **{
        k: v.float() for k, v in spatial_weights(inp, C).items()})
    dout = inp.normal(N, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    tag = "" if C == 512 else f"[C={C}]"
    out_err, grads = both_paths(
        "spatial_train_block" + tag,
        functools.partial(stb.spatial_train_block, **kw),
        functools.partial(stb.spatial_train_block_plain, **kw), t, dout)
    if not timed:
        return {"spatial_train_block_bwd" + tag: dict(
            max_abs_err=grads["x"]["max_abs_err"], grads=dict(grads,
                                                               out=out_err),
            shape=list(t["x"].shape))}
    w16 = (tk.as_bf16(t["wqkv"]), tk.as_bf16(t["wproj"]), None,
           t["ln_scale"], t["ln_bias"])
    R = N * S
    moved = 3 * R * C * 2 + 4 * C * C * (2 + 4) + 5 * C * 4
    # products: qkv (recompute) 6, d_o 2, dWproj 2, dWqkv 6, d_xn 6 R C^2;
    # per head logits, o, dp, dq, dk, dv of 2 S S D each
    bnd = bound(moved, tensor_flops=R * C * (22 * C + 12 * S),
                fp32_flops=20 * R * C + 10 * N * H * S * S)

    def run():
        return stb.spatial_train_block_bwd(t["x"], dout, *w16,
                                           proj_bias=True, **kw)
    return {"spatial_train_block_bwd": entry(
        grads["x"]["max_abs_err"], dict(grads, out=out_err), t["x"].shape,
        time_ms(run),
        plain_ms(functools.partial(stb.spatial_train_block_plain, **kw), t,
                 dout), bnd, device_ms=device_ms(run))}


def check_temporal_train_block(inp, C, H, timed=True):
    """K12's forward and backward, values and every gradient, against
    `temporal_train_block_plain`'s autograd; with `timed` their event and
    device times, the plain version's and the bounds."""
    S, T = 256, 16
    t = dict(x=inp.normal(TB, T, S, C),
             wqkv=inp.normal(C, 3 * C, std=0.05, dtype=torch.float32),
             wproj=inp.normal(C, C, std=0.05, dtype=torch.float32),
             bproj=inp.normal(C, std=0.1, dtype=torch.float32))
    dout = inp.normal(TB, T, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    tag = "" if C == 512 else f"[C={C}]"
    plain = functools.partial(ttb.temporal_train_block_plain, **kw)
    out_err, grads = both_paths(
        "temporal_train_block" + tag,
        functools.partial(ttb.temporal_train_block, **kw), plain, t, dout)
    if not timed:
        return {"temporal_train_block" + tag: dict(
                    max_abs_err=out_err, shape=list(t["x"].shape)),
                "temporal_train_block_bwd" + tag: dict(
                    max_abs_err=grads["x"]["max_abs_err"], grads=grads)}
    w16 = [tk.as_bf16(t[k]) for k in ("wqkv", "wproj")]
    b16 = tk.as_bf16(t["bproj"])
    R, pairs = TB * T * S, T * (T + 1) // 2
    weights = 4 * C * C
    fwd = bound(2 * R * C * 2 + weights * 2,
                tensor_flops=8 * R * C * C + 4 * TB * S * C * pairs)
    bwd = bound(3 * R * C * 2 + weights * (2 + 4) + C * 4,
                tensor_flops=22 * R * C * C + 12 * TB * S * C * pairs)

    def run_fwd():
        return ttb.temporal_train_block_fwd(t["x"], *w16, None, b16, **kw)

    def run_bwd():
        return ttb.temporal_train_block_bwd(t["x"], dout, *w16, None,
                                            proj_bias=True, **kw)
    return {
        "temporal_train_block": entry(
            out_err, {}, t["x"].shape, time_ms(run_fwd), plain_ms(plain, t),
            fwd, device_ms=device_ms(run_fwd)),
        "temporal_train_block_bwd": entry(
            grads["x"]["max_abs_err"], grads, t["x"].shape, time_ms(run_bwd),
            plain_ms(plain, t, dout), bwd, device_ms=device_ms(run_bwd))}


def check_mlp_train_block(inp, C, ln=True, timed=True):
    """K13 forward and backward, values and every gradient, with the tanh
    and the exact-erf GELU, against `mlp_train_block_plain`'s autograd; with
    `ln` False without its LayerNorm, as the qk_norm models call it. With
    `timed`: the event and device times, the plain version's and the
    bounds, and a profile of one forward and backward, which must launch no
    GEMM of the port but csrc/gemm_sm90.cuh's (`profile_device`)."""
    S, N, F4 = 256, TB * 16, 4 * C
    w = block_weights(inp, C)
    t = dict(x=inp.normal(N, S, C), **{
        k: w[k].float() for k in ("wfc1", "wfc2", "bfc1", "bfc2") + (
            ("ln_scale", "ln_bias") if ln else ())})
    dout = inp.normal(N, S, C)
    out = {}
    for approx in (False, True):  # erf: the shipped GELU
        name = "mlp_train_block" + ("[tanh]" if approx else "") + (
            "" if ln else "[no-ln]") + ("" if C == 512 else f"[C={C}]")
        plain = functools.partial(mtb.mlp_train_block_plain,
                                  gelu_approx=approx)
        out_err, grads = both_paths(
            name, functools.partial(mtb.mlp_train_block, gelu_approx=approx),
            plain, t, dout)
        bwd_name = name.replace("block", "block_bwd", 1)
        if not timed:
            out[name] = dict(max_abs_err=out_err, shape=list(t["x"].shape))
            out[bwd_name] = dict(max_abs_err=grads["x"]["max_abs_err"],
                                 grads=grads)
            continue
        w16 = [tk.as_bf16(t[k]) for k in ("wfc1", "wfc2", "bfc1", "bfc2")]
        ln_params = (t["ln_scale"], t["ln_bias"]) if ln else (None, None)
        R = N * S
        weights = 2 * C * F4
        fwd = bound(2 * R * C * 2 + weights * 2,
                    tensor_flops=4 * R * C * F4, fp32_flops=10 * R * F4)
        # fc1 (recompute), dWfc2, d_g, dWfc1, d_xn: 2 R C F4 each
        bwd = bound(3 * R * C * 2 + weights * (2 + 4) + (F4 + 3 * C) * 4,
                    tensor_flops=10 * R * C * F4,
                    fp32_flops=20 * R * F4 + 20 * R * C)

        def run_fwd():
            return mtb.mlp_train_block_fwd(t["x"], *w16, *ln_params,
                                           gelu_approx=approx)

        def run_bwd():
            return mtb.mlp_train_block_bwd(t["x"], dout, *w16[:3], *ln_params,
                                           gelu_approx=approx, bias=True)
        # K13's products all run on csrc/gemm_sm90.cuh
        profile = profile_device(lambda: (run_fwd(), run_bwd()))
        out[name] = entry(out_err, {}, t["x"].shape, time_ms(run_fwd),
                          plain_ms(plain, t), fwd,
                          device_ms=device_ms(run_fwd),
                          profile=profile["port"])
        out[bwd_name] = entry(grads["x"]["max_abs_err"], grads, t["x"].shape,
                              time_ms(run_bwd), plain_ms(plain, t, dout), bwd,
                              device_ms=device_ms(run_bwd))
    return out


def check_gemm90_train(inp, C):
    """The training forms of csrc/gemm_sm90.cuh alone, at the train blocks'
    products (the pre-LN train step's 32768 rows). K13's (C -> 4C and
    back): fc1 = GELU(xn Wfc1 + b) (nn, erf with and without the
    pre-activation out, tanh with it), fc2 = h Wfc2 + b + x (nn), d_g =
    (dout Wfc2^T) GELU'(h) (nt, erf and tanh), d_xn = d_h Wfc1^T in fp32
    (nt), dx = d_h Wfc1^T + dout (nt, the qk_norm form), dWfc2 = g^T dout
    and dWfc1 = xn^T d_h (tn, both orientations). K11's and K12's (C -> 3C
    and C -> C): qkv = a Wqkv + b (nn), proj = a Wproj + b + x (nn), d_o =
    dout Wproj^T (nt), d_xn = dqkv Wqkv^T in fp32 (nt), dx = dqkv Wqkv^T +
    dout (nt), dWproj = o^T dout and dWqkv = xn^T dqkv (tn). Each against
    `gemm90_plain` (bf16 outputs atol = rtol = 3e-2; fp32 outputs by the
    gradient gates), by device time and TFLOP/s beside `torch.matmul` of
    the same operands (timed only)."""
    R, F4 = TB * 16 * 256, 4 * C
    xn, x, dout = inp.normal(R, C), inp.normal(R, C), inp.normal(R, C)
    h, g, d_h = inp.normal(R, F4), inp.normal(R, F4), inp.normal(R, F4)
    w1, w2 = inp.normal(C, F4, std=0.05), inp.normal(F4, C, std=0.05)
    b1, b2 = inp.normal(F4, std=0.1), inp.normal(C, std=0.1)
    o, dqkv = inp.normal(R, C), inp.normal(R, 3 * C)
    wqkv, wproj = inp.normal(C, 3 * C, std=0.05), inp.normal(C, C, std=0.05)
    bqkv = inp.normal(3 * C, std=0.1)
    cases = [
        ("fc1[erf]", xn, w1, dict(bias=b1, act="gelu_erf")),
        ("fc1[erf,pre]", xn, w1, dict(bias=b1, act="gelu_erf",
                                      pre_out=True)),
        ("fc1[tanh,pre]", xn, w1, dict(bias=b1, act="gelu_tanh",
                                       pre_out=True)),
        ("fc2", h, w2, dict(bias=b2, resid=x)),
        ("d_g[erf]", dout, w2, dict(form="nt", aux=h, act="dgelu_erf")),
        ("d_g[tanh]", dout, w2, dict(form="nt", aux=h, act="dgelu_tanh")),
        ("d_xn", d_h, w1, dict(form="nt", fp32_out=True)),
        ("dx[no-ln]", d_h, w1, dict(form="nt", resid=dout)),
        ("dWfc2", g, dout, dict(form="tn")),
        ("dWfc1", xn, d_h, dict(form="tn")),
        ("qkv", xn, wqkv, dict(bias=bqkv)),
        ("proj", o, wproj, dict(bias=b2, resid=x)),
        ("d_o", dout, wproj, dict(form="nt")),
        ("d_xn[qkv]", dqkv, wqkv, dict(form="nt", fp32_out=True)),
        ("dx[qkv]", dqkv, wqkv, dict(form="nt", resid=dout)),
        ("dWproj", o, dout, dict(form="tn")),
        ("dWqkv", xn, dqkv, dict(form="tn")),
    ]
    out = {}
    for name, a, b, kw in cases:
        form = kw.get("form", "nn")
        got = tk.gemm90(a, b, **kw)
        want = tk.gemm90_plain(a, b, **kw)
        got, want = ((got, want) if kw.get("pre_out")
                     else ((got,), (want,)))
        err = 0.0
        for i, (gv, wv) in enumerate(zip(got, want)):
            tag = f"gemm90 {name}" + (" pre" if i else "")
            err = max(err, grad_errors(tag, gv, wv)["max_abs_err"]
                      if gv.dtype == torch.float32
                      else compare(tag, gv, wv, 3e-2, 3e-2))
        M, N = got[0].shape
        K = a.shape[0] if form == "tn" else a.shape[1]
        flops = 2 * M * N * K
        bms, by = bound(nbytes(a, b, *(v for v in kw.values()
                                      if isinstance(v, torch.Tensor)),
                               *got), tensor_flops=flops)
        dev = device_ms(lambda: tk.gemm90(a, b, **kw))
        lhs = a.t() if form == "tn" else a
        rhs = b.t() if form == "nt" else b
        r = dict(max_abs_err=err, shape=[M, N, K], bound_ms=bms, bound_by=by,
                 device_ms=dev, tflops=tflops(flops, dev),
                 library_device_ms=device_ms(lambda: torch.matmul(lhs, rhs)))
        out[name] = r
    return {"gemm90_train": out}


def check_temporal_attention_bwd(inp, C, H):
    """K6 at the pre-LN train step's (TB, 16, 256, C), causal and not: the
    output and dq, dk, dv of the kernels' autograd.Function against the
    plain version's autograd, and the `o` that K6 writes beside them equal
    to K4's output exactly; its event and device times without and with
    `o`, the bounds, the plain backward's time and SDPA's backward's."""
    S, T, D = 256, 16, C // H
    t = dict(qkv=inp.normal(TB, T, S, 3 * C))
    dout = inp.normal(TB, T, S, C)
    scale = D ** -0.5
    out = {}
    for causal in (True, False):
        name = ("temporal_attention_bwd" + ("" if causal else "[non-causal]")
                + ("" if C == 512 else f"[C={C}]"))
        kw = dict(scale=scale, num_heads=H, causal=causal)

        def kernel(qkv):
            return ta.temporal_attention(*qkv.split(C, dim=-1), **kw)

        def plain(qkv):
            return ta.temporal_attention_plain(*qkv.split(C, dim=-1), **kw)

        out_err, grads = both_paths(name, kernel, plain, t, dout)
        q, k, v = t["qkv"].split(C, dim=-1)
        o = torch.full_like(dout, float("nan"))
        dqkv = ta.launch_backward(q, k, v, dout, o=o, **kw)
        if not torch.equal(o, ta.launch_forward(q, k, v, **kw)):
            raise AssertionError(f"{name}: o differs from K4's output")
        if not torch.equal(dqkv, ta.launch_backward(q, k, v, dout, **kw)):
            raise AssertionError(f"{name}: dq, dk, dv differ with o")

        def heads(x):  # (B, T, S, C) -> (B, S, H, T, D) view
            return x.reshape(TB, T, S, H, D).permute(0, 2, 3, 1, 4)
        lq, lk, lv = (heads(x).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                                 scale=scale)
        pairs = T * (T + 1) // 2 if causal else T * T
        # logits, dp, dq, dk, dv: five products (and o six) of 2 D FLOP a
        # (query, key, head)
        bnd = temporal_bound(TB, T, S, C, 7, pairs, 5)
        bnd_o = temporal_bound(TB, T, S, C, 8, pairs, 6)

        def bwd():
            return ta.launch_backward(q, k, v, dout, **kw)

        def bwd_o():
            return ta.launch_backward(q, k, v, dout, o=o, **kw)

        def library():
            return torch.autograd.grad(lib_out, (lq, lk, lv), heads(dout),
                                       retain_graph=True)
        out[name] = entry(
            grads["qkv"]["max_abs_err"], dict(grads, out=out_err), q.shape,
            time_ms(bwd), plain_ms(plain, t, dout), bnd,
            library_ms=time_ms(library), device_ms=device_ms(bwd),
            library_device_ms=device_ms(library), o_equals_forward=True,
            ms_with_o=time_ms(bwd_o), device_ms_with_o=device_ms(bwd_o),
            bound_with_o_ms=bnd_o[0])
    return out


def check_fresh_thread(inp, C, H):
    """`chip_variants.fresh_thread_launches`: a training-form GEMM launch and
    K10's backward, each as the first card call of a new thread (no CUDA
    context current there, as in autograd's backward thread), held against
    their plain versions; fails where a launch returns an error."""
    from chip_variants import fresh_thread_launches
    out = fresh_thread_launches(inp, C, H)
    for name, r in out.items():
        if r["rc"] != 0:
            raise AssertionError(f"{name} as a new thread's first card "
                                 f"call: CUDA error {r['rc']}")
    return out


def check_decode_batches(C, H, device):
    """K7 and K8 (bf16 and int8 cache) at B = 16, 17, 16 + 256 (one
    launch per 256 rows) and 16 again, and K2 at B = 16 then 17, each
    against its plain version by the gates of 3: a launch's shared memory
    must not depend on the batches launched before it (S = 64 for K7 and
    K8, a 2-layer cache, t_B mixed 0..15)."""
    inp = Inputs(4, device)
    T, L, S = 16, 2, 64
    kw = dict(layer=1, scale=(C // H) ** -0.5, num_heads=H)
    errs = {}
    for Bt in (16, 17, 16 + 256, 16):
        kc, vc = inp.normal(T, L, Bt, S, C), inp.normal(T, L, Bt, S, C)
        (kq, ks), (vq, vs) = quantize_cache(kc), quantize_cache(vc)
        t_B = (torch.arange(Bt, device=device) * 7 % 16).to(torch.int32)
        for cache, ckw, kcc, vcc in (
                ("bf16", {}, kc, vc),
                ("int8", dict(k_scale=ks, v_scale=vs), kq, vq)):
            for frames in (1, 2):
                q, k, v = (x.unbind(1) for x in inp.normal(
                    Bt, frames, S, 3 * C).split(C, dim=-1))
                tb = t_B.clamp(max=T - frames)
                if frames == 1:
                    args = (q[0], kcc, vcc, k[0], v[0], tb)
                    kernel, plain = (da.temporal_decode_attention,
                                     da.temporal_decode_attention_plain)
                else:
                    args = (q[0], q[1], kcc, vcc, k[0], v[0], k[1], v[1], tb)
                    kernel, plain = (da.temporal_decode2_attention,
                                     da.temporal_decode2_attention_plain)
                got = kernel(*args, **kw, **ckw)
                want = plain(*args, **kw, **ckw)
                got, want = ((got,), (want,)) if frames == 1 else (got, want)
                name = f"{kernel.__name__}[{cache},B={Bt}]"
                errs[name] = max(compare(name, g, w, 3e-2, 3e-2)
                                 for g, w in zip(got, want))
    del kc, vc, kq, vq, ks, vs
    w = block_weights(inp, C)
    bkw = dict(scale=(C // H) ** -0.5, num_heads=H, gelu_tanh=True, **w)
    for Bt in (16, 17):
        kc, vc = inp.normal(T, L, Bt, 256, C), inp.normal(T, L, Bt, 256, C)
        x = inp.normal(Bt, 256, C)
        t_B = (P + torch.arange(Bt, device=device) % (T - P)).to(torch.int32)
        got = temporal_mlp_block(x, kc, vc, t_B, layer=1, **bkw)
        want = temporal_mlp_block_plain(x, kc[:, 1], vc[:, 1], t_B, **bkw)
        name = f"temporal_mlp_block[B={Bt}]"
        errs[name] = compare(name, got[0], want[0], 3e-2, 3e-2)
        compare(name + " k", got[1], want[1], 2e-2, 2e-2)
        compare(name + " v", got[2], want[2], 2e-2, 2e-2)
    return errs


def check_train_kernels(C, H, device):
    inp = Inputs(1, device)
    out = {}
    out.update(check_temporal_attention_bwd(inp, C, H))
    out.update(check_temporal_attention_bwd(inp, 256, 8))
    out.update(check_spatial_train_block(inp, C, H))
    out.update(check_temporal_train_block(inp, C, H))
    out.update(check_mlp_train_block(inp, C))
    # GENIE_35M's width, 8 heads; the MLP block with and without the LN
    out.update(check_spatial_train_block(inp, 256, 8, timed=False))
    out.update(check_temporal_train_block(inp, 256, 8, timed=False))
    for ln in (True, False):
        out.update(check_mlp_train_block(inp, 256, ln=ln, timed=False))
    torch.cuda.empty_cache()
    out.update(check_gemm90_train(inp, C))
    torch.cuda.empty_cache()
    for name, r in out.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    return out


@contextlib.contextmanager
def plain_blocks():
    """Every STBlock takes the plain train blocks, on any device: this
    script's oracle. The port itself has no way to them on the card."""
    kernel_ops = STBlock.ops
    STBlock.ops = SimpleNamespace(spatial=stb.spatial_train_block_plain,
                                  temporal=ttb.temporal_train_block_plain,
                                  mlp=mtb.mlp_train_block_plain,
                                  mha=attn.mha_reference)
    try:
        yield
    finally:
        STBlock.ops = kernel_ops


@contextlib.contextmanager
def without_remat(model):
    """`model`'s blocks run without recompute: the oracle then holds a
    remat kernel path against a path that shares no remat code."""
    blocks = [m for m in model.modules() if isinstance(m, STBlock)]
    policies = [b.remat_policy for b in blocks]
    for b in blocks:
        b.remat_policy = None
    try:
        yield
    finally:
        for b, policy in zip(blocks, policies):
            b.remat_policy = policy


def check_training(cfg, device, per_layer=TRAIN_PER_LAYER):
    g = torch.Generator(device=device).manual_seed(0)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (TB, cfg.T, side, side),
                           generator=g, device=device)
    noise = draw_noise(tokens.shape, cfg, g, device)
    optimizer = TrainOptimizer(model, cfg, learning_rate=TRAIN_LR,
                                max_grad_norm=1.0)
    step = make_train_step(model, optimizer, cfg)  # the card is the default

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    first = step(tokens, noise=noise)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(per_layer, cfg.num_layers)
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")

    metrics, walls = [first], []
    for _ in range(TRAIN_STEPS - 1):
        t0 = time.perf_counter()
        metrics.append(step(tokens, noise=noise))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    uniform = cfg.num_factored_vocabs * math.log(cfg.factored_vocab_size)
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    # the head's random weights give logits a spread of about 1, which puts
    # the first loss up to about 1 above the uniform guess's 2 ln 512
    if abs(losses[0] - uniform) > 1.5:
        raise AssertionError(f"first loss {losses[0]}, expected ~{uniform}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    step_s = sorted(walls[-5:])[2]
    # the pre-LN step: K11's attention backward is K10's kernel, beside the
    # recompute on K9's; of spatial_block.cu's own kernels none runs (the
    # qk-LN attention is the qk_norm models'); K4 and K6 are
    # temporal_attention.cu's tiled kernels, and the names of the per-(b, s)
    # kernels they replaced must not appear
    pre_ln = {} if cfg.qk_norm else dict(
        must=("flash_fwd_kernel", "flash_bwd_kernel", "temporal_fwd_kernel",
              "temporal_bwd_kernel"),
        must_not=("spatial_attention", "temporal_attention_kernel",
                  "temporal_attention_bwd_kernel"))
    device_time = profile_device(lambda: step(tokens, noise=noise), **pre_ln)
    out = dict(launches=launches, losses=losses, grad_norms=norms,
               accs=[float(m["acc"]) for m in metrics], step_s=step_s,
               step_s_runs=walls, tokens_per_s=TB * cfg.T * cfg.S / step_s,
               peak_memory_bytes=peak, batch=TB, layers=cfg.num_layers,
               qk_norm=cfg.qk_norm, lr=TRAIN_LR, device_time=device_time)
    del step, optimizer, metrics
    model.load_state_dict(init)
    return model, out


def check_step_against_plain(model, cfg, device, per_layer=TRAIN_PER_LAYER,
                             dropout_seed=None):
    """Loss, gradient norm and every parameter's gradient after one forward
    and backward from the same weights and the same corrupted batch, at the
    full depth and width and B = CB (the plain path's autograd keeps every
    (N, H, S, S) probability tensor, which does not fit at B = 8): the
    kernel path against the plain path, and both against an fp32 plain run.

    Two bf16 paths drift apart by rounding alone over 32 layers forward and
    32 back, so gradients are held in relative L2: every parameter's, and
    all parameters' together, within 3e-2 of the plain path's, and the
    kernel path no farther from the fp32 run than the bf16 plain path is
    (1.25x + 1e-3). The qk-LN parameters of the qk_norm models (32 values
    each, every one a sum over all tokens and heads of terms that cancel)
    carry that drift amplified about tenfold, also where both paths run the
    same plain code (the temporal attention: up to 5% between the two bf16
    paths). They are held to the fp32 run alone, parameter by parameter, at
    2x + 1e-3 of the plain path's distance: the fused attention backward
    rounds p and ds to bf16 for its products (0.26% relative L2 on dq, dk,
    dv in its own check), which the spatial qk-LN gradients show as up to
    3.9% from fp32 where the plain path has 2.2%. With `dropout_seed`, each
    of the three runs draws its dropout masks from a generator of that
    seed: the same masks on every path. The kernel path runs under the
    model's remat setting; the plain and fp32 runs without remat."""
    g = torch.Generator(device=device).manual_seed(2)
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (CB, cfg.T, side, side),
                           generator=g, device=device)
    batch = maskgit_corrupt(tokens, draw_noise(tokens.shape, cfg, g, device),
                            cfg)
    actions = (torch.randint(0, cfg.action_vocab_size, (CB, cfg.T),
                             generator=g, device=device)
               if cfg.action_vocab_size > 0 else None)
    ref = STMaskGIT(dataclasses.replace(cfg, dtype="float32", remat=False),
                    device=device)
    ref.load_state_dict(model.state_dict())

    def run(m, plain):
        # with dropout, each run draws its masks from the same seed
        gen = (None if dropout_seed is None else
               torch.Generator(device=device).manual_seed(dropout_seed))
        m.train().zero_grad(set_to_none=True)
        with (plain_blocks() if plain else contextlib.nullcontext(),
              without_remat(m) if plain else contextlib.nullcontext()):
            out = m(batch["input_ids"], batch["labels"], actions,
                    generator=gen)
            out["loss"].backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        norm = torch.linalg.vector_norm(torch.stack(
            [x.norm() for x in grads.values()]))
        return float(out["loss"].detach()), float(norm), grads

    kernels.reset_launches()
    got = {"kernel": run(model, False)}
    want = expected_launches(per_layer, cfg.num_layers)
    if kernels.LAUNCHES != want:
        raise AssertionError(f"the kernel path launched {kernels.LAUNCHES}")
    kernels.reset_launches()
    got["plain"] = run(model, True)
    got["fp32"] = run(ref, True)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the plain path launched {kernels.LAUNCHES}")

    def flat(name):
        return torch.cat([x.float().reshape(-1) for x in got[name][2].values()])
    per_param = {n: rel_l2(got["kernel"][2][n], got["plain"][2][n])
                 for n in got["plain"][2]}
    worst = sorted(per_param.items(), key=lambda kv: -kv[1])[:5]
    qk_ln = {}  # name -> (kernel vs plain, kernel vs fp32, plain vs fp32)
    for n in [n for n in per_param if "_attn.norm." in n]:
        qk_ln[n] = (per_param.pop(n), rel_l2(got["kernel"][2][n],
                                             got["fp32"][2][n]),
                    rel_l2(got["plain"][2][n], got["fp32"][2][n]))
    failed = {n: v for n, v in per_param.items() if not v <= 3e-2}
    failed.update({n: v for n, v in qk_ln.items()
                   if not v[1] <= 2 * v[2] + 1e-3})
    worst_qk_ln = sorted(qk_ln.items(), key=lambda kv: -kv[1][0])[:3]
    fk, fp, f32 = flat("kernel"), flat("plain"), flat("fp32")
    out = {"batch": CB, "layers": cfg.num_layers,
           "loss": {k: v[0] for k, v in got.items()},
           "grad_norm": {k: v[1] for k, v in got.items()},
           "grads_rel_l2": {"kernel_vs_plain": rel_l2(fk, fp),
                            "kernel_vs_fp32": rel_l2(fk, f32),
                            "plain_vs_fp32": rel_l2(fp, f32)},
           "worst_params_kernel_vs_plain": worst,
           "worst_qk_ln_params": worst_qk_ln, "failed_params": failed}
    r = out["grads_rel_l2"]
    loss_k, loss_p, loss_32 = (out["loss"][k] for k in ("kernel", "plain",
                                                        "fp32"))
    ok = (not failed and r["kernel_vs_plain"] <= 3e-2
          and r["kernel_vs_fp32"] <= 1.25 * r["plain_vs_fp32"] + 1e-3
          and abs(loss_k - loss_p) <= 2e-2
          and abs(loss_k - loss_32) <= 1.25 * abs(loss_p - loss_32) + 2e-2
          and abs(out["grad_norm"]["kernel"] / out["grad_norm"]["plain"] - 1)
          <= 5e-2)
    if not ok:
        raise AssertionError(f"train step against the plain path: {out}")
    return out


def check_action_conditioning(device, layers=8, actions=16):
    """Action conditioning on the card: GENIE_138M at `layers` layers with
    an action vocabulary of `actions` ids. The rollout under seeded actions
    (`check_rollout`: exact launch counts, the prefill cache and the step-0
    logits against `PlainDecodeEngine`); one `make_train_step` step with
    actions_BT through the kernels (exact launch counts) and through the
    plain train blocks, from the same weights, batch, corruption and
    actions (loss and gradient norm); and every parameter's gradient under
    the same actions against the plain path and an fp32 run
    (`check_step_against_plain`). Actions enter through the embedding
    alone, so every kernel sees what it sees without them."""
    cfg = genie_138m(num_layers=layers, action_vocab_size=actions)
    roll = check_rollout(cfg, device, full=False)
    g = torch.Generator(device=device).manual_seed(3)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (CB, cfg.T, side, side),
                           generator=g, device=device)
    acts = torch.randint(0, actions, (CB, cfg.T), generator=g, device=device)
    noise = draw_noise(tokens.shape, cfg, g, device)
    steps = {}
    for path in ("kernel", "plain"):
        m = STMaskGIT(cfg, device=device)
        m.load_state_dict(model.state_dict())
        step = make_train_step(m, TrainOptimizer(m, cfg,
                                                 learning_rate=TRAIN_LR,
                                                 max_grad_norm=1.0), cfg)
        kernels.reset_launches()
        with plain_blocks() if path == "plain" else contextlib.nullcontext():
            r = step(tokens, actions_BT=acts, noise=noise)
        torch.cuda.synchronize()
        want = expected_launches(TRAIN_PER_LAYER if path == "kernel" else {},
                                 layers)
        if kernels.LAUNCHES != want:
            raise AssertionError(f"action train step, {path} path: launches "
                                 f"{kernels.LAUNCHES}, expected {want}")
        steps[path] = {k: float(v) for k, v in r.items()}
        del step, m
    # the gates of `check_step_against_plain` on the loss and the norm
    got, want = steps["kernel"], steps["plain"]
    if not (all(math.isfinite(v) for v in got.values())
            and abs(got["loss"] - want["loss"]) <= 2e-2
            and abs(got["grad_norm"] / want["grad_norm"] - 1) <= 5e-2):
        raise AssertionError(f"action train step against the plain path: "
                             f"{steps}")
    return dict(rollout=roll, train_step=steps,
                train_step_against_plain=check_step_against_plain(
                    model, cfg, device))


# -------------------------------------------------------------- evaluation

def launches_of(run, per_layer, layers, what):
    """Run `run()` with the counters set to 0 just before; fails unless it
    launched `per_layer` x `layers` of each kernel and nothing else."""
    kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(per_layer, layers)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    return out, launches


def median_s(run, n=3):
    """Median host time of `n` synchronized calls, after an untimed one."""
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[n // 2], walls


def check_scoring(model, cfg, device):
    """`RolloutEngine.score_policies` at GENIE_138M: one shared CTX-frame
    context, NP policies of T - CTX frames. Exact launch counts (one
    `compute_logits` through the train blocks' forwards); the per-frame CE
    within 3e-2 relative L2 of the same call through the plain train blocks
    and no farther from an fp32 plain run than that path is (1.25x + 1e-3);
    the scores the mean of the per-frame CE; `rank_policies` of both paths
    printed, ungated (random weights give near-ties); the time of a call
    (median of three after an untimed one)."""
    g = torch.Generator(device=device).manual_seed(5)
    side = cfg.latent_side_len
    ctx = torch.randint(0, cfg.image_vocab_size, (CTX, side, side),
                        generator=g, device=device)
    conts = torch.randint(0, cfg.image_vocab_size,
                          (NP, cfg.T - CTX, side, side), generator=g,
                          device=device)
    engine = RolloutEngine(model, cfg, device=device, decode="full")
    ref = RolloutEngine(model, dataclasses.replace(cfg, dtype="float32"),
                        device=device, decode="full")
    engine.score_policies(ctx, conts)  # first-call set-up
    (scores, frame_ce), launches = launches_of(
        lambda: engine.score_policies(ctx, conts, per_frame=True),
        LOGITS_PER_LAYER, cfg.num_layers, "score_policies")
    scores_only = engine.score_policies(ctx, conts)
    if tuple(frame_ce.shape) != (NP, cfg.T - CTX) or not (
            torch.isfinite(frame_ce).all()
            and torch.allclose(scores_only, frame_ce.mean(-1), rtol=1e-5)
            and torch.allclose(scores, scores_only, rtol=1e-5)):
        raise AssertionError(f"score_policies: {scores_only} {frame_ce}")
    with plain_blocks():
        (_, plain_ce), _ = launches_of(
            lambda: engine.score_policies(ctx, conts, per_frame=True), {},
            cfg.num_layers, "score_policies, plain path")
        ranks_plain = engine.rank_policies(ctx, conts)
        _, ce32 = ref.score_policies(ctx, conts, per_frame=True)
    del ref
    kp, k32, p32 = (rel_l2(frame_ce, plain_ce), rel_l2(frame_ce, ce32),
                    rel_l2(plain_ce, ce32))
    out = dict(policies=NP, context_frames=CTX, launches=launches,
               scores=scores.tolist(),
               rank_kernel=engine.rank_policies(ctx, conts).tolist(),
               rank_plain=ranks_plain.tolist(),
               frame_ce_rel_l2={"kernel_vs_plain": kp, "kernel_vs_fp32": k32,
                                "plain_vs_fp32": p32})
    if not (kp <= 3e-2 and k32 <= 1.25 * p32 + 1e-3):
        raise AssertionError(f"score_policies against the plain path: {out}")
    s, walls = median_s(lambda: engine.score_policies(ctx, conts))
    out.update(score_s=s, score_s_runs=walls, policies_per_s=NP / s)
    return engine, out


def synthetic_dataset(cfg, root):
    """WINDOWS non-overlapping windows of T frames (stride 1), random
    tokens from seed 0, one segment: `write_token_dataset` into `root`."""
    rng = np.random.default_rng(0)
    side = cfg.latent_side_len
    frames = rng.integers(0, cfg.image_vocab_size,
                          (WINDOWS * cfg.T, side, side))
    write_token_dataset(root, frames, vocab_size=cfg.image_vocab_size,
                        segment_ids=np.zeros(len(frames), np.int32))
    ds = RawTokenDataset(root, window_size=cfg.T, stride=1,
                         filter_overlaps=True)
    if len(ds) != WINDOWS:
        raise AssertionError(f"{len(ds)} windows, expected {WINDOWS}")
    return ds


def against_plain_engine(ev, cfg, tokens, device):
    """The cached path's step-0 logits and per-example CE over `ev`'s engine
    against `eval_all_frames` over `PlainDecodeEngine`, from one seed:
    logits within 3e-2 relative L2, every example's CE within 1%."""
    got = {}
    for name, eng in (("kernel", ev.engine),
                      ("plain", PlainDecodeEngine(cfg, device=device))):
        gen = torch.Generator(device=device).manual_seed(7)
        frames, flogits = eval_all_frames(eng, ev.params, tokens, gen, cfg,
                                          maskgit_steps=STEPS)
        got[name] = (flogits, frame_metrics(tokens, frames, flogits, cfg)[1])
    r = rel_l2(got["kernel"][0], got["plain"][0])
    ce_k, ce_p = got["kernel"][1], got["plain"][1]
    ce_err = float(((ce_k - ce_p).abs() / ce_p).max())
    if not (r <= 3e-2 and ce_err <= 1e-2):
        raise AssertionError(f"evaluator against the plain path: logits "
                             f"relative L2 {r}, CE relative error {ce_err}")
    return dict(logits_rel_l2=r, ce_max_rel_err=ce_err,
                ce_kernel=ce_k.tolist())


def check_evaluator(model, cfg, device, root):
    """`evaluate_dataset` through `GenieEvaluator` (KV-cached) at B = 16 on
    WINDOWS windows (a full batch and a padded tail): exact launch counts
    (two batches of EVAL_PER_LAYER), count WINDOWS, a finite loss within 1.5
    of 2 ln 512 (random weights); the first batch's step-0 logits and CE
    against the plain path (`against_plain_engine`); `gen_time`, the
    reference's s/frame, as the median of three `predict_metrics` calls at
    B = 16 after an untimed one, over (T - 1) B frames; device time by
    kernel over one more batch."""
    ds = synthetic_dataset(cfg, root)
    ev = GenieEvaluator(model, cfg, device=device, maskgit_steps=STEPS)
    ids = ds.get_batch(np.arange(B)).reshape(B, -1)
    ev.predict_metrics(ids)  # first-call set-up
    results, launches = launches_of(
        lambda: evaluate_dataset(ev, ds, batch_size=B, verbose=False),
        {k: 2 * v for k, v in EVAL_PER_LAYER.items()}, cfg.num_layers,
        "evaluate_dataset")
    uniform = cfg.num_factored_vocabs * math.log(cfg.factored_vocab_size)
    if not (results["count"] == WINDOWS and math.isfinite(results["loss"])
            and abs(results["loss"] - uniform) <= 1.5
            and 0 <= results["acc"] <= 1):
        raise AssertionError(f"evaluate_dataset: {results}")
    tokens = torch.from_numpy(ids).long().to(device).reshape(
        B, cfg.T, cfg.latent_side_len, -1)
    out = dict(results=results, launches=launches,
               first_batch_against_plain=against_plain_engine(
                   ev, cfg, tokens, device))
    s, walls = median_s(lambda: ev.predict_metrics(ids))
    frames = (cfg.T - 1) * B
    out.update(batch_s=s, batch_s_runs=walls, gen_time=s / frames,
               frames_per_batch=frames,
               device_time=profile_device(
                   lambda: ev.predict_metrics(ids),
                   must=("decode_ring_kernel", "temporal_fwd_kernel")))
    return ev, ds, out


def check_rows_and_full(engine, ev, cfg, ds, device):
    """The uncached paths against the cached one. `GenieEvaluator(use_cache=
    False)` on 2 examples (30 rows, padded to one chunk of 64): exact launch
    counts (one `compute_logits` a MaskGIT step), its step-0 logits within
    3e-2 relative L2 of the cached path's. `RolloutEngine(decode="full")` at
    B = 4, P + NEW frames: exact launch counts (one `compute_logits` a step
    of each new frame), the prompt kept; the first new frame's step-0 logits
    (`maskgit_generate` over the model) within 3e-2 relative L2 of the
    cached decode's over the same prompt. Tokens are not gated: two bf16
    paths may sample differently."""
    ids = ds.get_batch(np.arange(2)).reshape(2, -1)
    rows = GenieEvaluator(engine.model, cfg, device=device,
                          maskgit_steps=STEPS, use_cache=False)
    (_, got), launches_rows = launches_of(
        lambda: rows.predict_zframe_logits(ids), {
            k: STEPS * v for k, v in LOGITS_PER_LAYER.items()},
        cfg.num_layers, "evaluator rows path")
    del rows
    _, want = ev.predict_zframe_logits(ids)
    r_rows = rel_l2(torch.from_numpy(got), torch.from_numpy(want))

    Bf, side = 4, cfg.latent_side_len
    prompt = torch.from_numpy(ds.get_batch(np.arange(Bf))[:, :P]).to(
        device).long()
    gen = torch.Generator(device=device).manual_seed(1)
    out, launches_full = launches_of(
        lambda: engine.rollout(prompt, NEW, gen), {
            k: NEW * STEPS * v for k, v in LOGITS_PER_LAYER.items()},
        cfg.num_layers, "decode=full rollout")
    if tuple(out.shape) != (Bf, 1, P + NEW, side, side) or not torch.equal(
            out[:, 0, :P], prompt):
        raise AssertionError(f"decode=full rollout: shape {out.shape} or "
                             f"changed prompt")
    masked = torch.full((Bf, NEW, side, side), cfg.mask_token_id,
                        dtype=torch.long, device=device)
    with torch.no_grad():
        _, full0 = maskgit_generate(
            engine.logits_fn(), torch.cat([prompt, masked], 1), P,
            None, cfg, maskgit_steps=1)  # (B, V, F, h, w)
        cache = ev.engine.prefill(ev.params, prompt)
        cached0, _ = ev.engine.decode_frame(ev.params, masked[:, 0].reshape(
            Bf, -1), P, cache, return_kv=False)  # (B, S, V, F)
    full0 = full0.reshape(*full0.shape[:3], -1).permute(0, 3, 1, 2)
    r_full = rel_l2(full0, cached0)
    res = dict(rows_launches=launches_rows, rows_logits_rel_l2=r_rows,
               full_launches=launches_full, full_step0_rel_l2=r_full)
    if not (r_rows <= 3e-2 and r_full <= 3e-2):
        raise AssertionError(f"uncached paths against the cached: {res}")
    return res


def check_clis(model, cfg, device, root):
    """The evaluate and generate CLIs' `main` on a reference-layout
    checkpoint directory (config.json, pytorch_model.bin of the seeded
    model's state dict) and the synthetic dataset, with exact launch counts:
    evaluate with --max_examples WINDOWS (its JSON line: loss, acc,
    gen_time, count WINDOWS); generate with P prompt frames for 2 examples
    (the cached rollout's counts), whose video.bin is read back: [prompt |
    predicted | ground truth] frames, the prompt and ground truth equal to
    the dataset's."""
    ckpt = root / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               ckpt / "pytorch_model.bin")
    data = ["--val_data_dir", str(root / "data"), "--checkpoint_dir",
            str(ckpt), "--stride", "1", "--device", str(device)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, eval_launches = launches_of(
            lambda: ev_cli.main(data + ["--max_examples", str(WINDOWS)]),
            {k: 2 * v for k, v in EVAL_PER_LAYER.items()}, cfg.num_layers,
            "evaluate CLI")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    if not ({"loss", "acc", "gen_time"} <= result.keys()
            and result["count"] == WINDOWS):
        raise AssertionError(f"evaluate CLI printed {result}")
    n = 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, gen_launches = launches_of(
            lambda: gen_cli.main(data + [
                "--output_dir", str(root / "gen"), "--num_prompt_frames",
                str(P), "--batch_size", str(n)]),
            PER_LAYER, cfg.num_layers, "generate CLI")
    video = RawTokenDataset(root / "gen", window_size=1,
                            filter_interrupts=False)
    side = cfg.latent_side_len
    stream = np.asarray(video.data).reshape(n, cfg.T + NEW, side, side)
    truth = RawTokenDataset(root / "data", window_size=cfg.T,
                            stride=1).get_batch(np.arange(n))
    if not (np.array_equal(stream[:, :P], truth[:, :P])
            and np.array_equal(stream[:, cfg.T:], truth[:, P:])
            and video.metadata["num_prompt_frames"] == P):
        raise AssertionError("generate CLI: video.bin does not hold "
                             "[prompt | predicted | ground truth]")
    return dict(evaluate=result, evaluate_launches=eval_launches,
                generate_launches=gen_launches,
                generate_log=buf.getvalue().strip().splitlines())


def check_qk_norm_evaluator(device, layers=8):
    """One evaluator batch (B = 16, predict_metrics) on
    `genie_138m(qk_norm=True)` at `layers` layers, op by op: exact launch
    counts, and the step-0 logits and CE against the plain path."""
    cfg = genie_138m(qk_norm=True, num_layers=layers)
    g = torch.Generator(device=device).manual_seed(6)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (B, cfg.T, side, side),
                           generator=g, device=device)
    ev = GenieEvaluator(model, cfg, device=device, maskgit_steps=STEPS)
    ids = tokens.reshape(B, -1).cpu().numpy()
    ev.predict_metrics(ids)
    (_, loss, _), launches = launches_of(
        lambda: ev.predict_metrics(ids), EVAL_PER_LAYER_QK, layers,
        "qk_norm evaluator")
    return dict(layers=layers, launches=launches, loss=loss.tolist(),
                against_plain=against_plain_engine(ev, cfg, tokens, device))


# --------------------------------------------------------------- tokenizer

VQ_CONFIG = VQConfig()  # full width: 256 px, base 128, z 18, bf16
VQ_B, VQ_SEGMENTS, VQ_SEG_FRAMES, LPIPS_B = 16, 2, 24, 32


def synthetic_frames(n, side, seed):
    """uint8 (n, side, side, 3) from `seed`: per channel a smooth sinusoid
    over the image whose phase drifts from frame to frame, plus noise, so
    that the latents do not all sit near 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    freq, phase = rng.uniform(1, 4, (3, 2)), rng.uniform(0, 2 * np.pi, 3)
    t = np.arange(n, dtype=np.float32)[:, None, None, None]
    img = 0.5 + 0.4 * np.sin(2 * np.pi * (freq[:, 0] * xx[..., None]
                                          + freq[:, 1] * yy[..., None])
                             + phase + 0.2 * t)
    img = img * 255 + rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def vq_flops(vq_cfg):
    """(encoder, decoder) FLOPs of one frame: torch's count of the
    convolutions (2 x multiply-adds) on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    side = vq_cfg.resolution
    with torch.device("meta"):
        model = VQModel(dataclasses.replace(vq_cfg, dtype="float32"))
        x = torch.zeros(1, side, side, 3)
        with FlopCounterMode(display=False) as enc:
            quant = model.encode(x).quantized
        with FlopCounterMode(display=False) as dec:
            model.decode(quant)
    return enc.get_total_flops(), dec.get_total_flops()


def lpips_flops(net, side):
    """One image's trunk FLOPs (the distance runs it on both images)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        trunk = getattr(LPIPS(net), net)
        with FlopCounterMode(display=False) as fc:
            trunk(torch.zeros(1, 3, side, side))
    return fc.get_total_flops()


def vq_model(vq_cfg, state, device, dtype):
    model = VQModel(dataclasses.replace(vq_cfg, dtype=dtype), device=device)
    model.load_state_dict(state)
    return model.eval()


def check_tokenizer_parity(vq_cfg, state, frames, device):
    """The card against the CPU in fp32 (TF32 off) on 2 frames: latents and
    decoded images within 1e-4 relative L2 (cuDNN and the CPU sum in other
    orders). The bf16 path against the fp32 oracle on the card at VQ_B
    frames: latents and decoded images (of the oracle's ids) within 3e-2
    relative L2, the gate of the kernels' bf16 outputs; the LFQ bits equal
    wherever |z32| > 0.05 rms(z32) and on at least 99% of all bits; and
    `decode_tokens(encode(x).indices)` equal to `decode(encode(x).quantized)`
    in each dtype."""
    out = {}
    m32_cpu = vq_model(vq_cfg, state, "cpu", "float32")
    m32 = vq_model(vq_cfg, state, device, "float32")
    m16 = vq_model(vq_cfg, state, device, "bfloat16")
    x = torch.from_numpy(frames).to(device).float() / 127.5 - 1.0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        z_cpu = m32_cpu.encoder(x[:2].cpu().permute(0, 3, 1, 2))
        res_cpu = m32_cpu.quantizer(z_cpu.permute(0, 2, 3, 1), training=False)
        dec_cpu = m32_cpu.decode_tokens(res_cpu.indices)
        z_card = m32.encoder(x[:2].permute(0, 3, 1, 2))
        dec_card = m32.decode_tokens(res_cpu.indices.to(device))
        out["card_vs_cpu_fp32"] = {
            "z_rel_l2": rel_l2(z_card.cpu(), z_cpu),
            "decoded_rel_l2": rel_l2(dec_card.cpu(), dec_cpu)}
        del m32_cpu
        res32 = m32.encode(x)
        z32 = m32.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dec32 = m32.decode_tokens(res32.indices)
        same32 = torch.equal(m32.decode(res32.quantized), dec32)
    z16 = m16.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    res16 = m16.encode(x)
    dec16 = m16.decode_tokens(res32.indices)
    same16 = torch.equal(m16.decode(res16.quantized),
                         m16.decode_tokens(res16.indices))
    bits_equal = (z16 > 0) == (z32 > 0)
    confident = z32.abs() > 0.05 * z32.square().mean().sqrt()
    out["bf16_vs_fp32"] = {
        "z_rel_l2": rel_l2(z16, z32), "decoded_rel_l2": rel_l2(dec16, dec32),
        "bits_equal_share": float(bits_equal.float().mean()),
        "confident_bits": int(confident.sum()),
        "confident_bits_apart": int((~bits_equal & confident).sum()),
        "decode_tokens_equals_decode": {"float32": same32, "bfloat16": same16},
        "z32_rms": float(z32.square().mean().sqrt()),
        "ids_distinct": int(res32.indices.unique().numel())}
    c, b = out["card_vs_cpu_fp32"], out["bf16_vs_fp32"]
    if not (c["z_rel_l2"] <= 1e-4 and c["decoded_rel_l2"] <= 1e-4
            and b["z_rel_l2"] <= 3e-2 and b["decoded_rel_l2"] <= 3e-2
            and b["confident_bits_apart"] == 0
            and b["bits_equal_share"] >= 0.99 and same32 and same16):
        raise AssertionError(f"tokenizer parity: {out}")
    return out, m16


def check_tokenizer_speed(vq_cfg, m16, frames, device):
    """Encode and decode at VQ_B frames: ms a frame by CUDA events and by
    the profiler's device time, TFLOP/s and the share of the bf16 peak, the
    busy share and the largest kernels of one more call;
    the peak memory of a decode; LPIPS (alex) pairs a second at LPIPS_B
    pairs in fp32 with TF32 off and on."""
    x = torch.from_numpy(frames[:VQ_B]).to(device).float() / 127.5 - 1.0
    ids = m16.encode(x).indices
    enc_f, dec_f = vq_flops(vq_cfg)
    out = {"flops_per_frame": {"encode": enc_f, "decode": dec_f}}
    for name, fn, flops in (("encode", lambda: m16.encode(x), enc_f),
                            ("decode", lambda: m16.decode_tokens(ids), dec_f)):
        ms = time_ms(fn, iters=5, warmup=2) / VQ_B
        dev = device_ms(fn, iters=3)
        dev = dev / VQ_B if dev else None
        rate = tflops(flops, ms)
        prof = profile_device(fn, top=8)
        out[name] = {"ms_per_frame": ms, "device_ms_per_frame": dev,
                     "tflops": rate, "device_tflops": tflops(flops, dev),
                     "bf16_peak_share": rate / (PEAK_BF16_TENSOR / 1e12),
                     "busy_share": prof["busy_share"],
                     "device_ms_by_kind": prof["by_kind"], "top": prof["top"]}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m16.decode_tokens(ids)
    torch.cuda.synchronize()
    out["decode_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["decode_peak_above_resident_bytes"] = (
        torch.cuda.max_memory_allocated() - before)
    lp = LPIPS("alex", device=device).init_weights(
        torch.Generator(device=device).manual_seed(5)).eval()
    side = vq_cfg.resolution
    a = torch.from_numpy(synthetic_frames(LPIPS_B, side, 8)).to(device)
    b = torch.from_numpy(synthetic_frames(LPIPS_B, side, 9)).to(device)
    xa, xb = a.float() / 127.5 - 1.0, b.float() / 127.5 - 1.0
    out["lpips_alex"] = {"flops_per_pair": 2 * lpips_flops("alex", side)}
    for tag, tf32 in (("fp32", False), ("tf32", True)):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            ms = time_ms(lambda: lp(xa, xb), iters=10, warmup=2)
        out["lpips_alex"][f"{tag}_pairs_per_s"] = LPIPS_B / ms * 1e3
        out["lpips_alex"][f"{tag}_ms_per_batch"] = ms
    return out


def check_tokenizer(vq_cfg, cfg, device, root):
    """The tokenizer's inference path at `vq_cfg` (seeded random weights),
    in `root`, which holds the evaluation phase's GENIE checkpoint (`ckpt`),
    generate CLI output (`gen`) and synthetic token windows (`data`):
    `save_tokenizer` / `load_tokenizer` bitwise; `check_tokenizer_parity`;
    `check_tokenizer_speed`; the tokenize CLI over VQ_SEGMENTS segments of
    VQ_SEG_FRAMES synthetic frames (ids equal to `encode_frames`' on each
    segment, batched as the CLI batches; vocab
    2^z, the segments); the evaluate CLI on those windows at B = 16 with
    the tokenizer and random LPIPS (exact launches, one evaluator batch;
    `dec_time` and `pred_lpips` in its line; `pred_lpips` within 1e-4
    relative of the port's LPIPS on the CPU in fp32 on its saved frames);
    `evaluate_dataset` with decode and LPIPS over a full batch of B windows
    (its wall, gen_time, dec_time, busy share); `decode_latents_wrapper`
    over the generate CLI's video.bin against `decode_tokens` +
    `rescale_magvit_output`. Decode launches no kernel of the port."""
    t0 = time.perf_counter()
    side = vq_cfg.resolution
    g = torch.Generator(device=device).manual_seed(11)
    model = VQModel(vq_cfg, device=device).init_weights(g)
    save_tokenizer(root / "tok", model, vq_cfg)
    state, got_cfg = load_tokenizer(root / "tok")
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    if got_cfg != vq_cfg or set(state) != set(want) or not all(
            torch.equal(state[k], v) for k, v in want.items()):
        raise AssertionError("load_tokenizer is not save_tokenizer's model "
                             "bit for bit")
    del model
    n = VQ_SEGMENTS * VQ_SEG_FRAMES
    frames = synthetic_frames(n, side, 7)
    (root / "frames").mkdir()
    for s in range(VQ_SEGMENTS):
        np.save(root / "frames" / f"clip_{s}.npy",
                frames[s * VQ_SEG_FRAMES:(s + 1) * VQ_SEG_FRAMES])
    with torch.no_grad():
        out, m16 = check_tokenizer_parity(vq_cfg, state, frames[:VQ_B],
                                          device)
        print("tokenizer parity: " + json.dumps(out), flush=True)
        out["speed"] = check_tokenizer_speed(vq_cfg, m16, frames, device)
        print("tokenizer speed: " + json.dumps(out["speed"]), flush=True)

        tok = ["--tokenizer_ckpt", str(root / "tok")]
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            launches_of(lambda: tok_cli.main(tok + [
                "--frames", str(root / "frames"), "--output_dir",
                str(root / "tokens"), "--device", str(device)]), {}, 1,
                "tokenize CLI")
        wall = time.perf_counter() - t1
        video = RawTokenDataset(root / "tokens", window_size=1,
                                filter_interrupts=False)
        # segment by segment, as the CLI batches: a frame's ids can change
        # with its place in a batch (cuDNN's split of a product's sums)
        direct = np.concatenate([
            encode_frames(m16, frames[lo:lo + VQ_SEG_FRAMES], device=device)
            for lo in range(0, n, VQ_SEG_FRAMES)])
        rebatched = encode_frames(m16, frames, device=device)
        segments = np.asarray(video.segment_ids)
        if not (np.array_equal(np.asarray(video.data), direct)
                and video.metadata["vocab_size"] == vq_cfg.codebook_size
                and np.array_equal(np.bincount(segments),
                                   [VQ_SEG_FRAMES] * VQ_SEGMENTS)):
            raise AssertionError("tokenize CLI: video.bin, vocab_size or "
                                 "segments differ from encode_frames'")
        out["tokenize_cli"] = {
            "wall_s": wall, "frames_per_s": n / wall,
            "ids_apart_when_batched_whole": int((rebatched != direct).sum()),
            "log": buf.getvalue().splitlines()}

        buf = io.StringIO()
        saved = root / "eval_outputs"
        with contextlib.redirect_stdout(buf):
            _, launches = launches_of(lambda: ev_cli.main(tok + [
                "--val_data_dir", str(root / "tokens"), "--checkpoint_dir",
                str(root / "ckpt"), "--stride", "1", "--batch_size", str(B),
                "--lpips_ckpt", "random", "--save_outputs_dir", str(saved),
                "--device", str(device)]), EVAL_PER_LAYER, cfg.num_layers,
                "evaluate CLI with frame decode")
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        windows = VQ_SEGMENTS * (VQ_SEG_FRAMES // cfg.T)
        pred = np.load(saved / "pred_frames.npy")
        gtruth = np.load(saved / "gtruth_frames.npy")
        cpu_lpips = float(make_lpips_fn("random", device="cpu")(
            gtruth, pred).mean())
        lp_err = abs(result.get("pred_lpips", math.nan) - cpu_lpips
                     ) / cpu_lpips
        if not ({"loss", "acc", "gen_time", "dec_time", "pred_lpips",
                 "count"} <= result.keys() and result["count"] == windows
                and pred.shape == (windows, cfg.T - 1, side, side, 3)
                and lp_err <= 1e-4):
            raise AssertionError(f"evaluate CLI with frame decode printed "
                                 f"{result}; the CPU LPIPS {cpu_lpips}")
        out["evaluate_cli"] = dict(result=result, launches=launches,
                                   cpu_fp32_lpips=cpu_lpips,
                                   pred_lpips_rel_err=lp_err)

        ds = RawTokenDataset(root / "data", window_size=cfg.T, stride=1,
                             filter_overlaps=True)
        ev = GenieEvaluator(load_torch_checkpoint(root / "ckpt", cfg), cfg,
                            device=device, maskgit_steps=STEPS)
        decode = decode_latents_wrapper(str(root / "tok"), device=device)
        lpips_fn = make_lpips_fn("random", device=device)

        def batch():
            return evaluate_dataset(ev, ds, batch_size=B, max_examples=B,
                                    decode_latents=decode, lpips_fn=lpips_fn,
                                    verbose=False)
        res, launches = launches_of(batch, EVAL_PER_LAYER, cfg.num_layers,
                                    "evaluate_dataset with frame decode")
        s, walls = median_s(batch)
        busy = profile_device(batch)
        out["evaluator_batch"] = dict(
            wall_s=s, wall_s_runs=walls, results=res, launches=launches,
            decoded_frames=2 * B * (cfg.T - 1), lpips_pairs=B * (cfg.T - 1),
            busy={k: busy[k] for k in ("wall_ms", "device_ms", "busy_share",
                                       "top")})
        del ev

        gen = RawTokenDataset(root / "gen", window_size=1,
                              filter_interrupts=False)
        ids = np.asarray(gen.data).astype(np.int32)
        got = decode(ids)
        want = np.concatenate([rescale_magvit_output(m16.decode_tokens(
            torch.from_numpy(ids[lo:lo + B]).to(device))).cpu().numpy()
            for lo in range(0, len(ids), B)])
        if len(ids) % B or got.dtype != np.uint8 or got.shape != (
                len(ids), side, side, 3) or not np.array_equal(got, want):
            raise AssertionError(f"decode_latents_wrapper: {got.shape} "
                                 f"{got.dtype}, or not decode_tokens'")
        out["visualize"] = {"frames": len(ids)}
    out["phase_s"] = time.perf_counter() - t0
    return out


def check_evaluation(cfg, device):
    """The evaluation phase: scoring, the evaluator, the uncached paths and
    the CLIs at GENIE_138M (random weights from seed 0), the tokenizer's
    inference path at `VQ_CONFIG` (`check_tokenizer`), then the qk_norm
    evaluator at 8 layers."""
    g = torch.Generator(device=device).manual_seed(0)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    out = {}
    engine, out["scoring"] = check_scoring(model, cfg, device)
    print("evaluation scoring: " + json.dumps(out["scoring"]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ev, ds, out["evaluator"] = check_evaluator(model, cfg, device,
                                                   root / "data")
        print("evaluation evaluator: " + json.dumps(out["evaluator"]),
              flush=True)
        out["uncached"] = check_rows_and_full(engine, ev, cfg, ds, device)
        del engine, ev
        torch.cuda.empty_cache()
        print("evaluation uncached paths: " + json.dumps(out["uncached"]),
              flush=True)
        out["cli"] = check_clis(model, cfg, device, root)
        print("evaluation CLIs: " + json.dumps(out["cli"]), flush=True)
        out["tokenizer"] = check_tokenizer(VQ_CONFIG, cfg, device, root)
        print("tokenizer: " + json.dumps(
            {k: v for k, v in out["tokenizer"].items()
             if k not in ("bf16_vs_fp32", "card_vs_cpu_fp32", "speed")}),
            flush=True)
    del model
    torch.cuda.empty_cache()
    out["qk_norm_evaluator"] = check_qk_norm_evaluator(device)
    print("evaluation qk_norm evaluator: " + json.dumps(
        out["qk_norm_evaluator"]), flush=True)
    return out


# -------------------------------------------------------- training runtime

# one visualize call: the prefill of 8 frames, then 8 new frames of 2
# MaskGIT decodes and a commit each (generate_cached, unfused: no K3)
VIS_PER_LAYER = {"spatial_block": 1 + 24, "temporal_mlp_block": 24,
                 "temporal_attention": 1, "layer_norm": 1}
# the qk_norm step under remat: "attn_outs" keeps K9's output and lse, so
# the backward launches K10 alone; "none" runs K9 again; both run the MLP
# train block's forward again in the recompute
REMAT_QK = {"attn_outs": {"flash_mha": 1, "flash_mha_bwd": 1,
                          "mlp_train_block": 2, "mlp_train_block_bwd": 1},
            "none": {"flash_mha": 2, "flash_mha_bwd": 1,
                     "mlp_train_block": 2, "mlp_train_block_bwd": 1}}
# with attn_drop and mlp_drop above 0 both attention sub-layers run op by
# op (K9 and K10 on the spatial axis) and the MLP is plain
DROPOUT_PER_LAYER = {"flash_mha": 1, "flash_mha_bwd": 1}
RT_UPDATES, RT_ACCUMULATE, RT_EVAL_BATCHES, RT_LR = 6, 2, 2, 2e-5
RT_CONFIG = Path(__file__).resolve().parent / "configs" / "genie_138m.json"


def instrumented_cli(argv, profile_updates=None):
    """`tpu1x_torch.train.train.main(argv)` with its train step, eval and
    visualize wrapped: the launch counters are set to 0 just before each
    micro-batch, eval and visualize call and read just after; the card is
    synchronized at the start of every update (the host clock there gives
    each update's wall, the loop's own work included); with
    `profile_updates` (a, b), torch.profiler runs from the start of update
    a to the start of update b. The `step_3` save snapshots the state on
    the host first. Returns the records, the train step's `TrainState`
    and the printed lines."""
    rec = dict(micro=[], evals=[], vis=[], losses=[], starts={}, snaps={},
               state=None, prof=None)
    real = (train_cli.make_train_step, train_cli.run_eval,
            train_cli.visualize, train_cli.Checkpointer)

    class Snapshotting(real[3]):
        def save(self, state, name, wait=False):
            if name == "step_3":
                rec["snaps"][name] = {
                    k: v.detach().cpu().clone()
                    for k, v in _state_tensors(state).items()}
            return super().save(state, name, wait)

    def make(*a, **kw):
        step = real[0](*a, **kw)
        rec["state"] = step.state

        def counted(*sa, **skw):
            opt = step.state.optimizer
            if opt.micro == 0:  # an update starts
                torch.cuda.synchronize()
                n = opt.updates + 1
                rec["starts"][n] = time.perf_counter()
                if profile_updates and n == profile_updates[0]:
                    from torch.profiler import ProfilerActivity, profile
                    rec["prof"] = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    rec["prof"].start()
                if profile_updates and n == profile_updates[1]:
                    rec["prof"].stop()
            kernels.reset_launches()
            m = step(*sa, **skw)
            rec["micro"].append(dict(kernels.LAUNCHES))
            rec["losses"].append(m["loss"])
            return m
        counted.state = step.state
        return counted

    def run_eval(*a, **kw):
        kernels.reset_launches()
        out = real[1](*a, **kw)
        torch.cuda.synchronize()
        rec["evals"].append(dict(kernels.LAUNCHES))
        return out

    def visualize(*a, **kw):
        kernels.reset_launches()
        out = real[2](*a, **kw)
        torch.cuda.synchronize()
        rec["vis"].append(dict(kernels.LAUNCHES))
        return out

    train_cli.make_train_step, train_cli.run_eval = make, run_eval
    train_cli.visualize, train_cli.Checkpointer = visualize, Snapshotting
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            train_cli.main(argv)
        torch.cuda.synchronize()
        rec["starts"]["end"] = time.perf_counter()
    finally:
        (train_cli.make_train_step, train_cli.run_eval, train_cli.visualize,
         train_cli.Checkpointer) = real
    rec["stdout"] = buf.getvalue().splitlines()
    return rec


def cli_launch_gates(rec, cfg, what):
    """Exact launches of every micro-batch, eval and visualize call."""
    L = cfg.num_layers
    want = expected_launches(TRAIN_PER_LAYER, L)
    bad = [i for i, got in enumerate(rec["micro"]) if got != want]
    if bad:
        raise AssertionError(f"{what}: micro-batches {bad} launched "
                             f"{rec['micro'][bad[0]]}, expected {want}")
    want_eval = expected_launches(
        {k: RT_EVAL_BATCHES * v for k, v in LOGITS_PER_LAYER.items()}, L)
    want_vis = expected_launches(VIS_PER_LAYER, L)
    if any(e != want_eval for e in rec["evals"]) or any(
            v != want_vis for v in rec["vis"]):
        raise AssertionError(f"{what}: evals {rec['evals']} (expected "
                             f"{want_eval}), visualize {rec['vis']} "
                             f"(expected {want_vis})")
    return {k: RT_ACCUMULATE * v for k, v in want.items()}


def state_params(state):
    return {k: v.detach().float().cpu()
            for k, v in full_state_dict(state.model).items()}


def check_cli_run(cfg, device, root):
    """Phases 1 to 3 of the runtime: the CLI at GENIE_138M, its resume and
    its exports (see `check_training_runtime`)."""
    ds = synthetic_dataset(cfg, root / "data")
    common = ["--train_data_dir", str(root / "data"), "--val_data_dir",
              str(root / "data"), "--genie_config", str(RT_CONFIG),
              "--device", str(device), "--window_size", str(cfg.T), "--stride", "1",
              "--overfit_first_batch", "--per_device_train_batch_size",
              str(TB), "--gradient_accumulation_steps", str(RT_ACCUMULATE),
              "--max_train_steps", str(RT_UPDATES), "--checkpointing_steps",
              "3", "--eval_every_n_steps", "3", "--max_eval_steps",
              str(RT_EVAL_BATCHES), "--vis_every_n_steps", str(RT_UPDATES),
              "--learning_rate", str(RT_LR), "--lr_scheduler_type",
              "constant", "--seed", "0", "--report_to", "jsonl",
              "--tokenizer_ckpt", str(root / "tok"), "--lpips_ckpt", "random"]
    g = torch.Generator(device=device).manual_seed(11)
    save_tokenizer(root / "tok", VQModel(VQ_CONFIG, device=device)
                   .init_weights(g), VQ_CONFIG)
    out1, out2 = root / "run", root / "resumed"
    rec = instrumented_cli(common + ["--output_dir", str(out1)])
    per_update = cli_launch_gates(rec, cfg, "train CLI")
    state1 = rec["state"]
    if not (state1.optimizer.updates == RT_UPDATES and len(rec["evals"]) == 2
            and len(rec["vis"]) == 1 and len(rec["micro"]) ==
            RT_UPDATES * RT_ACCUMULATE):
        raise AssertionError(f"train CLI: {state1.optimizer.updates} "
                             f"updates, {len(rec['evals'])} evals, "
                             f"{len(rec['vis'])} visualize calls")
    losses = [float(x) for x in rec["losses"]]
    per_upd = [sum(losses[i:i + RT_ACCUMULATE]) / RT_ACCUMULATE
               for i in range(0, len(losses), RT_ACCUMULATE)]
    if not (all(math.isfinite(x) for x in losses)
            and per_upd[-1] < per_upd[0]):
        raise AssertionError(f"train CLI losses by update {per_upd}")
    logged = [json.loads(x) for x in
              (out1 / "metrics.jsonl").read_text().splitlines()]
    if not (any("train_loss" in x for x in logged)
            and sum("eval_loss" in x for x in logged) == 2):
        raise AssertionError(f"metrics.jsonl: {logged[1:]}")
    vis = RawTokenDataset(out1 / f"vis_step_{RT_UPDATES}", window_size=1,
                          filter_interrupts=False)
    n, side, half = 4, cfg.latent_side_len, cfg.T // 2
    stream = np.asarray(vis.data).reshape(n, cfg.T + half, side, side)
    truth = RawTokenDataset(root / "data", window_size=cfg.T,
                            stride=1).get_batch(np.arange(n))
    if not (np.array_equal(stream[:, :half], truth[:, :half])
            and np.array_equal(stream[:, cfg.T:], truth[:, half:])
            and int(stream.max()) < cfg.image_vocab_size):
        raise AssertionError("vis_step_6/video.bin does not hold [prompt | "
                             "predicted | ground truth]")
    # the decoded figure: each window's generated row above its ground truth
    figures = sorted((out1 / f"vis_step_{RT_UPDATES}").glob(
        "pred_vs_gtruth.*"))
    if not figures:
        raise AssertionError("visualize wrote no pred_vs_gtruth figure")
    figure = figures[0]
    if figure.suffix == ".png":
        from PIL import Image
        grid = np.asarray(Image.open(figure))
    else:
        grid = np.load(figure)
    px = VQ_CONFIG.resolution
    lpips_lines = [x for x in rec["stdout"] if "train-time lpips" in x]
    if grid.shape != (n * 2 * px, half * px, 3) or not lpips_lines:
        raise AssertionError(f"visualize: {figure.name} of {grid.shape}, "
                             f"lpips lines {lpips_lines}")
    starts = rec["starts"]
    # updates 2, 4 and 5 run with no checkpoint, eval or visualize inside
    walls = [starts[k + 1] - starts[k] for k in (2, 4, 5)]
    s_update = sorted(walls)[1]

    # the resume: the saved state bit for bit, then updates 4 to 6
    saved = rec["snaps"]["step_3"]
    run_cfg = GenieConfig.from_pretrained(out1 / "step_3_hf")
    fresh = STMaskGIT(run_cfg, device=device)
    state = TrainState(0, fresh, TrainOptimizer(
        fresh, run_cfg, RT_LR, lr_scheduler_type="constant",
        num_training_steps=RT_UPDATES,
        gradient_accumulation_steps=RT_ACCUMULATE),
        torch.Generator(device=device))
    Checkpointer(out1).restore("step_3", state)
    got = {k: v.detach().cpu() for k, v in _state_tensors(state).items()}
    differ = sorted(k for k in saved if k not in got
                    or not torch.equal(got[k], saved[k]))
    if differ or set(got) != set(saved):
        raise AssertionError(f"restore of step_3 differs in {differ[:5]}")
    del fresh, state, got
    rec2 = instrumented_cli(common + [
        "--output_dir", str(out2), "--resume_from_checkpoint",
        str(out1 / "step_3")], profile_updates=(4, 6))
    cli_launch_gates(rec2, cfg, "resumed train CLI")
    if not (any("resumed from step_3" in x for x in rec2["stdout"])
            and rec2["state"].optimizer.updates == RT_UPDATES
            and len(rec2["micro"]) == 3 * RT_ACCUMULATE):
        raise AssertionError(f"resume: {rec2['stdout'][:3]}, "
                             f"{rec2['state'].optimizer.updates} updates")
    prof_wall = rec2["starts"][6] - rec2["starts"][4]
    busy = device_summary(rec2["prof"], prof_wall)
    s3 = {k[len("model/"):]: v.float() for k, v in saved.items()
          if k.startswith("model/")}
    fin1, fin2 = state_params(state1), state_params(rec2["state"])
    names = sorted(s3)
    d1 = torch.cat([(fin1[k] - s3[k]).reshape(-1) for k in names])
    d2 = torch.cat([(fin2[k] - s3[k]).reshape(-1) for k in names])
    delta = rel_l2(d2, d1)
    worst = sorted(((rel_l2(fin2[k] - s3[k], fin1[k] - s3[k]), k)
                    for k in names), reverse=True)[:3]
    if not delta <= 2e-2:
        raise AssertionError(f"resumed update: relative L2 {delta} from the "
                             f"uninterrupted run's; worst {worst}")

    # the exports of the uninterrupted run, read back by the port
    final = out1 / "final_checkpt_hf"
    model_sd = {k: v.detach().cpu()
                for k, v in full_state_dict(state1.model).items()}
    for name, sd in (("model.safetensors",
                      load_torch_checkpoint(final, run_cfg)),
                     ("params.msgpack", load_pretrained(final)[0])):
        if set(sd) != set(model_sd) or not all(
                torch.equal(sd[k], v) for k, v in model_sd.items()):
            raise AssertionError(f"{name} is not the model bit for bit")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, eval_launches = launches_of(
            lambda: ev_cli.main([
                "--val_data_dir", str(root / "data"), "--checkpoint_dir",
                str(final), "--stride", "1", "--batch_size", str(B),
                "--max_examples", str(B), "--device", str(device)]),
            EVAL_PER_LAYER, cfg.num_layers, "evaluate CLI on the export")
    evaluated = json.loads(buf.getvalue().strip().splitlines()[-1])
    if not evaluated.get("count") == B:
        raise AssertionError(f"evaluate CLI on the export: {evaluated}")
    del ds
    return dict(
        launches_per_update=per_update, eval_launches=rec["evals"][0],
        visualize_launches=rec["vis"][0], losses_by_update=per_upd,
        update_walls_s=walls, s_per_update=s_update,
        examples_per_s=TB * RT_ACCUMULATE / s_update,
        busy_updates_4_5={k: busy[k] for k in ("wall_ms", "device_ms",
                                               "busy_share", "top")},
        resumed_update_rel_l2=delta, resumed_worst_params=worst,
        metrics_logged=logged[1:], evaluate_cli=evaluated,
        decoded_figure=[figure.name, list(grid.shape)],
        train_time_lpips=lpips_lines,
        evaluate_cli_launches=eval_launches)


def check_world_size_one(device):
    """One process group of world size 1 over NCCL: one update of
    GENIE_138M (B = CB, full depth) through DDP and one through FSDP2,
    each against the unwrapped step from the same weights, batch and
    draws: exact launch counts, the loss (within 2e-2), the gradient norm
    (5e-2 relative) and each parameter's update (within 3e-2 relative L2,
    the step gates); no warning of DDP about gradient strides (the fused
    blocks return weight gradients through transposed views). Then an FSDP2
    `Checkpointer` save and restore into a fresh sharded state, bit for
    bit."""
    import warnings
    cfg = genie_138m()
    g = torch.Generator(device=device).manual_seed(4)
    model0 = STMaskGIT(cfg, device=device).init_weights(g)
    init = {k: v.clone() for k, v in model0.state_dict().items()}
    del model0
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (CB, cfg.T, side, side),
                           generator=g, device=device)
    noise = draw_noise(tokens.shape, cfg, g, device)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if not init_distributed(str(device), f"tcp://localhost:{port}", 1, 0):
        raise AssertionError("a process group existed already")
    out, updates = {}, {}
    try:
        for mode in ("plain", "ddp", "fsdp"):
            m = STMaskGIT(cfg, device=device)
            m.load_state_dict(init)
            state = TrainState(0, m, TrainOptimizer(
                m, cfg, learning_rate=TRAIN_LR, max_grad_norm=1.0),
                torch.Generator(device=device).manual_seed(5))
            if mode != "plain":
                state = shard_train_state(state, device, fsdp=mode == "fsdp")
            step = make_train_step(state.model, state.optimizer, cfg,
                                   device=device, generator=state.generator)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r, launches = launches_of(
                    lambda: step(tokens, noise=noise), TRAIN_PER_LAYER,
                    cfg.num_layers, f"{mode} step")
            strides = [str(w.message)[:200] for w in caught
                       if "stride" in str(w.message).lower()]
            if strides:
                raise AssertionError(f"{mode}: {strides}")
            out[mode] = {k: float(v) for k, v in r.items()}
            updates[mode] = {k: v.detach().float() - init[k].float()
                             for k, v in full_state_dict(
                                 state.model).items()}
            if mode == "fsdp":
                out["fsdp_checkpoint"] = fsdp_round_trip(state, cfg, device)
            del step, state, m
        for mode in ("ddp", "fsdp"):
            per = {k: rel_l2(updates[mode][k], updates["plain"][k])
                   for k in updates["plain"]}
            worst = max(per.items(), key=lambda kv: kv[1])
            out[mode + "_worst_update_rel_l2"] = worst
            got, want = out[mode], out["plain"]
            if not (worst[1] <= 3e-2
                    and abs(got["loss"] - want["loss"]) <= 2e-2
                    and abs(got["grad_norm"] / want["grad_norm"] - 1)
                    <= 5e-2):
                raise AssertionError(f"{mode} against the unwrapped step: "
                                     f"{out}")
    finally:
        torch.distributed.destroy_process_group()
    return out


def fsdp_round_trip(state, cfg, device):
    """Save the sharded state and restore it into a fresh one: every local
    shard, moment, counter and the generator bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp)
        ckpt.save(state, "fsdp", wait=True)
        saved = {k: (v.to_local() if hasattr(v, "to_local") else v).clone()
                 for k, v in _state_tensors(state).items()}
        m = STMaskGIT(cfg, device=device)
        fresh = shard_train_state(TrainState(0, m, TrainOptimizer(
            m, cfg, learning_rate=TRAIN_LR, max_grad_norm=1.0),
            torch.Generator(device=device)), device, fsdp=True)
        ckpt.restore("fsdp", fresh)
        got = {k: v.to_local() if hasattr(v, "to_local") else v
               for k, v in _state_tensors(fresh).items()}
    differ = [k for k in saved if k not in got
              or not torch.equal(got[k], saved[k])]
    if differ or set(got) != set(saved):
        raise AssertionError(f"FSDP2 restore differs in {differ[:5]}")
    return {"tensors": len(saved), "bitwise": True}


def check_remat(device):
    """The train step at GENIE_138M (B = TB, full depth) under remat:
    `qk_norm=True` with remat off, "attn_outs" and "none", and pre-LN with
    remat off and "attn_outs". Each: exact launch counts of one forward and
    backward, every parameter's gradient against its model's remat-off
    gradient from the same weights and batch (the gradient gates of
    `check_step_against_plain`: 3e-2 relative L2 per parameter and over
    all), the peak memory and the median of three step times after one
    untimed (`make_train_step`, AdamW included)."""
    cases = (("qk_norm", None), ("qk_norm", "attn_outs"), ("qk_norm", "none"),
             ("pre_ln", None), ("pre_ln", "attn_outs"))
    out, grads = {}, {}
    for arch, policy in cases:
        cfg = genie_138m(qk_norm=arch == "qk_norm", remat=policy is not None,
                         remat_policy=policy or "attn_outs")
        per_layer = (TRAIN_PER_LAYER if arch == "pre_ln" else
                     REMAT_QK.get(policy, TRAIN_PER_LAYER_QK))
        g = torch.Generator(device=device).manual_seed(0)
        model = STMaskGIT(cfg, device=device).init_weights(g)
        side = cfg.latent_side_len
        tokens = torch.randint(0, cfg.image_vocab_size,
                               (TB, cfg.T, side, side), generator=g,
                               device=device)
        noise = draw_noise(tokens.shape, cfg, g, device)
        batch = maskgit_corrupt(tokens, noise, cfg)

        def forward_backward():
            out_ = model.train()(batch["input_ids"], batch["labels"])
            out_["loss"].backward()
        _, launches = launches_of(forward_backward, per_layer,
                                  cfg.num_layers, f"{arch} remat {policy}")
        grads[arch, policy] = {n: p.grad.detach().cpu()
                               for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        step = make_train_step(model, TrainOptimizer(
            model, cfg, learning_rate=TRAIN_LR, max_grad_norm=1.0), cfg,
            device=device)
        step(tokens, noise=noise)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(tokens, noise=noise)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        key = f"{arch}_{policy or 'off'}"
        out[key] = dict(peak_memory_bytes=torch.cuda.max_memory_allocated(),
                        step_s=sorted(walls)[1], step_s_runs=walls,
                        launches=launches)
        del step, model, batch
        torch.cuda.empty_cache()
        if policy is not None:
            off = grads[arch, None]
            per = {n: rel_l2(v, off[n]) for n, v in grads[arch, policy].items()}
            flat = rel_l2(torch.cat([v.reshape(-1) for v in
                                     grads[arch, policy].values()]),
                          torch.cat([off[n].reshape(-1) for n in
                                     grads[arch, policy]]))
            worst = max(per.items(), key=lambda kv: kv[1])
            out[key].update(grads_rel_l2=flat, worst_param=worst)
            if not (flat <= 3e-2 and worst[1] <= 3e-2):
                raise AssertionError(f"{key}: gradients against remat off: "
                                     f"{flat}, worst {worst}")
            del grads[arch, policy]
    return out


def check_dropout(device, layers=8):
    """GENIE_138M at `layers` layers with attn_drop = mlp_drop = 0.1: one
    forward and backward through the kernels (exact launch counts: K9 and
    K10 on every layer and nothing else) and through the plain path, with
    the same dropout seed, by `check_step_against_plain`'s gates. The
    kernel path runs under the default remat ("attn_outs": K9's output and
    lse kept, the masks drawn again in the rerun); the plain and fp32 runs
    without remat, so a fault in the mask replay shows against them."""
    cfg = genie_138m(num_layers=layers, attn_drop=0.1, mlp_drop=0.1)
    model = STMaskGIT(cfg, device=device).init_weights(
        torch.Generator(device=device).manual_seed(6))
    return check_step_against_plain(model, cfg, device, DROPOUT_PER_LAYER,
                                    dropout_seed=7)


def check_training_runtime(cfg, device, bare_step_s):
    """The training runtime (`tpu1x_torch.train`), in a temporary directory
    that it removes: the CLI at GENIE_138M, its resume and exports
    (`check_cli_run`), DDP and FSDP2 at world size 1
    (`check_world_size_one`), remat (`check_remat`) and dropout
    (`check_dropout`)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["cli"] = check_cli_run(cfg, device, Path(tmp))
        out["cli"]["phase_s"] = time.perf_counter() - t0
    # the bare step at B = TB takes one micro-batch and one AdamW update
    out["cli"]["bare_step_s"] = bare_step_s
    out["cli"]["overhead_s_per_update"] = (
        out["cli"]["s_per_update"] - RT_ACCUMULATE * bare_step_s)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["world_size_one"] = check_world_size_one(device)
    out["world_size_one"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["remat"] = check_remat(device)
    out["remat"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dropout"] = check_dropout(device)
    out["dropout"]["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        t_start = time.perf_counter()
        device = torch.device("cuda")
        card = card_line()
        print(f"card: {card}", flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)

        t0 = time.perf_counter()
        logs = kernels.build_all(verbose=True)
        secs = time.perf_counter() - t0
        print(f"build: {secs:.1f} s for {len(logs)} sources", flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if ("registers" in line or "spill" in line
                        or "Function properties" in line):
                    print(f"ptxas {name}: {line.strip()}")

        cfg = genie_138m()
        t0 = time.perf_counter()
        results = check_kernels(cfg.d_model, cfg.num_heads, cfg.num_layers,
                                device)
        print("decode attention across batch sizes: " + json.dumps(
            check_decode_batches(cfg.d_model, cfg.num_heads, device)),
            flush=True)
        print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        roll = check_rollout(cfg, device)
        print("rollout: " + json.dumps(roll), flush=True)
        print(f"rollout phase: {time.perf_counter() - t0:.1f} s; "
              f"{roll['s_per_frame']:.4f} s/frame at B={B} on {card}",
              flush=True)

        t0 = time.perf_counter()
        results.update(check_train_kernels(cfg.d_model, cfg.num_heads,
                                           device))
        print(f"train kernel checks: {time.perf_counter() - t0:.1f} s",
              flush=True)
        print("first card call of a new thread: " + json.dumps(
            check_fresh_thread(Inputs(3, device), cfg.d_model,
                               cfg.num_heads)), flush=True)

        t0 = time.perf_counter()
        model, train = check_training(cfg, device)
        print("training: " + json.dumps(train), flush=True)
        print(f"training phase: {time.perf_counter() - t0:.1f} s; "
              f"{train['step_s']:.4f} s/step, "
              f"{train['tokens_per_s']:.0f} tokens/s, peak "
              f"{train['peak_memory_bytes'] / 2**30:.2f} GiB at B={TB} on "
              f"{card}", flush=True)
        t0 = time.perf_counter()
        print("train step against the plain path: " + json.dumps(
            check_step_against_plain(model, cfg, device)), flush=True)
        print(f"plain-path comparison: {time.perf_counter() - t0:.1f} s",
              flush=True)
        del model
        torch.cuda.empty_cache()

        # ---- the op-by-op paths: qk_norm=True and the int8 cache
        t0 = time.perf_counter()
        results.update(check_op_path_kernels(cfg.d_model, cfg.num_heads,
                                             cfg.num_layers, device))
        print(f"op-path kernel checks: {time.perf_counter() - t0:.1f} s",
              flush=True)
        cfg_qk = genie_138m(qk_norm=True)
        t0 = time.perf_counter()
        roll_qk = check_rollout(cfg_qk, device, "int8", PER_LAYER_QK)
        print("rollout qk_norm int8: " + json.dumps(roll_qk), flush=True)
        print(f"rollout qk_norm int8 phase: {time.perf_counter() - t0:.1f} s; "
              f"{roll_qk['s_per_frame']:.4f} s/frame at B={B} on {card}",
              flush=True)
        t0 = time.perf_counter()
        for label, c, cache_dtype, per_layer in (
                ("qk_norm bf16", genie_138m(qk_norm=True, num_layers=8),
                 "bf16", PER_LAYER_QK),
                ("int8", genie_138m(num_layers=8), "int8", PER_LAYER_INT8)):
            print(f"rollout {label}, 8 layers: " + json.dumps(
                check_rollout(c, device, cache_dtype, per_layer, full=False)),
                flush=True)
        print(f"8-layer rollouts: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        print("action conditioning, 8 layers: " + json.dumps(
            check_action_conditioning(device)), flush=True)
        print(f"action conditioning: {time.perf_counter() - t0:.1f} s",
              flush=True)

        # the qk_norm step as it was before remat (check_remat has remat)
        cfg_qk_step = genie_138m(qk_norm=True, remat=False)
        t0 = time.perf_counter()
        model, train_qk = check_training(cfg_qk_step, device,
                                         TRAIN_PER_LAYER_QK)
        print("training qk_norm: " + json.dumps(train_qk), flush=True)
        print(f"training qk_norm phase: {time.perf_counter() - t0:.1f} s; "
              f"{train_qk['step_s']:.4f} s/step, "
              f"{train_qk['tokens_per_s']:.0f} tokens/s, peak "
              f"{train_qk['peak_memory_bytes'] / 2**30:.2f} GiB at B={TB} on "
              f"{card}", flush=True)
        t0 = time.perf_counter()
        print("qk_norm train step against the plain path: " + json.dumps(
            check_step_against_plain(model, cfg_qk_step, device,
                                     TRAIN_PER_LAYER_QK)), flush=True)
        print(f"qk_norm plain-path comparison: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del model
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        results.update(check_eval_kernels(cfg.d_model, cfg.num_heads,
                                          cfg.num_layers, device))
        evaluation = check_evaluation(cfg, device)
        ev_res, sc_res = evaluation["evaluator"], evaluation["scoring"]
        print(f"evaluation phase: {time.perf_counter() - t0:.1f} s; "
              f"gen_time {ev_res['gen_time']:.6f} s/frame (the reference's "
              f"quantity: a batch's wall over (T-1) x B = "
              f"{ev_res['frames_per_batch']} frames, B={B}); "
              f"score_policies {sc_res['policies_per_s']:.1f} policies/s "
              f"({NP} policies, {CTX} + {cfg.T - CTX} frames) on {card}",
              flush=True)
        eval_launches = {
            "score_policies": sc_res["launches"],
            "evaluate_dataset": ev_res["launches"],
            "evaluator_rows": evaluation["uncached"]["rows_launches"],
            "full_rollout": evaluation["uncached"]["full_launches"],
            "evaluate_cli": evaluation["cli"]["evaluate_launches"],
            "generate_cli": evaluation["cli"]["generate_launches"],
            "qk_norm_evaluator": evaluation["qk_norm_evaluator"]["launches"],
            "evaluate_cli_decoded":
                evaluation["tokenizer"]["evaluate_cli"]["launches"],
            "evaluate_dataset_decoded":
                evaluation["tokenizer"]["evaluator_batch"]["launches"]}
        tok = evaluation["tokenizer"]
        sp, eb = tok["speed"], tok["evaluator_batch"]
        print(f"tokenizer phase: {tok['phase_s']:.1f} s; at B={VQ_B} encode "
              f"{sp['encode']['ms_per_frame']:.4f} ms/frame (device "
              f"{sp['encode']['device_ms_per_frame']}), "
              f"{sp['encode']['tflops']:.1f} TFLOP/s "
              f"({sp['encode']['bf16_peak_share']:.3f} of the bf16 peak); "
              f"decode {sp['decode']['ms_per_frame']:.4f} ms/frame (device "
              f"{sp['decode']['device_ms_per_frame']}), "
              f"{sp['decode']['tflops']:.1f} TFLOP/s "
              f"({sp['decode']['bf16_peak_share']:.3f}); decode peak "
              f"{sp['decode_peak_memory_bytes']} B; LPIPS alex "
              f"{sp['lpips_alex']['fp32_pairs_per_s']:.1f} pairs/s fp32, "
              f"{sp['lpips_alex']['tf32_pairs_per_s']:.1f} with TF32; "
              f"evaluator batch with decode {eb['wall_s']:.4f} s, gen_time "
              f"{eb['results']['gen_time']:.6f}, dec_time "
              f"{eb['results']['dec_time']:.6f} s/frame, busy "
              f"{eb['busy']['busy_share']:.3f}; tokenize CLI "
              f"{tok['tokenize_cli']['frames_per_s']:.1f} frames/s on {card}",
              flush=True)

        t0 = time.perf_counter()
        runtime = check_training_runtime(cfg, device, train["step_s"])
        rt_cli = runtime["cli"]
        print("training runtime: " + json.dumps(runtime), flush=True)
        print(f"training runtime phase: {time.perf_counter() - t0:.1f} s; "
              f"the train CLI {rt_cli['s_per_update']:.4f} s/update "
              f"({TB} x {RT_ACCUMULATE} examples, "
              f"{rt_cli['examples_per_s']:.1f} examples/s; the bare step "
              f"{rt_cli['bare_step_s']:.4f} s at B={TB}), busy "
              f"{rt_cli['busy_updates_4_5']['busy_share']:.3f} over two "
              f"updates; remat peaks " + ", ".join(
                  f"{k} {v['peak_memory_bytes']} B {v['step_s']:.4f} s"
                  for k, v in runtime["remat"].items()
                  if isinstance(v, dict)) + f" on {card}", flush=True)

        line = []
        for name in SOURCES:
            # spatial_block is reported at the single-frame decode shape,
            # the one with the most launches. `launches` is the count of
            # the path that the kernel first served (the rollout for the
            # serving kernels, the train step for the training kernels);
            # `train_launches` is the train step's count for all of them.
            # The decode attention kernels and the fused attention pair are
            # counted on the qk_norm paths; the former also carry their
            # int8-cache time, and every kernel its counts on those paths.
            r = results[f"{name}[N={B}]" if name == "spatial_block" else name]
            source, replaces = SOURCES[name]
            path = (roll if name in PER_LAYER else roll_qk
                    if name in PER_LAYER_QK else train_qk
                    if name.startswith("flash_mha") else train)
            item = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path["launches"][name],
                "train_launches": train["launches"][name],
                "qk_norm_int8_rollout_launches": roll_qk["launches"][name],
                "qk_norm_train_launches": train_qk["launches"][name],
                "eval_launches": {k: v[name]
                                  for k, v in eval_launches.items()},
                "train_cli_launches": {
                    "update": rt_cli["launches_per_update"][name],
                    "eval": rt_cli["eval_launches"][name],
                    "visualize": rt_cli["visualize_launches"][name]},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            # profiler device times, where the check took them (K1, K5,
            # K7-K10), and K10's floor with its residuals
            item.update({k: r[k] for k in ("device_ms", "library_device_ms",
                                           "own_floor_ms") if k in r})
            if name + "[int8]" in results:  # the decode attention kernels
                q8 = results[name + "[int8]"]
                item.update(int8_ms=q8["ms"], int8_device_ms=q8["device_ms"],
                            int8_bound_ms=q8["bound_ms"])
                for tag, res in (("", r), ("int8_", q8)):
                    item.update({f"{tag}rollout_{k}": res["rollout"][k]
                                 for k in ("device_ms", "bound_ms")})
            line.append(item)
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"kernels": line}), flush=True)
        print(card, flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
