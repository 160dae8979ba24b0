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
   backward, causal and not. Outputs within atol = rtol = 3e-2 (the
   three train blocks' by `held_to_plain`, with an fp32 run beside them:
   ROADMAP C11); every
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
   seeded actions, and muP (`check_mup`), at 8 layers of GENIE_138M with
   use_mup (width_mult 2: the attention scale 8 / head_dim, the head's
   input divided by 2; the step's optimizer with muP's learning rate for
   the hidden matrices): each the rollout of 4 (launch counts, the prefill
   cache and the step-0 logits against the plain path), one
   `make_train_step` step through the kernels and through the plain train
   blocks (launch counts, loss, gradient norm), and the step's gradients
   as in 6 (`check_variant`).
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
10. The tokenizer's GAN training (`check_tokenizer_training`; the launch
   counters set to 0 at its start must read 0 at its end): the card's fp32
   step (TF32 off) against the CPU's at 64 px (base 32, ch_mult (1, 2, 2,
   4), z 18, B = 4, `disc_start` 1, three micro-steps, seeded weights and
   random VGG-LPIPS): the card's first step as it is (metrics within 1e-4,
   the latents' cotangent within 1e-3), LPIPS's gradient (2e-3), then
   three micro-steps without LPIPS from the CPU's latent cotangents (the
   first step's metrics and every gradient within 1e-4, then metrics 1e-3,
   updates 1e-2, statistics, LeCam and EMA 1e-4); bf16 against fp32 at
   `VQ_CONFIG`, B = 2, one step (losses within 3e-2, each parameter
   group's gradient within 5e-2 relative L2); at `VQ_CONFIG` and B = 8
   s/step (median of 8 after 2), images/s, peak memory, device time by
   kind and busy share over two profiled steps, LPIPS's forward and
   backward, the same step with `gen_loss_weight` 0.8; the train_tokenizer
   CLI on 16 frames (B 8, 4 micro-steps, accumulation 2), its output loaded
   and decoded.
11. The training runtime (`check_training_runtime`), in a temporary
   directory it removes: the train CLI (`tpu1x_torch.train.train.main`) on
   configs/genie_138m.json cut to 8 layers (GENIE_35M's and the head_dim-64
   phases run theirs at 8 layers too) over a synthetic dataset
   (`--overfit_first_batch`, B=8, accumulation 2, 6 updates, a checkpoint
   and an eval at 3, visualize at 6 with `--tokenizer_ckpt` and
   `--lpips_ckpt random`) with exact launch counts per micro-batch, eval
   and visualize call, a falling loss, metrics.jsonl and vis_step_6 read
   back (its decoded `pred_vs_gtruth` figure, (4 x 2 x 256, 8 x 256, 3),
   and the printed train-time lpips), its s/update (GENIE_35M's beside two
   bare steps) and the busy share over two updates; `Checkpointer.restore`
   of step_3 bit for
   bit and a resumed run to step 6 whose update from step 3 is within 2e-2
   relative L2 of the uninterrupted run's; both exports of
   final_checkpt_hf read back bit for bit, and the evaluate CLI on them;
   one process group of world size 1 over NCCL, one update through DDP
   and one through FSDP2 against the unwrapped step (at 8 layers), and an
   FSDP2 checkpoint round trip; remat (qk_norm off / "attn_outs" / "none",
   pre-LN off / "attn_outs") with launch counts, peak memory, step time
   and gradients against remat off; dropout at 8 layers through the
   kernels and the plain path with one seed.
12. GENIE_35M, the reference's shipped config (`check_genie_35m`):
   configs/genie_35m.json through `GenieConfig.from_pretrained` at full
   depth and width (32 layers, C = 256, 8 heads, bf16), seeded random
   weights: the rollout as in 4, ten train steps and the step against the
   plain path as in 6; at 8 layers `score_policies` and `evaluate_dataset`
   at B = 16 as in 9, and the train CLI on the JSON cut so with its resume
   and exports as in 11; each with exact launch counts, its wall and its
   device time by kernel.
12b. Head_dim 64 (`check_head_dim_64`): every attention kernel form at
   head_dim 64 (C = 512, 8 heads) against its plain version, values and
   gradients, with its times (`check_h64_kernels`: K1 both modes at N =
   16 / 32 / 128, K2, K3, K4, K6, K7 and K8 with both caches, K9, K10,
   K11, K12) and the decode batch sizes of 3; then GENIE_138M-h64
   (configs/genie_138m.json at 8 heads of 64) at 8 layers: the rollout as
   in 4, ten train steps and the step against the plain path as in 6,
   `score_policies`, the evaluator batch, the train CLI with its resume
   and exports, and the qk_norm int8 rollout and train step; each with
   exact launch counts.
12c. A 32-frame window (`check_window_32`): every frame-axis kernel form
   at T = 32 against its plain version, values and gradients, with its
   times (`check_w32_kernels`: K4 at the train step's (8, 32, 256, 512)
   causal and not and the evaluator prefill's (16, 32, 256, 512), K6 at
   the train step's, K2 and K3 at t_B 16..31 on a (32, 32, 16, 256, 512)
   cache, K7 and K8 with both caches, K12, K4 and K6 at head_dim 64; K4
   and K6 at T = 20, 24 and 32 for C = 512 / 256 / 128 / 64 and at
   head_dim 64, untimed) and the decode batch sizes of 3 at T = 32; then
   GENIE_138M-T32 (configs/genie_138m.json with T = 32 and 16 prompt
   frames) at 8 layers (the rollout and step at 32 until the S = 1024
   phase came): the rollout of 16 + 16 frames as in 4, ten train steps
   and the step against the plain path as in 6, `score_policies` (16
   policies of 16 frames after 16 shared), the evaluator batch, the train
   CLI with its resume and exports, and the qk_norm int8 rollout and train
   step; each with exact launch counts.
12d. A 32 x 32 token grid (`check_grid_1024`): every kernel form at
   GENIE_138M-S1024's shapes (configs/genie_138m.json with S = 1024)
   against its plain version, values and gradients, with its times
   (`check_s1024_kernels`: K1 both modes at N = 16 / 32 / 128, K9 and K10
   at (128, 1024, 16, 32) with SDPA and the exponentials' floor, K11, K12,
   K13, K4, K6, K5, K2 and K3, K7 and K8 with both caches on a (16, 32,
   16, 1024, 512) cache of 2^32 elements a tensor; untimed at R = 2, K9
   and K10 causal and not and at a negative scale, K1 both modes and K11
   at S = 64, 192, 320, 576, 1024 and 4096 and head_dim 32 and 64); then
   GENIE_138M-S1024 at 32 layers: the rollout of 8 + 8 frames as in 4 and
   ten train steps as in 6; the step against the plain path at 8 layers
   (the plain path's probabilities are 2 GiB a layer at CB = 2); at 8
   layers `score_policies`, the evaluator batch, the train CLI with its
   resume and exports (the tokenizer at 512 px), and the qk_norm int8
   rollout and train step; each with exact launch counts. The plain
   oracle's spatial attention runs in slices of frames (`by_frames`).
12e. Head_dim 128 (`check_head_dim_128`): every attention kernel form at
   head_dim 128 (C = 512, 4 heads) against its plain version, values and
   gradients, with its times and SDPA's beside K4, K6, K7, K8, K9, K10
   (`check_h128_kernels`: K1 both modes at N = 16 / 32 / 128 / 256, K2,
   K3, K7 and K8 with both caches, K4 and K6 causal and not at T = 8, 16
   and 32, K9 and K10 at (128, 256, 4, 128) and, untimed, at N = 64, 128,
   192 and 1024, causal, not and at a negative scale, K11, K12) and the
   decode batch sizes of 3 at 4 heads; then GENIE_138M-h128
   (configs/genie_138m.json at 4 heads of 128) at 32 layers: the rollout
   as in 4, ten train steps and the step against the plain path as in 6;
   at 8 layers `score_policies`, the evaluator batch, the train CLI with
   its resume and exports, the qk_norm int8 rollout and train step, and a
   `use_mup` rollout and step as in 8 (the scale 8 / 128); each with exact
   launch counts.
13. Tensor parallelism (`check_tensor_parallel`): K4 and K6 at C = 128
   (4 heads, the kernels' head groups of 4) and C = 64 (2 heads, head
   groups of 2) against their plain versions with their device times and
   bounds; then for GENIE_138M over tp = 2 ranks, GENIE_35M over tp = 4,
   and GENIE_138M-h64 and -h128 over tp = 2 (4 heads of 64 and 2 of 128 a
   rank: K4's and K6's head groups at those widths) (`TP_SETUPS`) tp child
   processes of this script (`--tp-rank`), all
   on this card, joined over gloo as one model group: each splits the
   model at 8 layers, pre-LN and qk_norm, and takes one update (exact
   launch counts per rank), held to this process's update from the same
   weights, batch and draws and to the plain path's in bf16 and fp32
   (`tp_update_gates`: the loss within 2e-2, the gradient norm within
   5e-2 relative; the gradient norm each rank's optimizer read within
   TP_NORM_RTOL of one process's norm of the same gradients, gathered
   whole (`watch_norm`); all parameters' updates together within 3e-2
   relative L2 of one process and no farther from fp32 than one process
   (1.25x + 1e-3); each parameter's no farther from fp32 than 1.25x the
   farthest of its kind's one-process updates (the kernel and the plain
   bf16 path; a kind is a name but for the layer's number) + 1e-3); every
   rank's parameters equal to rank 0's bit for bit; each TP sub-layer
   alone against the whole plain layer (`both_paths`' gates); the 16-row
   rollout over the ranks token for token this process's, at temperature
   0 and 1. Its wall is ranks sharing one card with the all-reduces
   through the host: no TP speed.
14. Prints the `kernels` JSON line (with each kernel's `eval_launches`,
   `evaluate_cli_decoded` among them, `train_cli_launches`,
   `genie_35m_launches` and `mup_launches`, the TP steps' per-rank
   `tp_launches` of both setups, K4's and K6's C = 128 and C = 64
   entries, each attention kernel's head_dim-64 form, `h64`, with its
   launches on GENIE_138M-h64's paths, each frame-axis kernel's T = 32
   form, `t32`, with its launches on GENIE_138M-T32's, every kernel's S =
   1024 form, `s1024`, with its launches on GENIE_138M-S1024's, and each
   attention kernel's head_dim-128 form, `h128`, with its launches on
   GENIE_138M-h128's paths), the card line, and last the result line.

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
import re
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
from tpu1x_torch.model_zoo import genie_35m, genie_138m
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
from tpu1x_torch.parallel.mesh import data_rows, init_distributed
from tpu1x_torch.parallel.sharding import full_state_dict, mesh_of
from tpu1x_torch.train import train as train_cli
from tpu1x_torch.train.checkpoint import (Checkpointer, _state_tensors,
                                          load_pretrained,
                                          load_torch_checkpoint)
from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.step import (TrainState, make_train_step,
                                    shard_train_state)
from tpu1x_torch.tokenizer import tokenize as tok_cli
from tpu1x_torch.tokenizer import train_tokenizer as tt
from tpu1x_torch.tokenizer.checkpoint import load_tokenizer, save_tokenizer
from tpu1x_torch.tokenizer.lpips import LPIPS
from tpu1x_torch.tokenizer.schedulers import build_tokenizer_optimizer
from tpu1x_torch.tokenizer.tokenize import encode_frames
from tpu1x_torch.tokenizer.vqmodel import VQModel, rescale_magvit_output
from tpu1x_torch.utils.profiling import H100_PEAKS

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_TENSOR = H100_PEAKS["sxm"]["bfloat16"]
PEAK_FP32 = H100_PEAKS["sxm"]["float32"]
PEAK_BYTES = 3.35e12

B, P, NEW, STEPS = 16, 8, 8, 2
GRID = 256  # tokens a frame in the kernel checks (`grid_of` sets it)
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


def rollout_per_layer(new):
    """Launches per layer in one rollout of `new` frames: the prefill, new
    + 1 single-frame decodes (2 steps of the first new frame, then step 1 of
    each other), new - 1 pairs."""
    return {"spatial_block": 1 + (new + 1) + (new - 1),
            "temporal_mlp_block": new + 1,
            "temporal_mlp_block_pair": new - 1, "temporal_attention": 1,
            "layer_norm": 1}


def rollout_per_layer_qk(new):
    """The same rollout op by op (qk_norm, or the int8 cache): the decode
    attention kernels take the temporal+MLP block's place."""
    return {"spatial_block": 1 + (new + 1) + (new - 1),
            "temporal_decode_attention": new + 1,
            "temporal_decode2_attention": new - 1}


PER_LAYER = rollout_per_layer(NEW)
PER_LAYER_QK = rollout_per_layer_qk(NEW)
# without qk_norm the prefill keeps its temporal attention and LN2, and
# each of the 16 decodes launches LN2 as well
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


def eval_per_layer(T):
    """One evaluator batch: the prefill of all T frames, then 2 MaskGIT
    steps of each of the T - 1 frame tasks."""
    return {"spatial_block": 1 + 2 * (T - 1),
            "temporal_mlp_block": 2 * (T - 1), "temporal_attention": 1,
            "layer_norm": 1}


EVAL_PER_LAYER = eval_per_layer(16)
# op by op under qk_norm (the prefill's temporal attention plain, no LN2)
EVAL_PER_LAYER_QK = {"spatial_block": 1 + 30, "temporal_decode_attention": 30}
NP, CTX = 16, 8  # policies scored, frames of their shared context
MUP_LAYERS = 8  # the muP phase's depth (GENIE_138M's width)
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
    alone, the median over the kept windows of `windows`. `time_ms`
    includes the wrapper's host time, which is the longer of the two for
    the smallest kernels. The profiler can lose part of a window's kernels,
    more often late in a long process (K10 at S = 1024 read 0.43 of its
    event time there and 1.0 in a fresh process): a window is kept only if
    it has device time and, where the host enqueued its calls in less than
    half its CUDA-event time (the device then ran them back to back), its
    kernels fill at least 0.8 of that time. None if no window is kept (no
    number rather than a wrong one); `vet` also drops a device time below
    its bound."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        total = sum(a.self_device_time_total for a in prof.key_averages()
                    if a.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        event = start.elapsed_time(end)
        if total > 0 and (host >= 0.5 * event or total >= 0.8 * event):
            got.append(total / iters)
    # a lost event only shortens a window: of two, the longer
    return sorted(got)[len(got) // 2] if got else None


# device times that `vet` dropped: (where, key, the reading, its floor)
BELOW_BOUND = []


def vet(r, where=""):
    """`r` (a kernel's result, nested dicts walked) with every profiler
    device time that lies below its floor set to None and listed in
    BELOW_BOUND: no run can beat the bound, so such a reading lost events.
    The floor of `device_ms` and `library_device_ms` is the larger of
    `bound_ms` and `exp_bound_ms`; of another `X_device_ms`, `X_bound_ms`
    where the dict has it."""
    if not isinstance(r, dict):
        return r
    for k, v in r.items():
        if isinstance(v, dict):
            vet(v, f"{where}.{k}")
    bound = r.get("bound_ms")
    for k, v in list(r.items()):
        if not (k.endswith("device_ms") and isinstance(v, float)):
            continue
        if k in ("device_ms", "library_device_ms"):
            floor = max(bound or 0.0, r.get("exp_bound_ms") or 0.0)
        else:
            floor = r.get(k[:-len("device_ms")] + "bound_ms") or 0.0
        if v < floor:
            BELOW_BOUND.append([where, k, v, floor])
            r[k] = None
    return r


def print_kernels(out):
    """Each result of `out`, vetted, on a `kernel` line; `out` back."""
    for name, r in out.items():
        print(f"kernel {name}: " + json.dumps(vet(r, name)), flush=True)
    return out


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
    """K2's and K3's outputs (and, through `both_paths`, K11's, K12's and
    K13's) against the plain bf16 path (`want`) and an fp32 run of the
    plain version (`want32`): elementwise (atol = rtol =
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
    x = inp.normal(B, P, GRID, C, std=1.0, mean=0.3)
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
    plain version's and SDPA's (`temporal_case`)."""
    out = {}
    cases = [("", B, P, True), ("[non-causal]", B, P, False),
             ("[train]", TB, 16, True), ("[train,non-causal]", TB, 16, False)]
    if C != 512:
        cases = [(f"[C={C}]", B, P, True), (f"[C={C},non-causal]", B, P, False)]
    if eval_shapes:
        cases = [("[eval prefill]", B, 16, True),
                 ("[eval prefill,separate]", B, 16, True)]
    for tag, Bt, T, causal in cases:
        out["temporal_attention" + tag] = temporal_case(inp, C, H, tag, Bt, T,
                                                        causal)
    return out


def temporal_case(inp, C, H, tag, Bt, T, causal, timed=True):
    """K4 at (Bt, T, 256, C) against its plain version (atol = rtol =
    3e-2), on the thirds of one qkv tensor, or on three tensors of their own
    where `tag` says "separate"; with `timed` its event and device times,
    the bound, the plain version's and SDPA's."""
    scale = (C // H) ** -0.5
    qkv = inp.normal(Bt, T, GRID, 3 * C)
    q, k, v = qkv.split(C, dim=-1)  # strided views, as both callers
    if "separate" in tag:  # three tensors of their own
        q, k, v = (x.contiguous() for x in (q, k, v))
    kw = dict(scale=scale, num_heads=H, causal=causal)
    err = compare("temporal_attention" + tag,
                  temporal_attention(q, k, v, **kw),
                  temporal_attention_plain(q, k, v, **kw), 3e-2, 3e-2)
    if not timed:
        return dict(max_abs_err=err, shape=list(q.shape), causal=causal)
    D = C // H

    def heads(t):  # (B, T, S, C) -> (B, S, H, T, D) view
        return t.reshape(Bt, T, GRID, H, D).permute(0, 2, 3, 1, 4)
    qh, kh, vh = heads(q), heads(k), heads(v)
    pairs = T * (T + 1) // 2 if causal else T * T
    # q.k and, with probabilities rounded to bf16, p.v
    bms, by = temporal_bound(Bt, T, GRID, C, 4, pairs, 2)

    def kernel():
        return ta.launch_forward(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              scale=scale)
    # the event time through the entry a caller uses, the device time of
    # the launch alone
    return dict(
        max_abs_err=err, shape=list(q.shape), causal=causal,
        bound_ms=bms, bound_by=by,
        ms=time_ms(lambda: temporal_attention(q, k, v, **kw)),
        device_ms=device_ms(kernel),
        plain_ms=time_ms(lambda: temporal_attention_plain(q, k, v, **kw)),
        library_ms=time_ms(library), library_device_ms=device_ms(library))


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
    x = inp.normal(N, GRID, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5, **w)
    err = compare(f"spatial_block N={N} qk_ln={qk_ln}", spatial_block(x, **kw),
                  spatial_block_plain(x, **kw), 3e-2, 3e-2)
    S = GRID
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
    x = inp.normal(B, frames, GRID, C) if pair else inp.normal(B, GRID, C)
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
    kv = (torch.zeros(2, B, GRID, C, dtype=x.dtype, device=x.device),
          torch.zeros(2, B, GRID, C, dtype=x.dtype, device=x.device))
    into = kernel(x, kc, vc, t_B, layer=layer, kv_out=(kv[0][1], kv[1][1]),
                  **kw)
    dropped = kernel(x, kc, vc, t_B, layer=layer, return_kv=False, **kw)
    if not (torch.equal(into[0], got[0]) and torch.equal(kv[0][1], got[1])
            and torch.equal(kv[1][1], got[2]) and kv[0][0].eq(0).all()
            and torch.equal(dropped[0], got[0]) and dropped[1] is None):
        raise AssertionError(f"{name}: kv_out / return_kv change the output")
    if not timed:
        return dict(max_abs_err=err, shape=list(x.shape), held=held)
    S = GRID
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
    T, S = kc.shape[0], GRID
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
    library = library_device = None
    if scales is None:
        sdpa = decode_sdpa(args, pair, layer, C // H, kw["scale"])
        library, library_device = time_ms(sdpa), device_ms(sdpa)
    return {name: dict(
        max_abs_err=err, shape=list(qkv.shape), t_B=t_B.tolist(),
        bound_ms=bms, bound_by=by,
        ms=time_ms(lambda: kernel(*args, layer=layer, **kw)),
        device_ms=device_ms(lambda: kernel(*args, layer=layer, **kw)),
        plain_ms=time_ms(lambda: plain(*args, layer=layer, **kw), iters=5),
        library_ms=library, library_device_ms=library_device,
        rollout=dict(max_abs_err=roll_err, t_B=t_roll.tolist(),
                     bound_ms=roll_bms, bound_by=roll_by,
                     device_ms=device_ms(
                         lambda: kernel(*roll, layer=layer, **kw))))}


def decode_sdpa(args, pair, layer, D, scale):
    """One SDPA call that computes K7's (or K8's) function on the bf16
    cache: every (b, token, head) a query of each frame against the T cache
    slots of `layer` and the in-pass keys, slots t >= t_B[b] and, for prev,
    cur's key masked by a boolean mask. The operands are laid out for it
    once, outside the call that is timed (`library_ms`)."""
    if pair:
        q0, q1, kc, vc, k0, v0, k1, v1, t_B = args
        qs, ks, vs = (q0, q1), (k0, k1), (v0, v1)
    else:
        q0, kc, vc, k0, v0, t_B = args
        qs, ks, vs = (q0,), (k0,), (v0,)
    T, _, Bc, S, C = kc.shape
    H, F_ = C // D, len(qs)

    def heads(x):  # (B, S, C) -> (B S, H, 1, D)
        return x.reshape(Bc * S, H, 1, D)
    q = torch.cat([heads(x) for x in qs], dim=2)
    cache = [c[:, layer].permute(1, 2, 0, 3).reshape(Bc * S, T, H, D)
             .transpose(1, 2) for c in (kc, vc)]
    k = torch.cat([cache[0]] + [heads(x) for x in ks], dim=2)
    v = torch.cat([cache[1]] + [heads(x) for x in vs], dim=2)
    slot = torch.arange(T, device=kc.device)
    valid = (slot[None, :] < t_B.long()[:, None]).repeat_interleave(S, 0)
    own = torch.ones(F_, F_, dtype=torch.bool, device=kc.device).tril()
    mask = torch.cat([valid[:, None, :].expand(Bc * S, F_, T),
                      own.expand(Bc * S, F_, F_)], dim=2)[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)


def flash_case(name, qkv, dout, scale, causal):
    """K9 and K10 on the thirds of one (R, N, 3, H, D) `qkv`, untimed: o and
    lse against `mha_lse_reference` (atol = rtol = 3e-2; lse atol 1e-2),
    K10 on the forward's residuals against `flash_mha_bwd_plain` and through
    `flash_mha`'s autograd against `mha_reference`'s, by the gradient gates.
    Returns (o's max abs error, the gradients' errors)."""
    q, k, v = qkv.unbind(-3)
    (o, lse), (wo, wl) = (
        f(q, k, v, scale=scale, causal=causal)
        for f in (attn.flash_mha_fwd, attn.mha_lse_reference))
    err = compare(name, o, wo, 3e-2, 3e-2)
    compare(f"{name} lse", lse, wl, 1e-2, 0.0)
    errs = {
        f"d{c} (residuals)": grad_errors(f"{name} d{c} (residuals)", got,
                                         want)
        for c, got, want in zip(
            "qkv",
            attn.flash_mha_bwd(q, k, v, o, lse, dout, scale=scale,
                               causal=causal),
            attn.flash_mha_bwd_plain(q, k, v, o, lse, dout, scale=scale,
                                     causal=causal))}
    _, grads = both_paths(
        name,
        lambda qkv: attn.flash_mha(*qkv.unbind(-3), scale=scale,
                                   causal=causal),
        lambda qkv: attn.mha_reference(*qkv.unbind(-3), scale=scale,
                                       causal=causal),
        dict(qkv=qkv), dout)
    return err, dict(errs, dqkv=grads["qkv"])


def check_flash_mha(inp, H, D=32):
    """K9 and K10 at the qk_norm train step's shape (128, GRID, H, D): (128,
    256, 16, 32) at GENIE_138M, (128, 256, 8, 64) at head_dim 64, (128,
    1024, 16, 32) at GENIE_138M-S1024,
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
    R, N = TB * 16, GRID
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
            key = f"N={n}, scale={sc:.4f}"
            other_n[key], other_n_grads[key] = flash_case(
                f"flash_mha{tag} {key}", t["qkv"][:4, :n], dout[:4, :n], sc,
                causal)

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
    return print_kernels(out)


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
    return print_kernels(out)


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
    return print_kernels(out)


def by_frames(fn):
    """`fn` of x (N, S, ...) (and of arguments shared by every frame) over
    slices of at most 2^25 / S^2 frames, concatenated: each frame is its own
    problem, and the plain attention's (N, H, S, S) fp32 logits stay at 2
    GiB a slice (at S = 1024, 32 frames; at S = 256 up to 512 frames, one
    slice on every path of GENIE_138M and GENIE_138M-T32)."""
    def run(x, *args, **kw):
        n = max(1, (1 << 25) // (x.shape[1] ** 2))
        if x.shape[0] <= n:
            return fn(x, *args, **kw)
        return torch.cat([fn(x[i:i + n], *args, **kw)
                          for i in range(0, x.shape[0], n)])
    return run


def mha_by_frames(q, k, v, **kw):
    """`mha_reference` over q, k, v (..., N, H, D), the leading axes in
    slices as `by_frames` takes them."""
    lead, (N, H, D) = q.shape[:-3], q.shape[-3:]
    q3, k3, v3 = (t.reshape(-1, N, H, D) for t in (q, k, v))
    n = max(1, (1 << 25) // (N * N))
    out = (attn.mha_reference(q3, k3, v3, **kw) if q3.shape[0] <= n
           else torch.cat([attn.mha_reference(q3[i:i + n], k3[i:i + n],
                                              v3[i:i + n], **kw)
                           for i in range(0, q3.shape[0], n)]))
    return out.reshape(*lead, N, H, D)


class PlainDecodeEngine(DecodeEngine):
    """`DecodeEngine` with every op's plain version, on any device: the
    oracle that this script holds the kernel path against. The port itself
    has no way to the plain versions on the card."""

    _ops = SimpleNamespace(
        spatial_block=by_frames(spatial_block_plain),
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


def profile_device(run, top: int = 12, must=(), must_not=(),
                   kinds=KERNEL_KINDS):
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
    return device_summary(prof, wall, top, must, must_not, kinds)


def device_summary(prof, wall, top=12, must=(), must_not=(),
                   kinds=KERNEL_KINDS):
    """`profile_device`'s summary of a finished profile over `wall`
    seconds, device time summed by `kinds` (the first whose mark a kernel's
    name holds)."""
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
        kind = next((k for k, marks in kinds if any(
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
    amax / 127 of its token. That step is inside the elementwise gate only
    where amax < 3.8; after the qk-LN a token's amax reaches 4.7 (head_dim
    64: 4 of 16777216 values of layer 0 one step, 0.0367, apart), so there
    an element may lie one step of its token from the plain path's instead
    (`int8_layer0`), and at most 1e-4 of the elements do."""
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
            # the prompt's slots alone, the cache freed before the next
            # path's (GENIE_138M-S1024's fp32 cache is 32 GiB)
            got[name][key] = cache[key][:P].clone()
            if key + "_scale" in cache:  # (L, B, T, S) -> (T, L, B, S)
                got[name][key + "_step"] = cache[key + "_scale"].permute(
                    2, 0, 1, 3)[:P]
                got[name][key] = da.dequantize_kv(cache[key][:P],
                                                  got[name][key + "_step"])
        del cache
    out = {}
    for key in ("k", "v"):
        name = f"prefill cache {key} layer 0"
        g, w = got["kernel"][key][:, 0], got["plain"][key][:, 0]
        if key + "_step" in got["plain"]:
            out[f"prefill_{key}_layer0"] = int8_layer0(
                name, g, w, torch.maximum(got["kernel"][key + "_step"][:, 0],
                                          got["plain"][key + "_step"][:, 0]))
            out[f"prefill_{key}_layer0_max_abs_err"] = out[
                f"prefill_{key}_layer0"]["max_abs_err"]
        else:
            out[f"prefill_{key}_layer0_max_abs_err"] = compare(name, g, w,
                                                               3e-2, 3e-2)
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


def int8_layer0(name, got, want, step):
    """Dequantized int8 cache values `got` against `want` (atol = rtol =
    3e-2), where an element past that gate may lie one quantization step of
    its token (`step`, (..., tokens) of both paths' amax / 127, the larger)
    from `want`: the two bf16 paths rounded it to neighbouring steps. Raises
    if any element lies farther, or more than 1e-4 of them lie past the
    elementwise gate."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    past = err > 3e-2 + 3e-2 * w.abs()
    steps = err / step.float().unsqueeze(-1)
    worst = float(steps[past].max()) if past.any() else 0.0
    out = {"max_abs_err": float(err.max()), "past_gate": int(past.sum()),
           "elements": g.numel(), "past_gate_max_steps": worst}
    if worst > 1.01 or out["past_gate"] > 1e-4 * g.numel():
        raise AssertionError(f"{name}: {out}")
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


def both_paths(name, kernel_fn, plain_fn, tensors, dout, held=False):
    """The output and the gradient of sum(out * dout) for every tensor of
    `tensors` through the kernels' autograd.Function and through the plain
    version's ordinary autograd. Returns (output max abs error, {tensor:
    gradient errors}). The output is held elementwise (atol = rtol =
    3e-2), or with `held` by `held_to_plain` against the plain path and an
    fp32 run of the plain version on the same values (the train blocks
    K11, K12 and K13, whose bf16 paths round a product and the residual
    that cancels it in another order; ROADMAP C11), its numbers then in
    the gradients' dict under "out_held"."""
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
    grads = {k: grad_errors(f"{name} d{k}", g_k[k], g_p[k]) for k in tensors}
    if not held:
        return compare(name, out_k, out_p, 3e-2, 3e-2), grads
    with torch.no_grad():
        out_32 = plain_fn(**{k: t.float() for k, t in tensors.items()})
    grads["out_held"] = held_to_plain(name, out_k, out_p, out_32, 3e-2)
    return grads["out_held"]["max_abs_err"], grads


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
    S, N = GRID, TB * 16
    t = dict(x=inp.normal(N, S, C), **{
        k: v.float() for k, v in spatial_weights(inp, C).items()})
    dout = inp.normal(N, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    tag = "" if C == 512 else f"[C={C}]"
    out_err, grads = both_paths(
        "spatial_train_block" + tag,
        functools.partial(stb.spatial_train_block, **kw),
        functools.partial(stb.spatial_train_block_plain, **kw), t, dout,
        held=True)
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


def check_temporal_train_block(inp, C, H, timed=True, T=16):
    """K12's forward and backward at (TB, T, 256, C), values and every
    gradient, against `temporal_train_block_plain`'s autograd; with `timed`
    their event and device times, the plain version's and the bounds."""
    S = GRID
    t = dict(x=inp.normal(TB, T, S, C),
             wqkv=inp.normal(C, 3 * C, std=0.05, dtype=torch.float32),
             wproj=inp.normal(C, C, std=0.05, dtype=torch.float32),
             bproj=inp.normal(C, std=0.1, dtype=torch.float32))
    dout = inp.normal(TB, T, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    tag = ("" if C == 512 else f"[C={C}]") + ("" if T == 16 else f"[T={T}]")
    plain = functools.partial(ttb.temporal_train_block_plain, **kw)
    out_err, grads = both_paths(
        "temporal_train_block" + tag,
        functools.partial(ttb.temporal_train_block, **kw), plain, t, dout,
        held=True)
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
        "temporal_train_block" + tag: entry(
            out_err, {}, t["x"].shape, time_ms(run_fwd), plain_ms(plain, t),
            fwd, device_ms=device_ms(run_fwd)),
        "temporal_train_block_bwd" + tag: entry(
            grads["x"]["max_abs_err"], grads, t["x"].shape, time_ms(run_bwd),
            plain_ms(plain, t, dout), bwd, device_ms=device_ms(run_bwd))}


def check_mlp_train_block(inp, C, ln=True, timed=True):
    """K13 forward and backward, values and every gradient, with the tanh
    and the exact-erf GELU, against `mlp_train_block_plain`'s autograd; with
    `ln` False without its LayerNorm, as the qk_norm models call it. With
    `timed`: the event and device times, the plain version's and the
    bounds, and a profile of one forward and backward, which must launch no
    GEMM of the port but csrc/gemm_sm90.cuh's (`profile_device`)."""
    S, N, F4 = GRID, TB * 16, 4 * C
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
            plain, t, dout, held=True)
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


def check_temporal_attention_bwd(inp, C, H, T=16, Bt=TB, timed=True):
    """K6 at the pre-LN train step's (TB, 16, 256, C) (or (Bt, T, 256, C)),
    causal and not: the output and dq, dk, dv of the kernels'
    autograd.Function against the plain version's autograd, and the `o`
    that K6 writes beside them equal to K4's output exactly; with `timed`
    its event and device times without and with `o`, the bounds, the plain
    backward's time and SDPA's backward's."""
    S, D = GRID, C // H
    t = dict(qkv=inp.normal(Bt, T, S, 3 * C))
    dout = inp.normal(Bt, T, S, C)
    scale = D ** -0.5
    out = {}
    for causal in (True, False):
        name = ("temporal_attention_bwd" + ("" if causal else "[non-causal]")
                + ("" if C == 512 else f"[C={C}]")
                + ("" if T == 16 else f"[T={T}]"))
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
        if not timed:
            out[name] = dict(max_abs_err=grads["qkv"]["max_abs_err"],
                             grads=dict(grads, out=out_err),
                             shape=list(q.shape), o_equals_forward=True)
            continue

        def heads(x):  # (B, T, S, C) -> (B, S, H, T, D) view
            return x.reshape(Bt, T, S, H, D).permute(0, 2, 3, 1, 4)
        lq, lk, lv = (heads(x).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                                 scale=scale)
        pairs = T * (T + 1) // 2 if causal else T * T
        # logits, dp, dq, dk, dv: five products (and o six) of 2 D FLOP a
        # (query, key, head)
        bnd = temporal_bound(Bt, T, S, C, 7, pairs, 5)
        bnd_o = temporal_bound(Bt, T, S, C, 8, pairs, 6)

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


def check_decode_batches(C, H, device, T=16):
    """K7 and K8 (bf16 and int8 cache) at B = 16, 17, 16 + 256 (one
    launch per 256 rows) and 16 again, and K2 at B = 16 then 17, each
    against its plain version by the gates of 3 (K2's output by
    `held_to_plain`, as `check_temporal_mlp_block` holds it: at head_dim
    64 one element of 2097152 lay 0.0625 from the plain path, a rounding
    the MLP carries, ROADMAP C4): a launch's shared memory must not depend
    on the batches launched before it (S = 64 for K7 and K8, a 2-layer
    cache of T slots, t_B mixed 0..T - 1; K2's t_B from P)."""
    inp = Inputs(4, device)
    L, S = 2, 64
    kw = dict(layer=1, scale=(C // H) ** -0.5, num_heads=H)
    errs = {}
    for Bt in (16, 17, 16 + 256, 16):
        kc, vc = inp.normal(T, L, Bt, S, C), inp.normal(T, L, Bt, S, C)
        (kq, ks), (vq, vs) = quantize_cache(kc), quantize_cache(vc)
        t_B = (torch.arange(Bt, device=device) * 7 % T).to(torch.int32)
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
        f32 = {k: v.float() if torch.is_tensor(v) else v
               for k, v in bkw.items()}
        want32 = temporal_mlp_block_plain(x.float(), kc[:, 1].float(),
                                          vc[:, 1].float(), t_B, **f32)
        name = f"temporal_mlp_block[B={Bt}]"
        errs[name] = held_to_plain(name, got[0], want[0], want32[0], 3e-2)
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
    return print_kernels(out)


@contextlib.contextmanager
def plain_blocks():
    """Every STBlock takes the plain train blocks, on any device: this
    script's oracle. The port itself has no way to them on the card."""
    kernel_ops = STBlock.ops
    STBlock.ops = SimpleNamespace(
        spatial=by_frames(stb.spatial_train_block_plain),
        temporal=ttb.temporal_train_block_plain,
        mlp=mtb.mlp_train_block_plain, mha=mha_by_frames)
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
    # the pre-LN step: K11's attention backward is K10's two passes, beside
    # the recompute on K9's kernel (its streamed form past S = 256, and at
    # every S at head_dim 128); of spatial_block.cu's own kernels none runs;
    # K4 and K6 are temporal_attention.cu's tiled kernels, and the names of
    # the per-(b, s) kernels they replaced must not appear
    k9 = ("flash_fwd_stream_kernel"
          if cfg.S > 256 or cfg.head_dim == 128  # csrc FA_N
          else "flash_fwd_kernel")
    pre_ln = {} if cfg.qk_norm else dict(
        must=(k9, "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
              "temporal_fwd_kernel", "temporal_bwd_kernel"),
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


def check_variant(cfg, device, seed, mu_transfer=False):
    """A configuration beside the shipped ones at a cut depth: the rollout
    of 4 (`check_rollout`: exact launch counts, the prefill cache and the
    step-0 logits against `PlainDecodeEngine`; under seeded actions where
    the config has an action vocabulary); one `make_train_step` step
    through the kernels (exact launch counts) and through the plain train
    blocks, from the same weights, batch, corruption and actions (loss and
    gradient norm); and every parameter's gradient against the plain path
    and an fp32 run (`check_step_against_plain`). `mu_transfer` gives the
    step's optimizer muP's learning rate for the hidden matrices."""
    roll = check_rollout(cfg, device, full=False)
    g = torch.Generator(device=device).manual_seed(seed)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (CB, cfg.T, side, side),
                           generator=g, device=device)
    acts = (torch.randint(0, cfg.action_vocab_size, (CB, cfg.T),
                          generator=g, device=device)
            if cfg.action_vocab_size > 0 else None)
    noise = draw_noise(tokens.shape, cfg, g, device)
    steps = {}
    for path in ("kernel", "plain"):
        m = STMaskGIT(cfg, device=device)
        m.load_state_dict(model.state_dict())
        step = make_train_step(m, TrainOptimizer(
            m, cfg, learning_rate=TRAIN_LR, max_grad_norm=1.0,
            mu_transfer=mu_transfer), cfg)
        kernels.reset_launches()
        with plain_blocks() if path == "plain" else contextlib.nullcontext():
            r = step(tokens, actions_BT=acts, noise=noise)
        torch.cuda.synchronize()
        want = expected_launches(TRAIN_PER_LAYER if path == "kernel" else {},
                                 cfg.num_layers)
        if kernels.LAUNCHES != want:
            raise AssertionError(f"train step, {path} path: launches "
                                 f"{kernels.LAUNCHES}, expected {want}")
        steps[path] = {k: float(v) for k, v in r.items()}
        steps[path + "_launches"] = dict(kernels.LAUNCHES)
        del step, m
    # the gates of `check_step_against_plain` on the loss and the norm
    got, want = steps["kernel"], steps["plain"]
    if not (all(math.isfinite(v) for v in got.values())
            and abs(got["loss"] - want["loss"]) <= 2e-2
            and abs(got["grad_norm"] / want["grad_norm"] - 1) <= 5e-2):
        raise AssertionError(f"train step against the plain path: {steps}")
    return dict(rollout=roll, train_step=steps,
                train_step_against_plain=check_step_against_plain(
                    model, cfg, device))


def check_action_conditioning(device, layers=8, actions=16):
    """Action conditioning on the card: GENIE_138M at `layers` layers with
    an action vocabulary of `actions` ids, by `check_variant`. Actions
    enter through the embedding alone, so every kernel sees what it sees
    without them."""
    return check_variant(genie_138m(num_layers=layers,
                                    action_vocab_size=actions), device, 3)


def check_mup(device, layers=MUP_LAYERS):
    """muP on the card: GENIE_138M at `layers` layers with use_mup
    (width_mult 512 / 256 = 2: every attention's scale 8 / head_dim, which
    the kernels take as an argument, and the head's input divided by 2),
    by `check_variant`, the step with muP's learning rate for the hidden
    matrices."""
    cfg = genie_138m(num_layers=layers, use_mup=True)
    if cfg.width_mult != 2.0:
        raise AssertionError(f"muP: width_mult {cfg.width_mult}")
    return dict(width_mult=cfg.width_mult, scale=8.0 / cfg.head_dim,
                **check_variant(cfg, device, 8, mu_transfer=True))


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
    out.update(score_s=s, score_s_runs=walls, policies_per_s=NP / s,
               device_time=profile_device(
                   lambda: engine.score_policies(ctx, conts),
                   must=("temporal_fwd_kernel",)))
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


# ---------------------------------------------------------------- GENIE_35M

GENIE_35M_CONFIG = Path(__file__).resolve().parent / "configs" / \
    "genie_35m.json"
# the depth of GENIE_35M's scores, evaluator batch and train CLI (the
# script's time)
G35_CUT_LAYERS = 8


def check_genie_35m(device):
    """GENIE_35M, the reference's shipped config, end to end at full depth
    and width: configs/genie_35m.json through `GenieConfig.from_pretrained`
    (32 layers, C = 256, 8 heads, S = 256, T = 16, bf16, remat
    "attn_outs"), seeded random weights. Each entry point by the gates, the
    launch counts per layer and the device-time profile of its GENIE_138M
    counterpart: the rollout (`check_rollout`), ten train steps
    (`check_training`) and the step's gradients against the plain path and
    fp32 (`check_step_against_plain`); at G35_CUT_LAYERS layers
    `score_policies` (`check_scoring`), `evaluate_dataset` at B = 16
    (`check_evaluator`), and the train CLI on the JSON cut so, with its
    resume and exports (`check_cli_run`)."""
    cfg = GenieConfig.from_pretrained(GENIE_35M_CONFIG)
    out, walls = {}, {}
    t0 = time.perf_counter()
    out["rollout"] = check_rollout(cfg, device)
    walls["rollout"] = time.perf_counter() - t0
    print("genie_35m rollout: " + json.dumps(out["rollout"]), flush=True)
    t0 = time.perf_counter()
    model, out["training"] = check_training(cfg, device)
    out["step_against_plain"] = check_step_against_plain(model, cfg, device)
    walls["training"] = time.perf_counter() - t0
    print("genie_35m training: " + json.dumps(out["training"]), flush=True)
    print("genie_35m train step against the plain path: " + json.dumps(
        out["step_against_plain"]), flush=True)
    del model
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=G35_CUT_LAYERS)
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(0)
    model = STMaskGIT(cut, device=device).init_weights(g)
    engine, out["scoring"] = check_scoring(model, cut, device)
    del engine
    print("genie_35m scoring: " + json.dumps(out["scoring"]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ev, ds, out["evaluator"] = check_evaluator(model, cut, device,
                                                   Path(tmp) / "data")
    del ev, ds, model
    torch.cuda.empty_cache()
    walls["evaluation"] = time.perf_counter() - t0
    print("genie_35m evaluator: " + json.dumps(out["evaluator"]), flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the CLI on the cut JSON, written beside
        cut.save_pretrained(Path(tmp) / "genie_35m.json")
        out["cli"] = check_cli_run(cut, device, Path(tmp),
                                   Path(tmp) / "genie_35m.json")
    walls["cli"] = time.perf_counter() - t0
    # the bare step at B = TB takes one micro-batch and one AdamW update
    bare = out["training"]["step_s"]
    out["cli"].update(bare_step_s=bare, overhead_s_per_update=(
        out["cli"]["s_per_update"] - RT_ACCUMULATE * bare))
    torch.cuda.empty_cache()
    print("genie_35m train CLI: " + json.dumps(out["cli"]), flush=True)
    out["phase_walls_s"] = walls
    return out


# ------------------------------------------------------------ head_dim 64

H64_HEADS = 8  # GENIE_138M's width at 8 heads: head_dim 64
H64_LAYERS = 8  # the depth of the phase's secondary paths


def genie_138m_h64(**overrides) -> GenieConfig:
    """GENIE_138M-h64: configs/genie_138m.json through
    `GenieConfig.from_pretrained` with 8 heads of 64 channels (32 layers,
    d_model 512, S 256, T 16, bf16 compute, fp32 params): muP's base head
    count at twice its base width. Same parameters, products, MLP and
    caches as GENIE_138M; only the attention's head width changes."""
    return dataclasses.replace(GenieConfig.from_pretrained(RT_CONFIG),
                               num_heads=H64_HEADS, **overrides)


def check_h64_kernels(device):
    """Every attention kernel form at head_dim 64 (C = 512, 8 heads), on the
    main path's shapes, held to its plain version by the gates of its
    head_dim-32 form (values, and every gradient where the TPU kernel has a
    backward): K1 in both modes at N = 16 / 32 / 128, K2 and K3, K4 and K6,
    K7 and K8 (bf16 and int8 cache), K9 and K10, K11 and K12; each with the
    times of its head_dim-32 check. Keys end in "[h64]"."""
    C, H, L = 512, H64_HEADS, 32
    inp = Inputs(6, device)
    out = {}
    for qk_ln in (False, True):
        for N in (B, 2 * B, B * P):
            mode = "qk_ln," if qk_ln else ""
            out[f"spatial_block[{mode}N={N}]"] = check_spatial_block(
                inp, C, H, N, qk_ln=qk_ln)
    T = 16
    caches = (inp.normal(T, L, B, 256, C), inp.normal(T, L, B, 256, C))
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        out[name] = check_temporal_mlp_block(inp, C, H, L, caches, pair)
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, caches, None, pair))
    (kq, ks), (vq, vs) = quantize_cache(caches[0]), quantize_cache(caches[1])
    del caches
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, (kq, vq), (ks, vs),
                                          pair))
    del kq, vq, ks, vs
    torch.cuda.empty_cache()
    out.update(check_temporal_attention(inp, C, H))
    out.update(check_temporal_attention_bwd(inp, C, H))
    out.update(check_flash_mha(inp, H, D=C // H))
    out.update(check_spatial_train_block(inp, C, H))
    out.update(check_temporal_train_block(inp, C, H))
    torch.cuda.empty_cache()
    out = {f"{name}[h64]": r for name, r in out.items()}
    return print_kernels(out)


def check_config_paths(make, label, device, cut_layers, deep_layers=None,
                       plain_layers=None):
    """The entry points of the configuration `make(**overrides)` (seeded
    random weights), each by its GENIE_138M counterpart's gates and exact
    launch counts per layer: at `deep_layers` layers (the configuration's
    own where None) the rollout (B 16, P + NEW frames, maskgit_steps 2)
    against the plain path (`check_rollout`), ten train steps
    (`check_training`) and the step's gradients against the plain path and
    fp32 (`check_step_against_plain`; at `plain_layers` layers where given,
    a model of its own from the same seed); at `cut_layers` layers
    `score_policies`, an `evaluate_dataset` batch at B 16, the train CLI on
    the configuration written as JSON into a temporary directory, with its
    resume and exports (`check_cli_run`), and the qk_norm model's int8
    op-by-op rollout and train step against the plain path. Each result is
    printed after `label`. Returns (results, walls in s)."""
    deep = make() if deep_layers is None else make(num_layers=deep_layers)
    cut = make(num_layers=cut_layers)
    out, walls = {}, {}

    def show(what, key):
        print(f"{label} {what}: " + json.dumps(out[key]), flush=True)
    t0 = time.perf_counter()
    out["rollout"] = check_rollout(deep, device,
                                   per_layer=rollout_per_layer(NEW))
    walls["rollout"] = time.perf_counter() - t0
    show("rollout", "rollout")
    t0 = time.perf_counter()
    model, out["training"] = check_training(deep, device)
    if plain_layers is not None:  # a model that the plain path fits
        del model
        torch.cuda.empty_cache()
        deep = make(num_layers=plain_layers)
        g = torch.Generator(device=device).manual_seed(0)
        model = STMaskGIT(deep, device=device).init_weights(g)
    out["step_against_plain"] = check_step_against_plain(model, deep, device)
    del model
    torch.cuda.empty_cache()
    walls["training"] = time.perf_counter() - t0
    show("training", "training")
    show("train step against the plain path", "step_against_plain")

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(0)
    model = STMaskGIT(cut, device=device).init_weights(g)
    engine, out["scoring"] = check_scoring(model, cut, device)
    del engine
    show("scoring", "scoring")
    with tempfile.TemporaryDirectory() as tmp:
        ev, ds, out["evaluator"] = check_evaluator(model, cut, device,
                                                   Path(tmp) / "data")
    del ev, ds, model
    torch.cuda.empty_cache()
    walls["evaluation"] = time.perf_counter() - t0
    show("evaluator", "evaluator")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = Path(tmp) / f"{make.__name__}.json"
        cut.save_pretrained(config)
        out["cli"] = check_cli_run(cut, device, Path(tmp), config)
    torch.cuda.empty_cache()
    walls["cli"] = time.perf_counter() - t0
    show("train CLI", "cli")

    t0 = time.perf_counter()
    qk = make(num_layers=cut_layers, qk_norm=True, remat=False)
    out["qk_norm_int8_rollout"] = check_rollout(
        qk, device, "int8", rollout_per_layer_qk(NEW), full=False)
    show("rollout qk_norm int8", "qk_norm_int8_rollout")
    model, out["qk_norm_training"] = check_training(qk, device,
                                                    TRAIN_PER_LAYER_QK)
    out["qk_norm_step_against_plain"] = check_step_against_plain(
        model, qk, device, TRAIN_PER_LAYER_QK)
    del model
    torch.cuda.empty_cache()
    walls["qk_norm"] = time.perf_counter() - t0
    show("training qk_norm", "qk_norm_training")
    show("qk_norm train step against the plain path",
         "qk_norm_step_against_plain")
    return out, walls


def check_head_dim_64(device):
    """GENIE_138M-h64 end to end (`genie_138m_h64`), modelled on
    `check_genie_35m`: every head_dim-64 kernel form against its plain
    version (`check_h64_kernels`) and the decode batch sizes
    (`check_decode_batches`), then every entry point at H64_LAYERS layers
    (`check_config_paths`; the rollout and the step since the T = 32 phase
    came, for the script's time: `check_h64_kernels` keeps every form at
    its full shapes)."""
    cfg = genie_138m_h64()
    walls = {}
    t0 = time.perf_counter()
    out = {"kernels": check_h64_kernels(device),
           "decode_batches": check_decode_batches(cfg.d_model, cfg.num_heads,
                                                  device)}
    print("head_dim 64 decode attention across batch sizes: " + json.dumps(
        out["decode_batches"]), flush=True)
    walls["kernels"] = time.perf_counter() - t0
    paths, path_walls = check_config_paths(genie_138m_h64, "head_dim 64",
                                           device, H64_LAYERS, H64_LAYERS)
    out.update(paths, phase_walls_s=dict(walls, **path_walls))
    return out


# ------------------------------------------------------- a 32-frame window

W32_T, W32_PROMPT = 32, 16  # GENIE_138M-T32's window and prompt frames
W32_LAYERS = 8  # the depth of the phase's secondary paths
# the frame counts, head counts and C of the untimed K4 / K6 sweep: head
# groups 8, 8, 4, 2 at head_dim 32, then head_dim 64
W32_SWEEP_T = (20, 24, 32)
W32_SWEEP_CH = ((512, 16), (256, 8), (128, 4), (64, 2), (512, 8))
# the kernels line's T = 32 entry of each kernel: its key in
# `check_w32_kernels`
W32_KEYS = {"temporal_mlp_block": "temporal_mlp_block",
            "temporal_mlp_block_pair": "temporal_mlp_block_pair",
            "temporal_attention": "temporal_attention[train]",
            "temporal_attention_bwd": "temporal_attention_bwd[T=32]",
            "temporal_train_block": "temporal_train_block[T=32]",
            "temporal_train_block_bwd": "temporal_train_block_bwd[T=32]",
            "temporal_decode_attention": "temporal_decode_attention",
            "temporal_decode2_attention": "temporal_decode2_attention"}
W32_H64_KEYS = {"temporal_attention": "temporal_attention[train,h64]",
                "temporal_attention_bwd": "temporal_attention_bwd[T=32][h64]"}


def genie_138m_t32(**overrides) -> GenieConfig:
    """GENIE_138M-T32: configs/genie_138m.json through
    `GenieConfig.from_pretrained` with T = 32 and 16 prompt frames (32
    layers, d_model 512, 16 heads of 32, S 256, bf16 compute, fp32 params):
    a 16-s window at the dataset's 2 Hz. GENIE_138M's parameters but the
    temporal position embedding's length; the same products and MLP."""
    return dataclasses.replace(GenieConfig.from_pretrained(RT_CONFIG),
                               T=W32_T, num_prompt_frames=W32_PROMPT,
                               **overrides)


@contextlib.contextmanager
def window_of(cfg):
    """This module's frame counts set to `cfg`'s window while the block
    runs: the rollout's prompt P = num_prompt_frames and its NEW = T - P
    frames, the scores' shared context CTX = P, and the evaluator's and
    visualize's launches per layer; restored after."""
    g = globals()
    saved = {k: g[k] for k in ("P", "NEW", "CTX", "EVAL_PER_LAYER",
                               "VIS_PER_LAYER")}
    g.update(P=cfg.num_prompt_frames, NEW=cfg.T - cfg.num_prompt_frames,
             CTX=cfg.num_prompt_frames, EVAL_PER_LAYER=eval_per_layer(cfg.T),
             VIS_PER_LAYER=vis_per_layer(cfg.T))
    try:
        yield
    finally:
        g.update(saved)


def check_w32_kernels(device):
    """Every frame-axis kernel form at GENIE_138M-T32's window (C = 512, 16
    heads), on the main path's shapes, held to its plain version by the
    gates of its T = 16 form (values, and every gradient where the TPU
    kernel has a backward), each with its times and bound; call it inside
    `window_of`. K4 at the train step's (TB, 32, 256, C), causal and not,
    and at the evaluator prefill's (B, 32, 256, C); K6 at the train step's;
    K2 and K3 at t_B from P (16..31) on a (32, 32, B, 256, C) cache; K7 and
    K8 with the bf16 and the int8 cache (t_B mixed 0..31, and the
    rollout's from P); K12 forward and backward; K4 and K6 at head_dim 64
    at the train step's shape. Untimed at B = 2, K4 and K6 causal and not
    at T = 20, 24 and 32 (frames past T masked) for each (C, heads) of
    W32_SWEEP_CH. Keys end in "[t32]"."""
    C, H, L, T = 512, 16, 32, W32_T
    inp = Inputs(8, device)
    out = {}
    for tag, Bt, causal in (("[train]", TB, True),
                            ("[train,non-causal]", TB, False),
                            ("[eval prefill]", B, True)):
        out["temporal_attention" + tag] = temporal_case(inp, C, H, tag, Bt,
                                                        T, causal)
    out.update(check_temporal_attention_bwd(inp, C, H, T=T))
    for T_ in W32_SWEEP_T:
        for C_, H_ in W32_SWEEP_CH:
            if (T_, C_, H_) == (T, C, H):
                continue  # timed above at full shape
            for causal in (True, False):
                tag = (f"[T={T_},C={C_},H={H_}"
                       + ("]" if causal else ",non-causal]"))
                out["temporal_attention" + tag] = temporal_case(
                    inp, C_, H_, tag, 2, T_, causal, timed=False)
            for k, r in check_temporal_attention_bwd(
                    inp, C_, H_, T=T_, Bt=2, timed=False).items():
                out[f"{k}[H={H_}]"] = r
    torch.cuda.empty_cache()
    caches = (inp.normal(T, L, B, 256, C), inp.normal(T, L, B, 256, C))
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        out[name] = check_temporal_mlp_block(inp, C, H, L, caches, pair,
                                             first=P)
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, caches, None, pair))
    (kq, ks), (vq, vs) = quantize_cache(caches[0]), quantize_cache(caches[1])
    del caches
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, (kq, vq), (ks, vs),
                                          pair))
    del kq, vq, ks, vs
    torch.cuda.empty_cache()
    out.update(check_temporal_train_block(inp, C, H, T=T))
    # K4 and K6 at head_dim 64 (8 heads) at the train step's shape, timed
    out["temporal_attention[train,h64]"] = temporal_case(
        inp, C, 8, "[train,h64]", TB, T, True)
    for k, r in check_temporal_attention_bwd(inp, C, 8, T=T).items():
        out[f"{k}[h64]"] = r
    torch.cuda.empty_cache()
    out = {f"{name}[t32]": r for name, r in out.items()}
    return print_kernels(out)


def check_window_32(device):
    """GENIE_138M-T32 end to end (`genie_138m_t32`), modelled on
    `check_head_dim_64`, inside `window_of`: every T = 32 kernel form
    against its plain version (`check_w32_kernels`) and the decode batch
    sizes at T = 32 (`check_decode_batches`), then every entry point
    (`check_config_paths`) at W32_LAYERS layers: the rollout of 16 + 16
    frames and the train step (at 32 layers until the S = 1024 phase came,
    for the script's time: `check_w32_kernels` keeps every form at its full
    shapes), scores (NP policies of 16 frames after 16 shared), the
    evaluator, the train CLI and the qk_norm int8 paths."""
    cfg = genie_138m_t32()
    walls = {}
    with window_of(cfg):
        t0 = time.perf_counter()
        out = {"kernels": check_w32_kernels(device),
               "decode_batches": check_decode_batches(
                   cfg.d_model, cfg.num_heads, device, T=cfg.T)}
        print("T = 32 decode attention across batch sizes: " + json.dumps(
            out["decode_batches"]), flush=True)
        walls["kernels"] = time.perf_counter() - t0
        paths, path_walls = check_config_paths(genie_138m_t32, "T = 32",
                                               device, W32_LAYERS,
                                               W32_LAYERS)
    out.update(paths, phase_walls_s=dict(walls, **path_walls))
    return out


# ------------------------------------------------------- a 32 x 32 grid

S1024_S = 1024  # GENIE_138M-S1024's tokens a frame: a 32 x 32 grid
S1024_LAYERS = 8  # the depth of the phase's secondary paths
# the depth of the step against the plain path: the plain path's autograd
# keeps every (N, H, S, S) fp32 probability tensor, 2 GiB a layer at CB = 2
S1024_PLAIN_LAYERS = 8
# the untimed sweep of the spatial kernels (R = 2 rows, head_dim 32 and 64)
S1024_SWEEP_S = (64, 192, 320, 576, 1024, 4096)
# the kernels line's S = 1024 entry of each kernel: its key in
# `check_s1024_kernels`
S1024_KEYS = {"spatial_block": f"spatial_block[N={B}]",
              "layer_norm": "layer_norm",
              "temporal_mlp_block": "temporal_mlp_block",
              "temporal_mlp_block_pair": "temporal_mlp_block_pair",
              "temporal_attention": "temporal_attention[train]",
              "temporal_attention_bwd": "temporal_attention_bwd",
              "spatial_train_block_bwd": "spatial_train_block_bwd",
              "temporal_train_block": "temporal_train_block",
              "temporal_train_block_bwd": "temporal_train_block_bwd",
              "mlp_train_block": "mlp_train_block",
              "mlp_train_block_bwd": "mlp_train_block_bwd",
              "temporal_decode_attention": "temporal_decode_attention",
              "temporal_decode2_attention": "temporal_decode2_attention",
              "flash_mha": "flash_mha", "flash_mha_bwd": "flash_mha_bwd"}
# H100 SXM: 132 SMs, 16 special-function results (ex2) a clock an SM, at
# the 1.83 GHz that the 989 TFLOP/s bf16 peak assumes (132 SMs x 4096
# dense bf16 operations a clock)
PEAK_EX2 = 132 * 16 * 1.83e9


def genie_138m_s1024(**overrides) -> GenieConfig:
    """GENIE_138M-S1024: configs/genie_138m.json through
    `GenieConfig.from_pretrained` with S = 1024, a 32 x 32 token grid (32
    layers, d_model 512, 16 heads of 32, T 16 with 8 prompt frames, bf16
    compute, fp32 params): the frames of the MAGVIT2 tokenizer at
    resolution 512. GENIE_138M's parameters but the spatial position
    embedding's length; the same products and MLP."""
    return dataclasses.replace(GenieConfig.from_pretrained(RT_CONFIG),
                               S=S1024_S, **overrides)


@contextlib.contextmanager
def grid_of(cfg):
    """This module's token grid set to `cfg`'s while the block runs: GRID
    = cfg.S for the kernel checks, and the tokenizer the CLI check decodes
    with at the resolution whose latents are that grid (16x downsampling);
    restored after."""
    g = globals()
    saved = {k: g[k] for k in ("GRID", "VQ_CONFIG")}
    g.update(GRID=cfg.S, VQ_CONFIG=dataclasses.replace(
        VQ_CONFIG, resolution=16 * cfg.latent_side_len))
    try:
        yield
    finally:
        g.update(saved)


def exp_bound(ms_entry, R, H, pairs):
    """`ms_entry` with the exponentials' floor beside its bound: one ex2 a
    (query, key) pair and head, at PEAK_EX2. The function needs no more:
    K10's second pass recomputes them, an overhead of its design."""
    ms_entry["exp_bound_ms"] = R * H * pairs / PEAK_EX2 * 1e3
    return ms_entry


def check_s1024_kernels(device):
    """Every kernel form at GENIE_138M-S1024's grid (C = 512, 16 heads),
    on the main path's shapes, held to its plain version by the gates of
    its S = 256 form (values, and every gradient where the TPU kernel has a
    backward), each with its times and bound; call it inside `grid_of`. K1
    in both modes at N = 16 / 32 / 128 frames; K9 and K10 at the qk_norm
    train step's (128, 1024, 16, 32) with SDPA beside them and the
    exponentials' floor (`exp_bound_ms`); K11, K12, K13 at the pre-LN train
    step's 128 frames; K4 and K6 at the train step's and the prefill's;
    K5; K2 and K3 at the rollout's t_B and K7 and K8 with the bf16 and the
    int8 cache, on a (16, 32, 16, 1024, 512) cache (2^32 elements a
    tensor). Untimed at R = 2 rows, for each S of S1024_SWEEP_S at head_dim
    32 and 64: K9 and K10 causal and not and at a negative scale, K1 in
    both modes and K11. Keys end in "[s1024]"."""
    C, H, L, T = 512, 16, 32, 16
    inp = Inputs(9, device)
    out = {"layer_norm": check_layer_norm(inp, C)}
    for qk_ln in (False, True):
        for N in (B, 2 * B, B * P):
            mode = "qk_ln," if qk_ln else ""
            out[f"spatial_block[{mode}N={N}]"] = check_spatial_block(
                inp, C, H, N, qk_ln=qk_ln)
    out.update(check_flash_mha(inp, H))
    R = TB * 16
    for causal in (False, True):
        tag = "[causal]" if causal else ""
        pairs = GRID * (GRID + 1) // 2 if causal else GRID * GRID
        exp_bound(out["flash_mha" + tag], R, H, pairs)
        exp_bound(out["flash_mha_bwd" + tag], R, H, pairs)
    torch.cuda.empty_cache()
    out.update(check_spatial_train_block(inp, C, H))
    torch.cuda.empty_cache()
    out.update(check_temporal_train_block(inp, C, H))
    out.update(check_mlp_train_block(inp, C))
    torch.cuda.empty_cache()
    out.update(check_temporal_attention(inp, C, H))
    out.update(check_temporal_attention_bwd(inp, C, H))
    torch.cuda.empty_cache()
    caches = (inp.normal(T, L, B, GRID, C), inp.normal(T, L, B, GRID, C))
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        out[name] = check_temporal_mlp_block(inp, C, H, L, caches, pair)
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, caches, None, pair))
    (kq, ks), (vq, vs) = quantize_cache(caches[0]), quantize_cache(caches[1])
    del caches
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, (kq, vq), (ks, vs),
                                          pair))
    del kq, vq, ks, vs
    torch.cuda.empty_cache()
    out.update(check_grid_sweep(inp))
    out = {f"{name}[s1024]": r for name, r in out.items()}
    return print_kernels(out)


def check_grid_sweep(inp, sizes=S1024_SWEEP_S):
    """The spatial kernels at every S of `sizes` and head_dim 32 (16 heads)
    and 64 (8 heads), untimed, R = 2 rows (frames): K9 and K10
    (`flash_case`) causal and not and non-causal at a negative scale, K1 in
    both modes and K11 (`both_paths`)."""
    out = {}
    for S_ in sizes:
        for H in (16, 8):
            C, D = 512, 512 // H
            tag = f"[S={S_},D={D}]"
            qkv = inp.normal(2, S_, 3, H, D)
            dout = inp.normal(2, S_, H, D)
            for causal, sc in ((False, D ** -0.5), (True, D ** -0.5),
                               (False, -D ** -0.5)):
                key = (f"flash_mha{tag}" + ("[causal]" if causal else "")
                       + ("[negative scale]" if sc < 0 else ""))
                err, grads = flash_case(key, qkv, dout, sc, causal)
                out[key] = dict(max_abs_err=err, grads=grads)
            del qkv, dout
            w = spatial_weights(inp, C)
            x = inp.normal(2, S_, C)
            kw = dict(num_heads=H, scale=D ** -0.5)
            for qk_ln in (False, True):
                wk = dict(w)
                if qk_ln:
                    wk.update(ln_scale=None, ln_bias=None,
                              qk_ln_scale=inp.normal(
                                  D, std=0.1, mean=1.0, dtype=torch.float32),
                              qk_ln_bias=inp.normal(D, std=0.1,
                                                    dtype=torch.float32))
                key = f"spatial_block{tag}" + ("[qk_ln]" if qk_ln else "")
                out[key] = dict(max_abs_err=compare(
                    key, spatial_block(x, **kw, **wk),
                    spatial_block_plain(x, **kw, **wk), 3e-2, 3e-2))
            t = dict(x=x, **{k: v.float() for k, v in w.items()})
            err, grads = both_paths(
                f"spatial_train_block{tag}",
                functools.partial(stb.spatial_train_block, **kw),
                functools.partial(stb.spatial_train_block_plain, **kw), t,
                inp.normal(2, S_, C), held=True)
            out[f"spatial_train_block_bwd{tag}"] = dict(max_abs_err=err,
                                                        grads=grads)
    return out


def check_grid_1024(device):
    """GENIE_138M-S1024 end to end (`genie_138m_s1024`), modelled on
    `check_window_32`, inside `grid_of`: every kernel form at S = 1024
    against its plain version and the sweep of S (`check_s1024_kernels`),
    then every entry point (`check_config_paths`): the rollout (B 16, 8 + 8
    frames) and ten train steps at full depth (32 layers), the step against
    the plain path at S1024_PLAIN_LAYERS, the rest at S1024_LAYERS."""
    cfg = genie_138m_s1024()
    walls = {}
    with grid_of(cfg):
        t0 = time.perf_counter()
        out = {"kernels": check_s1024_kernels(device)}
        walls["kernels"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        paths, path_walls = check_config_paths(
            genie_138m_s1024, "S = 1024", device, S1024_LAYERS,
            plain_layers=S1024_PLAIN_LAYERS)
    out.update(paths, phase_walls_s=dict(walls, **path_walls))
    return out


# -------------------------------------------------------- head_dim 128

H128_HEADS = 4  # GENIE_138M's width at 4 heads: head_dim 128
H128_LAYERS = 8  # the depth of the phase's secondary paths
# the token counts of K9's and K10's untimed checks at head_dim 128 (R = 4
# rows; 1024 at R = 2) besides the main path's 256
H128_SWEEP_N = (64, 192, 1024)


def genie_138m_h128(**overrides) -> GenieConfig:
    """GENIE_138M-h128: configs/genie_138m.json through
    `GenieConfig.from_pretrained` with 4 heads of 128 channels (32 layers,
    d_model 512, S 256, T 16 with 8 prompt frames, bf16 compute, fp32
    params): the head width of most public transformers at scale, and under
    muP (base 8 heads at d_model 256) half the base head count at twice its
    width, where the scale 8 / 128 differs from 128^-0.5. Same parameters,
    products, MLP and caches as GENIE_138M; only the attention's head width
    changes."""
    return dataclasses.replace(GenieConfig.from_pretrained(RT_CONFIG),
                               num_heads=H128_HEADS, **overrides)


def check_h128_kernels(device):
    """Every attention kernel form at head_dim 128 (C = 512, 4 heads), on
    the main path's shapes, held to its plain version by the gates of its
    head_dim-32 form (values, and every gradient where the TPU kernel has a
    backward), each timed with its bound and SDPA's time where SDPA
    computes the same function: K1 in both modes at N = 16 / 32 / 128 /
    256, K2 and K3, K7 and K8 (bf16 and int8 cache), K4 and K6 (causal and
    not; timed at the prefill's T = 8 and the train step's 16, untimed at
    T = 8 (K6) and 32 at B = TB), K9 and K10 at the qk_norm train step's
    (128, 256, 4, 128) (and at N = 64, 128, 192 and a negative scale), then
    untimed at H128_SWEEP_N causal, not and at a negative scale, K11 and
    K12. Keys end in "[h128]"."""
    C, H, L = 512, H128_HEADS, 32
    inp = Inputs(10, device)
    out = {}
    for qk_ln in (False, True):
        for N in (B, 2 * B, B * P, B * 16):
            mode = "qk_ln," if qk_ln else ""
            out[f"spatial_block[{mode}N={N}]"] = check_spatial_block(
                inp, C, H, N, qk_ln=qk_ln)
    T = 16
    caches = (inp.normal(T, L, B, 256, C), inp.normal(T, L, B, 256, C))
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        out[name] = check_temporal_mlp_block(inp, C, H, L, caches, pair)
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, caches, None, pair))
    (kq, ks), (vq, vs) = quantize_cache(caches[0]), quantize_cache(caches[1])
    del caches
    for pair in (False, True):
        out.update(check_decode_attention(inp, C, H, L, (kq, vq), (ks, vs),
                                          pair))
    del kq, vq, ks, vs
    torch.cuda.empty_cache()
    out.update(check_temporal_attention(inp, C, H))
    out.update(check_temporal_attention_bwd(inp, C, H))
    for T_ in (8, 32):
        for causal in (True, False):
            tag = f"[T={T_}" + ("]" if causal else ",non-causal]")
            out["temporal_attention" + tag] = temporal_case(
                inp, C, H, tag, TB, T_, causal, timed=False)
        out.update(check_temporal_attention_bwd(inp, C, H, T=T_,
                                                timed=False))
    torch.cuda.empty_cache()
    out.update(check_flash_mha(inp, H, D=C // H))
    D = C // H
    for n in H128_SWEEP_N:
        rows = 2 if n > 256 else 4
        qkv, dout = inp.normal(rows, n, 3, H, D), inp.normal(rows, n, H, D)
        for causal, sc in ((False, D ** -0.5), (True, D ** -0.5),
                           (False, -D ** -0.5)):
            key = (f"flash_mha[N={n}]" + ("[causal]" if causal else "")
                   + ("[negative scale]" if sc < 0 else ""))
            err, grads = flash_case(key, qkv, dout, sc, causal)
            out[key] = dict(max_abs_err=err, grads=grads)
    torch.cuda.empty_cache()
    out.update(check_spatial_train_block(inp, C, H))
    out.update(check_temporal_train_block(inp, C, H))
    torch.cuda.empty_cache()
    out = {f"{name}[h128]": r for name, r in out.items()}
    return print_kernels(out)


def check_head_dim_128(device):
    """GENIE_138M-h128 end to end (`genie_138m_h128`), modelled on
    `check_head_dim_64`: every head_dim-128 kernel form against its plain
    version (`check_h128_kernels`) and the decode batch sizes
    (`check_decode_batches`, 4 heads), then every entry point
    (`check_config_paths`): the rollout (B 16, 8 + 8 frames), ten train
    steps and the step against the plain path at full depth (32 layers),
    scores, the evaluator, the train CLI and the qk_norm int8 paths at
    H128_LAYERS; last a `use_mup` rollout and step at H128_LAYERS
    (`check_variant`: the attention scale 8 / 128 = 0.0625 where
    128^-0.5 = 0.0884)."""
    cfg = genie_138m_h128()
    walls = {}
    t0 = time.perf_counter()
    out = {"kernels": check_h128_kernels(device),
           "decode_batches": check_decode_batches(cfg.d_model, cfg.num_heads,
                                                  device)}
    print("head_dim 128 decode attention across batch sizes: " + json.dumps(
        out["decode_batches"]), flush=True)
    walls["kernels"] = time.perf_counter() - t0
    paths, path_walls = check_config_paths(genie_138m_h128, "head_dim 128",
                                           device, H128_LAYERS)
    out.update(paths)
    t0 = time.perf_counter()
    mup_cfg = genie_138m_h128(num_layers=H128_LAYERS, use_mup=True)
    if mup_cfg.width_mult != 2.0 or 8.0 / mup_cfg.head_dim != 0.0625:
        raise AssertionError(f"muP at head_dim 128: {mup_cfg}")
    out["mup"] = dict(width_mult=mup_cfg.width_mult,
                      scale=8.0 / mup_cfg.head_dim,
                      **check_variant(mup_cfg, device, 8, mu_transfer=True))
    print(f"head_dim 128 muP, {H128_LAYERS} layers: "
          + json.dumps(out["mup"]), flush=True)
    walls["mup"] = time.perf_counter() - t0
    out["phase_walls_s"] = dict(walls, **path_walls)
    return out


# ------------------------------------------------------- tokenizer training

# the card's fp32 step against the CPU's: 64 px, latents 8 x 8 x 18
TT_SMALL = VQConfig(resolution=64, base_channels=32, ch_mult=(1, 2, 2, 4),
                    z_channels=18, dtype="float32", disc_start=1)
TT_SMALL_B, TT_STEPS, TT_B, TT_TIMED = 4, 3, 8, 8
# cuDNN runs LPIPS's fp32 convolutions (TF32 off) as FFTs: `DSE::` kernels
# and complex (cf32) products
TT_KINDS = (("convolution", ("conv", "implicit_gemm", "fprop", "dgrad",
                             "wgrad", "cudnn", "nchwToNhwc", "nhwcToNchw",
                             "fft", "DSE::", "cf32cf32")),
            ("gemm", ("gemm", "xmma", "cutlass", "nvjet")),
            ("optimizer", ("multi_tensor_apply",)),
            ("reduction", ("reduce_kernel", "norm")),
            ("elementwise", ("elementwise", "CatArrayBatched", "index",
                             "copy")))


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
    """A quantizer that records the cotangent each step's backward sends to
    the latents; with `grads`, the latents take those (another run's) in
    its place, so that the encoder's backward starts from the same
    cotangent in both runs. The forward and the metrics stay this run's."""

    def __init__(self, quantizer, grads=None):
        self.quantizer, self.grads, self.seen = quantizer, grads, []

    def __call__(self, z, training=True):
        if self.grads is not None:
            z = _Cotangent.apply(z, self.grads[len(self.seen)].to(z.device))
        z.register_hook(lambda g: self.seen.append(g.detach().clone()))
        return self.quantizer(z, training=training)


def tokenizer_run(cfg, device, batches, lpips, cotangents=None, seed=3,
                  steer=None):
    """One micro-step a batch of a fresh state from `seed` (the same
    weights on every device) at lr 1e-4: metrics, every call's gradients,
    the latents' cotangents, the parameters before and the state after, and
    each call's parameters and Adam moments after its update (`after`).
    With `steer` (another run's result, the CPU's), the elements that
    `undecided` finds at a module's first update (its direction a
    rounding's) take `steer`'s parameters and Adam moments after that
    update, so that a rounding's ±lr there does not steer the later steps
    (`tokenizer_held` holds every other element)."""
    opt = functools.partial(build_tokenizer_optimizer, learning_rate=1e-4)
    state = tt.create_tokenizer_state(cfg, opt, opt, seed=seed, device=device)
    latents = Latents(state.model.quantizer, cotangents)
    state.model.quantizer = latents
    p0 = {}
    grads = {"gen": [], "disc": []}
    after = {"gen": [], "disc": []}
    for which, module, opt_ in (("gen", state.model, state.gen_opt),
                                ("disc", state.disc, state.disc_opt)):
        names = [n for n, _ in module.named_parameters()]
        p0[which] = {n: p.detach().clone()
                     for n, p in module.named_parameters()}
        real = opt_.step

        def record(g, which=which, names=names, real=real, opt_=opt_):
            call = {n: t.clone() for n, t in zip(names, g)}
            grads[which].append(call)
            real(g)
            if steer is not None:
                first = first_update(steer["grads"][which])
                if first == len(grads[which]) - 1:
                    mask = undecided_at(call, steer["grads"][which][first])
                    want = steer["after"][which][first]
                    with torch.no_grad():
                        for n, prm in zip(names, opt_.params):
                            m = mask[n].to(prm.device)
                            st = opt_.adam.state[prm]
                            for t, w in ((prm, want["p"][n]),
                                         (st["exp_avg"], want["m"][n]),
                                         (st["exp_avg_sq"], want["v"][n])):
                                t[m] = w.to(t.device)[m]
            after[which].append({
                "p": {n: prm.detach().clone()
                      for n, prm in zip(names, opt_.params)},
                "m": {n: opt_.adam.state[prm]["exp_avg"].clone()
                      for n, prm in zip(names, opt_.params)},
                "v": {n: opt_.adam.state[prm]["exp_avg_sq"].clone()
                      for n, prm in zip(names, opt_.params)}})
        opt_.step = record
    step = tt.make_tokenizer_train_step(cfg, lpips)
    metrics = []
    for b in batches:
        state, m = step(state, b.to(device))
        metrics.append(m)
    return dict(state=state, grads=grads, p0=p0, dz=latents.seen,
                after=after, metrics=[{k: float(v) for k, v in m.items()}
                                      for m in metrics])


def first_update(calls):
    """The index of the first call whose gradients are not all 0 (the
    discriminator's is at `disc_start`)."""
    return next(i for i, c in enumerate(calls)
                if any(g.any() for g in c.values()))


def undecided_at(got, want):
    """Of one call's gradients (`got`, `want`: {name: tensor}), the elements
    whose update's direction is a rounding's: `want`'s gradient is below
    1e-5 of its tensor's rms, or the two differ in sign."""
    return {k: (w.abs() < 1e-5 * w.square().mean().sqrt())
            | (torch.sign(got[k].cpu()) != torch.sign(w))
            for k, w in want.items()}


def undecided(got, want, which):
    """The elements whose first update's direction is a rounding's
    (`undecided_at` at `want`'s `first_update`). Adam's first update is lr
    g / (|g| + 1e-8), the sign of g, so there the two updates part by up
    to 2 lr whatever the rest does."""
    i = first_update(want["grads"][which])
    return undecided_at(got["grads"][which][i], want["grads"][which][i])


def tokenizer_held(got, want):
    """`got` (the card, from `want`'s latent cotangents) against `want`
    (the CPU): the first step's metrics within 1e-4 relative (1e-6
    absolute) and its gradient of every parameter within 1e-4 relative
    L2, as the CPU tests hold the port to JAX; after the first update,
    looser than those tests: the metrics within 1e-3, p - p0 after the
    steps within 1e-2 relative L2 (less `undecided`, at most 1e-3 of the
    elements), BatchNorm's running statistics, the LeCam EMAs and the EMA
    parameters within 1e-4. Adam's first update, lr g / |g|, moves the
    elements whose gradient is near 0 by a rounding's sign, and the
    per-sample entropy counts the latents near 0: on an H100 (700 W) the first
    gradients were 4.9e-6 apart, then the metrics up to 2.7e-4, the updates
    1.1e-3 (less 71 `undecided` elements), the EMA up to 7.8e-5. Returns
    the largest error of each kind (metrics relative to max(|want|,
    1e-2)); raises after all are taken if one is out."""
    worst, bad = tokenizer_errors(got, want)
    if bad:
        raise AssertionError(f"the card against the CPU: {bad}; {worst}")
    return worst


def tokenizer_errors(got, want):
    """`tokenizer_held`'s measures: (the largest error of each kind, the
    [(kind, where, error)] past their limits)."""
    worst = {"metric": 0.0, "grad": 0.0, "update": 0.0, "state": 0.0,
             "undecided": 0, "where": {}}
    bad = []

    def note(kind, err, where, limit):
        if err > worst[kind]:
            worst[kind], worst["where"][kind] = err, where
        if err > limit:
            bad.append((kind, where, err))

    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in w:
            note("metric", abs(g[k] - w[k]) / max(abs(w[k]), 1e-2),
                 f"step {i} {k}", 1e-4 if i == 0 else 1e-3)
    gs, ws = got["state"], want["state"]
    modules = {"gen": (gs.model, ws.model), "disc": (gs.disc, ws.disc)}
    for which, (gm, wm) in modules.items():
        for k, g in got["grads"][which][0].items():
            w = want["grads"][which][0][k]
            if not w.any():
                note("grad", float(g.abs().max()), f"{which} {k}", 0.0)
                continue
            note("grad", rel_l2(g.cpu(), w), f"{which} {k}", 1e-4)
        skip = undecided(got, want, which)
        worst["undecided"] += sum(int(m.sum()) for m in skip.values())
        wp = dict(wm.named_parameters())
        for k, p in gm.named_parameters():
            keep = ~skip[k]
            d_got = (p.detach().cpu() - got["p0"][which][k].cpu())[keep]
            d_want = (wp[k].detach() - want["p0"][which][k])[keep]
            note("update", rel_l2(d_got, d_want), f"{which} {k}", 1e-2)
    total = sum(p.numel() for m in modules.values()
                for p in m[1].parameters())
    if worst["undecided"] > 1e-3 * total:
        bad.append(("undecided", total, worst["undecided"]))
    wb = dict(ws.disc.named_buffers())
    pairs = [(k, b.cpu(), wb[k]) for k, b in gs.disc.named_buffers()
             if "running" in k]
    pairs += [("lecam real", gs.lecam.logits_real_ema.cpu(),
               ws.lecam.logits_real_ema),
              ("lecam fake", gs.lecam.logits_fake_ema.cpu(),
               ws.lecam.logits_fake_ema)]
    skip = undecided(got, want, "gen")
    pairs += [("ema " + k, v.cpu()[~skip[k]], ws.ema_params[k][~skip[k]])
              for k, v in gs.ema_params.items()]
    for k, g, w in pairs:
        note("state", float((g - w).abs().max()), k, 1e-4)
    return worst, bad


def group_rel_l2(got, want):
    """Relative L2 of the gradients of each parameter group (encoder,
    decoder, discriminator), each group's tensors taken as one vector."""
    out = {}
    for group, which, prefix in (("encoder", "gen", "encoder."),
                                 ("decoder", "gen", "decoder."),
                                 ("discriminator", "disc", "")):
        keys = [k for k in want[which][0] if k.startswith(prefix)]
        g = torch.cat([got[which][0][k].double().flatten() for k in keys])
        w = torch.cat([want[which][0][k].double().flatten() for k in keys])
        out[group] = float((g - w).norm() / w.norm())
    return out


def check_tokenizer_step_parity(device):
    """The card's fp32 step (TF32 off: the step turns cuDNN's off, and
    nothing turns the matmuls' on) against the CPU's at TT_SMALL, B =
    TT_SMALL_B, `disc_start` 1, random VGG-LPIPS:
    - the card's first step as it is: its metrics within 1e-4, its
      latents' cotangent within 1e-3 relative L2 (the LFQ entropy's
      gradient at temperature 0.01 cancels two ~1 terms per latent, times
      a = 2 z / T in the hundreds, so an ulp of tanh moves it; 5.7e-4 on
      an H100);
    - LPIPS's gradient alone (at the first two batches): within 2e-3
      relative L2. cuDNN's fp32 convolutions (FFTs with TF32 off) sum
      otherwise than the CPU's, 1e-4 to 8e-4 apart on an H100, and the
      decoder's gradients sum that coherently into ~3e-3;
    - three micro-steps with the perceptual term off (LPIPS being held on
      its own above), from the CPU's latent cotangents, by
      `tokenizer_held`; the `undecided` elements of each module's first
      update take the CPU's values after it (`tokenizer_run`'s `steer`).
      Without that, 1 run in 10 (and every run with deterministic cuDNN
      algorithms) let the generator's rounding-decided first update move
      the discriminator's next input enough to flip 144 more of its first
      gradients' signs, and its update lay 1.4-1.9e-2 from the CPU's
      (ROADMAP C8; `chip_variants.py c8`)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for fp32 matmuls")
    frames = synthetic_frames(TT_STEPS * TT_SMALL_B, TT_SMALL.resolution, 21)
    batches = list((torch.from_numpy(frames).float() / 127.5 - 1.0).split(
        TT_SMALL_B))
    lp_cpu = tt.build_lpips_apply("random", device="cpu")
    lp = tt.build_lpips_apply("random", device=device)
    cpu = tokenizer_run(TT_SMALL, "cpu", batches[:1], lp_cpu)
    own = tokenizer_run(TT_SMALL, device, batches[:1], lp)
    first = max(abs(own["metrics"][0][k] - v) / max(abs(v), 1e-2)
                for k, v in cpu["metrics"][0].items())
    dz = rel_l2(own["dz"][0].cpu(), cpu["dz"][0])
    grads = []
    for fn, dev in ((lp_cpu, "cpu"), (lp, device)):
        y = batches[1].to(dev).requires_grad_()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            grads.append(torch.autograd.grad(
                fn(batches[0].to(dev), y).mean(), y)[0].cpu())
    lpips_grad = rel_l2(grads[1], grads[0])
    if first > 1e-4 or dz > 1e-3 or lpips_grad > 2e-3:
        raise AssertionError(f"the card's first step: metrics {first}, "
                             f"latent cotangent {dz}, LPIPS's gradient "
                             f"{lpips_grad}")
    cfg = dataclasses.replace(TT_SMALL, perceptual_weight=0.0)
    cpu = tokenizer_run(cfg, "cpu", batches, None)
    held = tokenizer_held(tokenizer_run(cfg, device, batches, None,
                                        cotangents=cpu["dz"], steer=cpu), cpu)
    return {"first_step_metric_rel_err": first, "latent_cotangent_rel_l2": dz,
            "lpips_grad_rel_l2": lpips_grad, "from_cpu_cotangents": held}


def check_tokenizer_bf16(device, lpips):
    """bf16 against fp32 on the card at full width, B = 2, one step from
    the same weights: every loss within 3e-2 relative; the encoder's
    gradient, from the fp32 run's latent cotangent (so that it is the
    encoder's backward's), within 5e-2 relative L2; the decoder's and the
    discriminator's within 0.3. Those two pass through the model's kinks:
    a latent near 0 takes the other code in bf16, and L1's sign and the
    hinge flip where a difference or a logit sits at its kink; the JAX
    package's bf16 gradients are as far from its fp32 ones (16% for the
    decoder at the CPU tests' tiny config,
    `tests/test_torch_tokenizer_train.py`). The bf16 run as it is, the
    encoder's gradient from its own cotangent, is reported beside."""
    x = torch.from_numpy(synthetic_frames(2, VQ_CONFIG.resolution, 22))
    x = x.float() / 127.5 - 1.0
    fp32 = tokenizer_run(dataclasses.replace(VQ_CONFIG, dtype="float32"),
                         device, [x], lpips)
    bf16 = tokenizer_run(VQ_CONFIG, device, [x], lpips, cotangents=fp32["dz"])
    own = tokenizer_run(VQ_CONFIG, device, [x], lpips)
    w, g = fp32["metrics"][0], bf16["metrics"][0]
    losses = {k: abs(g[k] - w[k]) / abs(w[k]) for k in w
              if k.endswith("_loss") or k == "lecam"}
    out = {"loss_rel_err": losses,
           "metrics": {"float32": w, "bfloat16": g},
           "grad_rel_l2": group_rel_l2(bf16["grads"], fp32["grads"]),
           "own_grad_rel_l2": group_rel_l2(own["grads"], fp32["grads"]),
           "own_latent_cotangent_rel_l2": rel_l2(own["dz"][0], fp32["dz"][0])}
    grads = out["grad_rel_l2"]
    if (max(losses.values()) > 3e-2 or grads["encoder"] > 5e-2
            or grads["decoder"] > 0.3 or grads["discriminator"] > 0.3):
        raise AssertionError(f"bf16 against fp32: {out}")
    return out


def tokenizer_step_speed(cfg, device, x, lpips):
    """s/step (median of TT_TIMED synchronized steps after 2 untimed) and
    the peak memory over them, of a fresh state at `cfg` on batch `x`."""
    opt = functools.partial(build_tokenizer_optimizer, learning_rate=1e-4)
    state = tt.create_tokenizer_state(cfg, opt, opt, seed=4, device=device)
    step = tt.make_tokenizer_train_step(cfg, lpips)
    for _ in range(2):
        state, m = step(state, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TT_TIMED):
        t0 = time.perf_counter()
        state, m = step(state, x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not all(math.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"non-finite metrics at full width: {m}")
    return state, step, {"step_s": sorted(walls)[TT_TIMED // 2],
                         "step_s_runs": walls,
                         "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def check_tokenizer_speed_and_cli(device, lpips, root):
    """At `VQ_CONFIG` (bf16) and B = TT_B: s/step, images/s, peak memory,
    device time by kind and the busy share over two profiled steps, the
    LPIPS term's forward and backward alone, and the same step with
    `gen_loss_weight` 0.8 (the adaptive weight's cost). Then the CLI on 16
    synthetic frames (B 8, 4 micro-steps, accumulation 2, linear warm-up
    of 1 update, random LPIPS): its output loads and decodes to finite
    frames."""
    side = VQ_CONFIG.resolution
    frames = synthetic_frames(16, side, 23)
    x = torch.from_numpy(frames[:TT_B]).to(device).float() / 127.5 - 1.0
    state, step, out = tokenizer_step_speed(VQ_CONFIG, device, x, lpips)
    out["images_per_s"] = TT_B / out["step_s"]

    def two():
        for _ in range(2):
            step(state, x)
    prof = profile_device(two, top=10, kinds=TT_KINDS)
    out["profile_two_steps"] = {k: prof[k] for k in (
        "wall_ms", "device_ms", "busy_share", "by_kind", "top")}
    del state, step
    torch.cuda.empty_cache()
    y = x.clone().requires_grad_()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out["lpips_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lpips(x, y).mean(), y), iters=5, warmup=1)
    _, _, fixed = tokenizer_step_speed(
        dataclasses.replace(VQ_CONFIG, gen_loss_weight=0.8), device, x, lpips)
    out["fixed_weight"] = fixed
    out["adaptive_weight_s"] = out["step_s"] - fixed["step_s"]
    torch.cuda.empty_cache()

    np.save(root / "tt_frames.npy", frames)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tt.main(["--images_npy", str(root / "tt_frames.npy"), "--output_dir",
                 str(root / "tt_tok"), "--batch_size", str(TT_B),
                 "--max_train_steps", "4", "--accumulate_grad_batches", "2",
                 "--scheduler_type", "linear-warmup", "--warmup_steps", "1",
                 "--lpips_ckpt", "random", "--device", str(device)])
    wall = time.perf_counter() - t0
    log = buf.getvalue().splitlines()
    sd, cfg = load_tokenizer(root / "tt_tok")
    model = vq_model(cfg, sd, device, cfg.dtype)
    with torch.no_grad():
        ids = model.encode(x).indices
        dec = model.decode_tokens(ids)
    if not (cfg.resolution == side and log[0].startswith("step 0 gen ")
            and log[-1] == f"saved tokenizer to {root / 'tt_tok'}"
            and dec.shape == x.shape and torch.isfinite(dec).all()):
        raise AssertionError(f"train_tokenizer CLI: {log}, {dec.shape}")
    out["cli"] = {"wall_s": wall, "log": log}
    return out


def check_tokenizer_training(device):
    """The tokenizer's GAN training: `check_tokenizer_step_parity`,
    `check_tokenizer_bf16`, `check_tokenizer_speed_and_cli`. The counters
    are set to 0 at its start and must read 0 at its end: this path
    launches no kernel of the port."""
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {"parity": check_tokenizer_step_parity(device)}
    print("tokenizer training parity: " + json.dumps(out["parity"]),
          flush=True)
    lpips = tt.build_lpips_apply("random", device=device)
    out["bf16_vs_fp32"] = check_tokenizer_bf16(device, lpips)
    print("tokenizer training bf16 against fp32: " + json.dumps(
        out["bf16_vs_fp32"]), flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["speed"] = check_tokenizer_speed_and_cli(device, lpips, Path(tmp))
    print("tokenizer training speed: " + json.dumps(out["speed"]),
          flush=True)
    torch.cuda.synchronize()
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"tokenizer training launched {kernels.LAUNCHES}")
    out["launches"] = dict(kernels.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------- training runtime



def vis_per_layer(T):
    """One visualize call: the prefill of T / 2 frames, then T / 2 new
    frames of 2 MaskGIT decodes and a commit each (generate_cached,
    unfused: no K3)."""
    new = T - T // 2
    return {"spatial_block": 1 + 3 * new, "temporal_mlp_block": 3 * new,
            "temporal_attention": 1, "layer_norm": 1}


VIS_PER_LAYER = vis_per_layer(16)
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
DDP_LAYERS = 8  # the world-size-1 DDP / FSDP2 check's depth
RT_LAYERS = 8  # the GENIE_138M train CLI's depth


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


def check_cli_run(cfg, device, root, config=RT_CONFIG):
    """Phases 1 to 3 of the runtime: the CLI on the config file `config`
    (`cfg` is what it holds), its resume and its exports (see
    `check_training_runtime`)."""
    ds = synthetic_dataset(cfg, root / "data")
    common = ["--train_data_dir", str(root / "data"), "--val_data_dir",
              str(root / "data"), "--genie_config", str(config),
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
                str(final), "--window_size", str(cfg.T), "--stride", "1",
                "--batch_size", str(B), "--max_examples", str(B), "--device",
                str(device)]),
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


def check_world_size_one(device, layers=DDP_LAYERS):
    """One process group of world size 1 over NCCL: one update of
    GENIE_138M (B = CB, at `layers` layers: a check of the wrappers, no
    metric) through DDP and one through FSDP2,
    each against the unwrapped step from the same weights, batch and
    draws: exact launch counts, the loss (within 2e-2), the gradient norm
    (5e-2 relative) and each parameter's update (within 3e-2 relative L2,
    the step gates); no warning of DDP about gradient strides (the fused
    blocks return weight gradients through transposed views). Then an FSDP2
    `Checkpointer` save and restore into a fresh sharded state, bit for
    bit."""
    import warnings
    cfg = genie_138m(num_layers=layers)
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


def check_training_runtime(device, layers=RT_LAYERS):
    """The training runtime (`tpu1x_torch.train`), in a temporary directory
    that it removes: the CLI on configs/genie_138m.json cut to `layers`
    layers (written beside, as the GENIE_35M and head_dim-64 phases do),
    its resume and exports (`check_cli_run`), DDP and FSDP2 at world size 1
    (`check_world_size_one`), remat (`check_remat`) and dropout
    (`check_dropout`)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cut = dataclasses.replace(GenieConfig.from_pretrained(RT_CONFIG),
                                  num_layers=layers)
        cut.save_pretrained(Path(tmp) / "genie_138m.json")
        out["cli"] = check_cli_run(cut, device, Path(tmp),
                                   Path(tmp) / "genie_138m.json")
        out["cli"]["phase_s"] = time.perf_counter() - t0
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


# ---- tensor parallelism: two ranks on the one card, joined over gloo
TP_LAYERS, TP_ROWS_ROLLOUT, TP_NEW = 8, 16, 2
# AdamW's eps at 1, above every element of the clipped gradient (its norm
# is at most 1), so that the first update is a smooth function of the
# gradient: with 1e-8 it is the sign of each element, and an element near 0
# that two bf16 paths round apart flips (a LayerNorm weight's update then
# parts by 0.29 relative L2 at a loss equal to 1e-7, measured on one H100)
TP_OPT = dict(learning_rate=TRAIN_LR, max_grad_norm=1.0, eps=1.0)
# launches per layer and rank in one TP step: the spatial sub-layer
# launches K9 forward and again in its backward (the recompute), with K10;
# the temporal one K4 forward and K6 backward. Under qk_norm (remat
# "attn_outs") the MLP sub-layer's forward runs again in the recompute, and
# so do the two attentions' row-parallel proj products (op by op).
TP_PER_LAYER = {"tp_spatial_train_block": 1, "tp_spatial_train_block_bwd": 1,
                "tp_temporal_train_block": 1,
                "tp_temporal_train_block_bwd": 1, "tp_mlp_train_block": 1,
                "tp_mlp_train_block_bwd": 1, "flash_mha": 2,
                "flash_mha_bwd": 1, "temporal_attention": 1,
                "temporal_attention_bwd": 1}
TP_PER_LAYER_QK = {"flash_mha": 1, "flash_mha_bwd": 1,
                   "tp_mlp_train_block": 2, "tp_mlp_train_block_bwd": 1,
                   "tp_row_parallel": 4, "tp_row_parallel_bwd": 2,
                   "tp_column_parallel_bwd": 2}
# the kernels line's rows and the counter of the TP path that launches each
# row's launch sequence at a rank's shapes (K1 has none: a rank runs its
# parts, `tp_spatial_train_block`)
TP_COUNTERS = {"spatial_train_block_bwd": "tp_spatial_train_block_bwd",
               "temporal_train_block": "tp_temporal_train_block",
               "temporal_train_block_bwd": "tp_temporal_train_block_bwd",
               "mlp_train_block": "tp_mlp_train_block",
               "mlp_train_block_bwd": "tp_mlp_train_block_bwd",
               "flash_mha": "flash_mha", "flash_mha_bwd": "flash_mha_bwd",
               "temporal_attention": "temporal_attention",
               "temporal_attention_bwd": "temporal_attention_bwd"}
TP_ARCHS = ("pre_ln", "qk_norm")
# the TP phase's model groups: GENIE_138M over 2 ranks (8 heads and 256
# columns a rank), GENIE_35M over 4 (2 heads and 64 columns a rank: K4's
# and K6's head groups of 2), GENIE_138M-h64 and -h128 over 2 (4 heads of
# 64 and 2 of 128 a rank), each at TP_LAYERS layers
TP_SETUPS = (("genie_138m", genie_138m, 2), ("genie_35m", genie_35m, 4),
             ("genie_138m_h64", genie_138m_h64, 2),
             ("genie_138m_h128", genie_138m_h128, 2))
# the gradient norm a rank's optimizer reads against one process's norm of
# the same gradients (`watch_norm`): the two sum the same squares in fp32
# in another order (0 to 1e-7 apart on an H100). Leaving the split
# parameters' squares unsummed over the model group takes (tp - 1) / tp of
# their share of the squared norm away: 1.1e-5 to 2.1e-5 of the norm on
# pre-LN at random init, where the embeddings and the head carry most of it
TP_NORM_RTOL = 2e-6


def tp_inputs(device, make=genie_138m, tp=2):
    """What every rank and the one-process run start from: the model
    group's size `tp`; per model (TP_LAYERS layers of `make`'s config,
    pre-LN and qk_norm) its config, seeded weights, a batch of TB and its
    corruption draws; and a rollout prompt."""
    out = {"tp": tp}
    for i, arch in enumerate(TP_ARCHS):
        cfg = make(num_layers=TP_LAYERS, qk_norm=arch == "qk_norm")
        g = torch.Generator(device=device).manual_seed(20 + i)
        model = STMaskGIT(cfg, device=device).init_weights(g)
        side = cfg.latent_side_len
        tokens = torch.randint(0, cfg.image_vocab_size,
                               (TB, cfg.T, side, side), generator=g,
                               device=device)
        noise = draw_noise(tokens.shape, cfg, g, device)
        out[arch] = dict(cfg=cfg, tokens=tokens.cpu(),
                         init={k: v.cpu() for k, v in
                               model.state_dict().items()},
                         noise={k: v.cpu() for k, v in noise.items()})
        del model
    cfg = out["pre_ln"]["cfg"]
    side = cfg.latent_side_len
    out["prompt"] = torch.randint(
        0, cfg.image_vocab_size, (TP_ROWS_ROLLOUT // 2, cfg.T - TP_NEW, side,
                                  side), generator=g, device=device).cpu()
    return out


def tp_per_layer(arch, split):
    if split:
        return TP_PER_LAYER if arch == "pre_ln" else TP_PER_LAYER_QK
    return TRAIN_PER_LAYER if arch == "pre_ln" else REMAT_QK["attn_outs"]


def tp_update(arch, inp, device, tp=1, oracle=None, fsdp=False):
    """One update of `arch` from its initial weights through
    `make_train_step` (split over the group's model axis where tp > 1,
    with FSDP2 over its data axis where `fsdp`), with exact launch counts
    on the card; with `oracle` "fp32" or "bf16", the plain path's in that
    dtype without remat, which launches nothing. Returns (metrics,
    launches, whole parameters after, the step's state)."""
    cfg = inp["cfg"]
    if oracle is not None:
        cfg = dataclasses.replace(cfg, remat=False, dtype="float32"
                                  if oracle == "fp32" else cfg.dtype)
    m = STMaskGIT(cfg, device=device)
    m.load_state_dict(inp["init"])
    state = TrainState(0, m, TrainOptimizer(m, cfg, **TP_OPT),
                       torch.Generator(device=device).manual_seed(5))
    if tp > 1:
        state = shard_train_state(state, device, fsdp=fsdp, tp=tp)
        watch_norm(state)
    step = make_train_step(state.model, state.optimizer, cfg, device=device,
                           generator=state.generator)
    # this data rank's rows of the batch; the draws are the global batch's
    rows = data_rows(inp["tokens"].shape[0], mesh_of(state.model))
    tokens = inp["tokens"][rows].to(device)
    noise = {k: v.to(device) for k, v in inp["noise"].items()}
    run = functools.partial(step, tokens, noise=noise)
    if oracle is not None:
        with plain_blocks():
            r, launches = run(), {}
    elif device.type == "cuda":
        r, launches = launches_of(run, tp_per_layer(arch, tp > 1),
                                  cfg.num_layers, f"tp={tp} {arch} step")
    else:
        r, launches = run(), {}
    whole = {k: v.detach().float().cpu()
             for k, v in full_state_dict(step.state.model).items()}
    metrics = {k: float(v) for k, v in r.items()}
    if tp > 1:
        metrics["grad_norm_whole"] = float(state.optimizer.norm_whole)
    return metrics, launches, whole, step.state


def watch_norm(state):
    """Have `state.optimizer` record, at its first norm, what one process's
    `TrainOptimizer` reads from the same gradients (`norm_whole`): the
    split gradients gathered whole over the model group (and FSDP2's
    shards over the data group), the norms of the whole tensors, their
    norm, in fp32 as one process takes it. The norm the optimizer returns
    under tensor parallelism sums the split parameters' squares over the
    model group; without that sum it reads only its own shards'."""
    from tpu1x_torch.parallel.sharding import gather_split, unwrap
    from tpu1x_torch.parallel.tensor import is_split
    opt, m = state.optimizer, mesh_of(state.model)
    model = unwrap(state.model)
    names = {id(p): n for n, p in model.named_parameters()}
    heads, real = model.config.num_heads, opt._norm

    def norm(local):
        if not hasattr(opt, "norm_whole"):
            whole = []
            for p in opt.params:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = g.full_tensor() if hasattr(g, "full_tensor") else g
                n = names[id(p)]
                whole.append(gather_split(n, g, m, heads) if is_split(n)
                             else g)
            opt.norm_whole = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(whole)))
        return real(local)
    opt._norm = norm


def tp_rollouts(init, cfg, prompt, device, mesh=None):
    """The rollout of TP_ROWS_ROLLOUT rows (two futures a prompt), TP_NEW
    new frames, at temperature 0 and 1, over `mesh`'s ranks or one
    process."""
    out = {}
    for temperature in (0.0, 1.0):
        engine = RolloutEngine(init, cfg, device=device,
                               temperature=temperature, mesh=mesh)
        out[temperature] = engine.rollout(
            prompt.to(device), TP_NEW,
            torch.Generator(device=device).manual_seed(7),
            num_futures=2).cpu()
    return out


def tp_sub_layer(name, m, heads, run_tp, run_plain, whole, params, dout):
    """A TP sub-layer alone on this rank's shares, forward and backward:
    its output (summed over the model group inside) and every gradient,
    the split ones gathered whole, against the whole layer's plain version
    on the same whole tensors, by `both_paths`' gates. `params` names the
    parameter each weight argument is (for the split rule)."""
    from tpu1x_torch.parallel import tensor as tpl
    from tpu1x_torch.parallel.sharding import gather_split

    def split(k):
        return k in params and tpl.is_split(params[k])
    local = {k: (tpl.shard_tensor(params[k], v, m.model_index, m.tp, heads)
                 if split(k) else v).detach().clone().requires_grad_(True)
             for k, v in whole.items()}
    out = run_tp(**local)
    grads = dict(zip(local, torch.autograd.grad(out, list(local.values()),
                                                dout)))
    grads = {k: gather_split(params[k], g, m, heads) if split(k) else g
             for k, g in grads.items()}
    leaves = leaves_of(whole)
    want = run_plain(**leaves)
    wgrads = dict(zip(leaves, torch.autograd.grad(
        want, list(leaves.values()), dout)))
    try:
        return {"out": compare(name, out, want, 3e-2, 3e-2),
                "grads": {k: grad_errors(f"{name} d{k}", grads[k], wgrads[k])
                          for k in whole}}
    except AssertionError as e:  # the parent reports it with the rest
        return {"failed": str(e)}


def tp_sub_layers(cfg, m, device):
    """The three TP sub-layers (the MLP with and without LN) at the train
    step's shapes, each on this rank's share, against the whole plain
    layer; the same draws on every rank."""
    from tpu1x_torch.parallel import tensor as tpl
    inp = Inputs(31, device)
    C, H, S, T = cfg.d_model, cfg.num_heads, cfg.S, cfg.T
    N, F4 = TB * T, 4 * cfg.d_model
    kw = dict(scale=(C // H) ** -0.5)

    def w(*shape, std=0.05):
        return inp.normal(*shape, std=std, dtype=torch.float32)
    out = {}
    x = inp.normal(N, S, C)
    whole = dict(x=x, wqkv=w(3 * C, C), wproj=w(C, C), bproj=w(C, std=0.1),
                 ln_scale=w(C, std=0.1) + 1, ln_bias=w(C, std=0.1))
    out["tp_spatial_train_block"] = tp_sub_layer(
        "tp_spatial_train_block", m, H,
        lambda x, wqkv, wproj, bproj, ln_scale, ln_bias:
            tpl.tp_spatial_train_block(
                x, wqkv.t(), wproj.t(), num_heads=H // m.tp, mesh=m,
                bproj=bproj, ln_scale=ln_scale, ln_bias=ln_bias, **kw),
        lambda x, wqkv, wproj, bproj, ln_scale, ln_bias:
            stb.spatial_train_block_plain(
                x, wqkv.t(), wproj.t(), num_heads=H, bproj=bproj,
                ln_scale=ln_scale, ln_bias=ln_bias, **kw),
        whole, {"wqkv": "spatial_attn.qkv.weight",
                "wproj": "spatial_attn.proj.weight"}, inp.normal(N, S, C))
    whole = dict(x=inp.normal(TB, T, S, C), wqkv=w(3 * C, C), wproj=w(C, C),
                 bproj=w(C, std=0.1))
    out["tp_temporal_train_block"] = tp_sub_layer(
        "tp_temporal_train_block", m, H,
        lambda x, wqkv, wproj, bproj: tpl.tp_temporal_train_block(
            x, wqkv.t(), wproj.t(), num_heads=H // m.tp, mesh=m,
            bproj=bproj, **kw),
        lambda x, wqkv, wproj, bproj: ttb.temporal_train_block_plain(
            x, wqkv.t(), wproj.t(), num_heads=H, bproj=bproj, **kw),
        whole, {"wqkv": "temporal_attn.qkv.weight",
                "wproj": "temporal_attn.proj.weight"},
        inp.normal(TB, T, S, C))
    for ln in (True, False):
        whole = dict(x=inp.normal(N, S, C), wfc1=w(F4, C), wfc2=w(C, F4),
                     bfc1=w(F4, std=0.1), bfc2=w(C, std=0.1))
        if ln:
            whole.update(ln_scale=w(C, std=0.1) + 1, ln_bias=w(C, std=0.1))
        out["tp_mlp_train_block" + ("" if ln else "[no LN]")] = tp_sub_layer(
            "tp_mlp_train_block", m, H,
            lambda x, wfc1, wfc2, **rest: tpl.tp_mlp_train_block(
                x, wfc1.t(), wfc2.t(), mesh=m, **rest),
            lambda x, wfc1, wfc2, **rest: mtb.mlp_train_block_plain(
                x, wfc1.t(), wfc2.t(), **rest),
            whole, {"wfc1": "mlp.fc1.weight", "bfc1": "mlp.fc1.bias",
                    "wfc2": "mlp.fc2.weight"}, inp.normal(N, S, C))
    return out


def tp_rank(rank: int, port: int, tmp: str, device: str) -> int:
    """One of the TP phase's ranks (`chip_smoke.py --tp-rank R PORT DIR
    DEVICE`; the group's size is the inputs' `tp`): the update of each
    model split over the group, the sub-layers and the rollout; writes its
    results to DIR/rank{R}.pt."""
    device = torch.device(device)
    inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    init_distributed(str(device), f"tcp://localhost:{port}", inputs["tp"],
                     rank, backend="gloo")
    try:
        res = {}
        for arch in TP_ARCHS:
            metrics, launches, whole, state = tp_update(
                arch, inputs[arch], device, tp=inputs["tp"])
            res[arch] = dict(metrics=metrics, launches=launches,
                             params=whole)
            mesh = mesh_of(state.model)
            del state
        res["sub_layers"] = tp_sub_layers(inputs["pre_ln"]["cfg"], mesh,
                                          device)
        res["rollouts"] = tp_rollouts(inputs["pre_ln"]["init"],
                                      inputs["pre_ln"]["cfg"],
                                      inputs["prompt"], device, mesh)
        torch.save(res, Path(tmp) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def check_tensor_parallel(device):
    """Tensor parallelism (`parallel/tensor.py`) on the one card: K4 and K6
    at C = 128 (4 heads, their head groups of 4) and C = 64 (2 heads, head
    groups of 2) against their plain versions; then for each of TP_SETUPS
    (GENIE_138M over tp = 2 ranks, GENIE_35M over tp = 4) tp child
    processes, all on this card, joined over gloo as one model group (dp =
    1; NCCL refuses two ranks on one device): each splits the model at
    TP_LAYERS layers, pre-LN and qk_norm, and takes one update with exact
    launch counts per rank, held by `tp_compare` to this process's update
    from the same weights, batch and draws and to the oracles, its gradient
    norm to one process's norm of the same gradients; runs each TP
    sub-layer alone against the whole plain layer (`both_paths`' gates);
    and the rollout of 16 rows over the ranks, token for token this
    process's. The wall is ranks sharing one card with the all-reduces
    through the host: no TP speed."""
    out = {"c128": {
        **check_temporal_attention(Inputs(40, device), 128, 4),
        **check_temporal_attention_bwd(Inputs(41, device), 128, 4)},
        "c64": {
        **check_temporal_attention(Inputs(42, device), 64, 2),
        **check_temporal_attention_bwd(Inputs(43, device), 64, 2)}}
    for name, make, tp in TP_SETUPS:
        out[name] = tp_setup(name, make, tp, device)
    return out


def tp_setup(name, make, tp, device):
    """One of TP_SETUPS: `make`'s models split over `tp` child processes
    (`--tp-rank`) on this card, held by `tp_compare`; prints its line."""
    t0 = time.perf_counter()
    inputs = tp_inputs(device, make, tp)
    refs, rollouts = tp_references(inputs, device)
    ranks, wall = tp_children(
        inputs, tp, lambda r, port, tmp: [
            str(Path(__file__).resolve()), "--tp-rank", str(r), str(port),
            tmp, str(device)])
    out = dict(tp=tp, ranks_wall_s=wall,
               **tp_compare(inputs, refs, ranks, rollouts))
    out["setup_wall_s"] = time.perf_counter() - t0
    print(f"tensor parallelism {name}, tp={tp}: " + json.dumps(
        tp_summary(out)), flush=True)
    return out


def tp_references(inputs, device):
    """This process's references for each model: the update at tp = 1
    ("one", on the kernels), the plain path's in bf16 ("bf16") and in fp32
    ("fp32"), each without remat; and the one-process rollouts."""
    refs = {}
    for arch in TP_ARCHS:
        for name, oracle in (("one", None), ("bf16", "bf16"),
                             ("fp32", "fp32")):
            metrics, _, whole, state = tp_update(arch, inputs[arch], device,
                                                 oracle=oracle)
            refs.setdefault(arch, {})[name] = dict(metrics=metrics,
                                                   params=whole)
            del state
    rollouts = tp_rollouts(inputs["pre_ln"]["init"], inputs["pre_ln"]["cfg"],
                           inputs["prompt"], device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return refs, rollouts


def tp_children(inputs, n, argv, env=None):
    """Start `n` rank processes (`argv(rank, port, dir)`, the arguments
    after the interpreter; `env(rank)` their environment) on `inputs`
    saved in a temporary directory, wait for them (600 s) and return
    (each rank's results, the wall)."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(inputs, Path(tmp) / "inputs.pt")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, *argv(r, port, tmp)],
            env=None if env is None else env(r), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"TP rank {r} failed:\n{log[-6000:]}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n)], wall


def tp_distance(a, b) -> float:
    """rel_l2, with an update that stays 0 (a parameter that does not
    train) 0 from another 0 and infinitely far from anything else."""
    if not b.any():
        return 0.0 if not a.any() else math.inf
    return rel_l2(a, b)


def tp_update_gates(init, got, ref):
    """The update of a TP run (`got`, whole parameters) against this
    process's references `ref` ("one", "bf16", "fp32"), each an update
    from the whole initial parameters `init`. Returns (results, failures).

    - All parameters' updates as one vector: within 3e-2 relative L2 of one
      process's, and no farther from fp32 than 1.25x one process + 1e-3.
    - Each parameter's update: no farther from fp32 than its kind's
      envelope (a kind: the parameters that share a name but for the
      layer's number), 1.25x the farthest of the kind's one-process
      updates, kernel or plain bf16 path, from fp32, + 1e-3. At this
      initialisation single weights' gradients cancel over the batch, and
      two bf16 paths that round at other points part there by up to 20%;
      a tensor's own one-process distance is one draw of that, and TP's
      can be 2.8x it on a correct run (qk_norm's spatial attention weights,
      on one H100), so each tensor is held to its kind's widest draw.
    - The loss within 2e-2, the gradient norm within 5e-2 relative of one
      process's update (two bf16 paths' gradients).
    - The gradient norm the optimizer read within TP_NORM_RTOL of one
      process's norm of the same gradients (`watch_norm`)."""
    def update(res, k=None):
        if k is None:  # every parameter's, as one vector
            return torch.cat([update(res, n).reshape(-1) for n in init])
        return res["params"][k] - init[k].float()

    def kind(k):
        return re.sub(r"\.\d+\.", ".#.", k)
    one, bf16, fp32 = ref["one"], ref["bf16"], ref["fp32"]
    per, widest = {}, {}
    for k in init:
        u, o, b, f = (update(r, k) for r in (got, one, bf16, fp32))
        per[k] = dict(tp_one=tp_distance(u, o), tp_fp32=tp_distance(u, f),
                      one_fp32=tp_distance(o, f),
                      bf16_fp32=tp_distance(b, f))
        widest[kind(k)] = max(widest.get(kind(k), 0.0), per[k]["one_fp32"],
                              per[k]["bf16_fp32"])
    for k, d in per.items():
        d["envelope"] = 1.25 * widest[kind(k)] + 1e-3
    flat = (rel_l2(update(got), update(one)), rel_l2(update(got),
                                                     update(fp32)),
            rel_l2(update(one), update(fp32)))
    over = {k: d for k, d in per.items() if not d["tp_fp32"] <= d["envelope"]}
    gm, wm = got["metrics"], one["metrics"]
    res = dict(metrics=gm, one_process=wm, bf16=bf16["metrics"],
               fp32=fp32["metrics"], update_rel_l2=flat,
               per_parameter_over=over,
               nearest_envelope=sorted(
                   per.items(), key=lambda kv: -kv[1]["tp_fp32"]
                   / kv[1]["envelope"])[:5],
               tightest_envelope=min(per.items(),
                                     key=lambda kv: kv[1]["envelope"]),
               per_parameter=per)
    failed = []
    if not (flat[0] <= 3e-2 and flat[1] <= 1.25 * flat[2] + 1e-3):
        failed.append(f"all parameters' update {flat}")
    if over:
        failed.append(f"parameters past their envelopes {over}")
    if not (abs(gm["loss"] - wm["loss"]) <= 2e-2
            and abs(gm["grad_norm"] / wm["grad_norm"] - 1) <= 5e-2):
        failed.append(f"loss or gradient norm {gm} against {wm}")
    res["grad_norm_vs_whole"] = abs(gm["grad_norm"] / gm["grad_norm_whole"]
                                    - 1)
    if not res["grad_norm_vs_whole"] <= TP_NORM_RTOL:
        failed.append(f"the gradient norm read {gm['grad_norm']!r} against "
                      f"one process's norm of the same gradients "
                      f"{gm['grad_norm_whole']!r}")
    return res, failed


def tp_compare(inputs, refs, ranks, rollouts):
    """The TP runs' results (`ranks`, each rank's: one entry per run,
    named by its model, "+fsdp" where FSDP2 shards the data axis too)
    against this process's (`refs`, `rollouts`; `tp_references`): each
    update by `tp_update_gates` (rank 0's parameters), every rank's
    parameters equal to rank 0's bit for bit (the split ones are gathered,
    so this holds the replicated ones: LayerNorms, biases after a
    row-parallel product, embeddings, head), the ranks' metrics equal, the
    sub-layers' gates, the rollout token for token. Raises listing every
    failure."""
    out, failed = {}, []
    runs = [k for k in ranks[0] if k.split("+")[0] in TP_ARCHS]
    for run in runs:
        arch = run.split("+")[0]
        res, bad = tp_update_gates(inputs[arch]["init"], ranks[0][run],
                                   refs[arch])
        failed += [f"TP {run}: {b}" for b in bad]
        res["launches"] = [r[run]["launches"] for r in ranks]
        apart = sorted({k for r in ranks[1:]
                        for k, v in r[run]["params"].items()
                        if not torch.equal(v, ranks[0][run]["params"][k])})
        res["ranks_apart"] = apart
        if apart:
            failed.append(f"TP {run}: the ranks' parameters differ: {apart}")
        if any(r[run]["metrics"] != res["metrics"] for r in ranks):
            failed.append(f"TP {run}: the ranks' metrics differ")
        out[run] = res
    if "sub_layers" in ranks[0]:
        out["sub_layers"] = ranks[0]["sub_layers"]
        failed += [f"rank {r} {k}: {v['failed']}"
                   for r, rank in enumerate(ranks)
                   for k, v in rank["sub_layers"].items() if "failed" in v]
    differ = {f"temperature {t}, rank {r}": int(
        (rank["rollouts"][t] != want).sum())
        for t, want in rollouts.items() for r, rank in enumerate(ranks)}
    out["rollout"] = dict(rows=TP_ROWS_ROLLOUT, new_frames=TP_NEW,
                          tokens_apart=differ)
    if any(differ.values()):
        failed.append(f"TP rollout not the one-process tokens: {differ}")
    if failed:
        raise AssertionError("; ".join(failed) + f"; {tp_summary(out)}")
    return out


def tp_summary(out):
    """`tp_compare`'s results without the per-parameter tables (for a
    line of output)."""
    return {k: {kk: vv for kk, vv in v.items() if kk != "per_parameter"}
            if isinstance(v, dict) else v for k, v in out.items()}


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
        t0 = time.perf_counter()
        mup = check_mup(device)
        print(f"muP, {MUP_LAYERS} layers: " + json.dumps(mup), flush=True)
        print(f"muP phase: {time.perf_counter() - t0:.1f} s", flush=True)

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

        tok_train = check_tokenizer_training(device)
        ts = tok_train["speed"]
        print(f"tokenizer training phase: {tok_train['phase_s']:.1f} s; at "
              f"B={TT_B} ({VQ_CONFIG.resolution} px, base "
              f"{VQ_CONFIG.base_channels}, {VQ_CONFIG.dtype}) "
              f"{ts['step_s']:.4f} s/step, {ts['images_per_s']:.1f} "
              f"images/s, peak {ts['peak_memory_bytes'] / 2**30:.2f} GiB, "
              f"busy {ts['profile_two_steps']['busy_share']:.3f}; "
              f"gen_loss_weight 0.8 {ts['fixed_weight']['step_s']:.4f} "
              f"s/step (the adaptive weight {ts['adaptive_weight_s']:.4f} "
              f"s); the CLI {ts['cli']['wall_s']:.1f} s on {card}",
              flush=True)

        t0 = time.perf_counter()
        runtime = check_training_runtime(device)
        rt_cli = runtime["cli"]
        print("training runtime: " + json.dumps(runtime), flush=True)
        print(f"training runtime phase: {time.perf_counter() - t0:.1f} s; "
              f"the train CLI at {RT_LAYERS} layers "
              f"{rt_cli['s_per_update']:.4f} s/update "
              f"({TB} x {RT_ACCUMULATE} examples, "
              f"{rt_cli['examples_per_s']:.1f} examples/s), busy "
              f"{rt_cli['busy_updates_4_5']['busy_share']:.3f} over two "
              f"updates; remat peaks " + ", ".join(
                  f"{k} {v['peak_memory_bytes']} B {v['step_s']:.4f} s"
                  for k, v in runtime["remat"].items()
                  if isinstance(v, dict)) + f" on {card}", flush=True)

        t0 = time.perf_counter()
        g35 = check_genie_35m(device)
        w35 = g35["phase_walls_s"]
        print(f"genie_35m phase: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in w35.items())
              + f"); rollout {g35['rollout']['s_per_frame']:.4f} s/frame at "
              f"B={B}; train step {g35['training']['step_s']:.4f} s, peak "
              f"{g35['training']['peak_memory_bytes']} B at B={TB}; gen_time "
              f"{g35['evaluator']['gen_time']:.6f} s/frame; score_policies "
              f"{g35['scoring']['policies_per_s']:.1f} policies/s; the train "
              f"CLI {g35['cli']['s_per_update']:.4f} s/update (two bare "
              f"steps {2 * g35['cli']['bare_step_s']:.4f} s) on {card}",
              flush=True)

        t0 = time.perf_counter()
        h64 = check_head_dim_64(device)
        w64 = h64["phase_walls_s"]
        print(f"head_dim 64 phase: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in w64.items())
              + f"); GENIE_138M-h64 ({H64_HEADS} heads of "
              f"{cfg.d_model // H64_HEADS}) at {H64_LAYERS} layers: rollout "
              f"{h64['rollout']['s_per_frame']:.4f} s/frame at B={B}; train "
              f"step {h64['training']['step_s']:.4f} s, peak "
              f"{h64['training']['peak_memory_bytes']} B at B={TB}; gen_time "
              f"{h64['evaluator']['gen_time']:.6f} s/frame, score_policies "
              f"{h64['scoring']['policies_per_s']:.1f} policies/s, the train "
              f"CLI {h64['cli']['s_per_update']:.4f} s/update on {card}",
              flush=True)

        t0 = time.perf_counter()
        w32 = check_window_32(device)
        ww = w32["phase_walls_s"]
        print(f"T = 32 phase: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in ww.items())
              + f"); GENIE_138M-T32 ({W32_PROMPT} + {W32_T - W32_PROMPT} "
              f"frames) at {W32_LAYERS} layers: rollout "
              f"{w32['rollout']['s_per_frame']:.4f} s/frame at B={B}; train "
              f"step {w32['training']['step_s']:.4f} s, peak "
              f"{w32['training']['peak_memory_bytes']} B at B={TB}; gen_time "
              f"{w32['evaluator']['gen_time']:.6f} s/frame, score_policies "
              f"{w32['scoring']['policies_per_s']:.1f} policies/s, the train "
              f"CLI {w32['cli']['s_per_update']:.4f} s/update on {card}",
              flush=True)

        t0 = time.perf_counter()
        s1k = check_grid_1024(device)
        ws = s1k["phase_walls_s"]
        print(f"S = 1024 phase: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in ws.items())
              + f"); GENIE_138M-S1024 rollout "
              f"{s1k['rollout']['s_per_frame']:.4f} s/frame at B={B}; train "
              f"step {s1k['training']['step_s']:.4f} s, peak "
              f"{s1k['training']['peak_memory_bytes']} B at B={TB}; at "
              f"{S1024_LAYERS} layers gen_time "
              f"{s1k['evaluator']['gen_time']:.6f} s/frame, score_policies "
              f"{s1k['scoring']['policies_per_s']:.1f} policies/s, the train "
              f"CLI {s1k['cli']['s_per_update']:.4f} s/update on {card}",
              flush=True)

        t0 = time.perf_counter()
        h128 = check_head_dim_128(device)
        w128 = h128["phase_walls_s"]
        print(f"head_dim 128 phase: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in w128.items())
              + f"); GENIE_138M-h128 ({H128_HEADS} heads of "
              f"{cfg.d_model // H128_HEADS}) rollout "
              f"{h128['rollout']['s_per_frame']:.4f} s/frame at B={B}; "
              f"train step {h128['training']['step_s']:.4f} s, peak "
              f"{h128['training']['peak_memory_bytes']} B at B={TB}; at "
              f"{H128_LAYERS} layers gen_time "
              f"{h128['evaluator']['gen_time']:.6f} s/frame, score_policies "
              f"{h128['scoring']['policies_per_s']:.1f} policies/s, the "
              f"train CLI {h128['cli']['s_per_update']:.4f} s/update on "
              f"{card}", flush=True)

        t0 = time.perf_counter()
        tp = check_tensor_parallel(device)
        print(f"tensor parallelism phase: {time.perf_counter() - t0:.1f} s; "
              + "; ".join(
                  f"{name} at {TP_LAYERS} layers, tp={tp[name]['tp']}, "
                  f"B={TB}: the ranks' processes "
                  f"{tp[name]['ranks_wall_s']:.1f} s (ranks sharing one card "
                  f"over gloo, not a TP speed), update against one process, "
                  f"all parameters' rel L2 pre-LN "
                  f"{tp[name]['pre_ln']['update_rel_l2'][0]:.3e}, qk_norm "
                  f"{tp[name]['qk_norm']['update_rel_l2'][0]:.3e}, gradient "
                  f"norm against one process's of the same gradients "
                  f"{tp[name]['pre_ln']['grad_norm_vs_whole']:.2e} / "
                  f"{tp[name]['qk_norm']['grad_norm_vs_whole']:.2e}"
                  for name, _, _ in TP_SETUPS)
              + f"; rollouts of {TP_ROWS_ROLLOUT} rows token-equal; K4/K6 "
              f"at C=128 and C=64 held on {card}", flush=True)

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
            item["genie_35m_launches"] = {
                "rollout": g35["rollout"]["launches"][name],
                "train": g35["training"]["launches"][name],
                "score_policies": g35["scoring"]["launches"][name],
                "evaluate_dataset": g35["evaluator"]["launches"][name],
                "train_cli_update":
                    g35["cli"]["launches_per_update"][name]}
            # the head_dim-64 form: its check at GENIE_138M-h64's shapes
            # and its launches on that configuration's paths
            h64_key = (f"{name}[N={B}][h64]" if name == "spatial_block"
                       else f"{name}[h64]")
            if h64_key in h64["kernels"]:
                r64 = h64["kernels"][h64_key]
                item["h64"] = {k: r64.get(k) for k in (
                    "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms", "shape")}
                item["h64"]["launches"] = {
                    "rollout": h64["rollout"]["launches"][name],
                    "train": h64["training"]["launches"][name],
                    "qk_norm_int8_rollout":
                        h64["qk_norm_int8_rollout"]["launches"][name],
                    "qk_norm_train":
                        h64["qk_norm_training"]["launches"][name]}
            # the head_dim-128 form: its check at GENIE_138M-h128's shapes
            # and its launches on that configuration's paths
            h128_key = (f"{name}[N={B}][h128]" if name == "spatial_block"
                        else f"{name}[h128]")
            if h128_key in h128["kernels"]:
                r128 = h128["kernels"][h128_key]
                item["h128"] = {k: r128.get(k) for k in (
                    "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms", "shape")}
                item["h128"]["launches"] = {
                    k: h128[k]["launches"][name] for k in (
                        "rollout", "training", "scoring", "evaluator",
                        "qk_norm_int8_rollout", "qk_norm_training")}
                item["h128"]["launches"]["train_cli_update"] = (
                    h128["cli"]["launches_per_update"][name])
                item["h128"]["launches"]["mup"] = {
                    "rollout": h128["mup"]["rollout"]["launches"][name],
                    "train": h128["mup"]["train_step"]["kernel_launches"][
                        name]}
                q8 = h128["kernels"].get(name + "[int8][h128]")
                if q8 is not None:  # the decode attention kernels
                    item["h128"].update(int8_device_ms=q8["device_ms"],
                                        int8_bound_ms=q8["bound_ms"])
            # the T = 32 form: its check at GENIE_138M-T32's shapes and its
            # launches on that configuration's paths
            if name in W32_KEYS:
                r32 = w32["kernels"][W32_KEYS[name] + "[t32]"]
                item["t32"] = {k: r32.get(k) for k in (
                    "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms", "shape")}
                item["t32"]["launches"] = {
                    "rollout": w32["rollout"]["launches"][name],
                    "train": w32["training"]["launches"][name],
                    "score_policies": w32["scoring"]["launches"][name],
                    "evaluate_dataset": w32["evaluator"]["launches"][name],
                    "qk_norm_int8_rollout":
                        w32["qk_norm_int8_rollout"]["launches"][name],
                    "qk_norm_train":
                        w32["qk_norm_training"]["launches"][name]}
                q8 = w32["kernels"].get(name + "[int8][t32]")
                if q8 is not None:  # the decode attention kernels
                    item["t32"].update(int8_device_ms=q8["device_ms"],
                                       int8_bound_ms=q8["bound_ms"])
                h = w32["kernels"].get(W32_H64_KEYS.get(name, "") + "[t32]")
                if h is not None:  # K4 and K6 at head_dim 64
                    item["t32"].update(h64_device_ms=h["device_ms"],
                                       h64_library_device_ms=h[
                                           "library_device_ms"])
            # the S = 1024 form: its check at GENIE_138M-S1024's shapes and
            # its launches on that configuration's paths
            r1k = s1k["kernels"][S1024_KEYS[name] + "[s1024]"]
            item["s1024"] = {k: r1k.get(k) for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "exp_bound_ms", "library_ms",
                "library_device_ms", "shape")}
            item["s1024"]["launches"] = {
                k: s1k[k]["launches"][name] for k in (
                    "rollout", "training", "scoring", "evaluator",
                    "qk_norm_int8_rollout", "qk_norm_training")}
            item["s1024"]["launches"]["train_cli_update"] = (
                s1k["cli"]["launches_per_update"][name])
            q8 = s1k["kernels"].get(name + "[int8][s1024]")
            if q8 is not None:  # the decode attention kernels
                item["s1024"].update(int8_device_ms=q8["device_ms"],
                                     int8_bound_ms=q8["bound_ms"])
            item["mup_launches"] = {
                "rollout": mup["rollout"]["launches"][name],
                "train": mup["train_step"]["kernel_launches"][name]}
            # each rank's, in the TP step of each setup
            counter = (TP_COUNTERS.get(name) if name != "spatial_block"
                       else "tp_spatial_train_block")
            if counter is not None:
                item["tp_launches"] = {
                    f"{setup}_tp{tp[setup]['tp']}": {
                        arch: [n[counter] for n in tp[setup][arch]["launches"]]
                        for arch in TP_ARCHS} for setup, _, _ in TP_SETUPS}
            if name == "spatial_block":
                item["tp_note"] = (
                    "not launched under tensor parallelism: a rank runs "
                    "K1's parts at its shapes (the LN row pass, gemm_sm90, "
                    "K9, a training-form nt product with an fp32 store), "
                    "counted as tp_spatial_train_block (tp_launches)")
            if name in ("temporal_attention", "temporal_attention_bwd"):
                # their head groups of 4 and of 2
                for width in (128, 64):
                    c = tp[f"c{width}"][f"{name}[C={width}]"]
                    item[f"c{width}"] = {k: c[k] for k in (
                        "shape", "ms", "device_ms", "bound_ms", "bound_by",
                        "plain_ms", "library_ms", "max_abs_err")}
            if name + "[int8]" in results:  # the decode attention kernels
                q8 = results[name + "[int8]"]
                item.update(int8_ms=q8["ms"], int8_device_ms=q8["device_ms"],
                            int8_bound_ms=q8["bound_ms"])
                for tag, res in (("", r), ("int8_", q8)):
                    item.update({f"{tag}rollout_{k}": res["rollout"][k]
                                 for k in ("device_ms", "bound_ms")})
            line.append(vet(item, name))
        print("device times below their bound, dropped as lost events: "
              + json.dumps(BELOW_BOUND), flush=True)
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
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5]))
    sys.exit(main())
