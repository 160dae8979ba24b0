"""Drive the PyTorch/CUDA port (tpu1x_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the versions.
2. Builds every kernel from tpu1x_torch/csrc with nvcc, all in parallel.
3. Holds each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes of the GENIE_138M rollout (B=16, 8 prompt frames):
   atol = rtol = 3e-2 on outputs, 2e-2 on the k/v outputs of the
   temporal+MLP block, which are one bf16 product away from the inputs.
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
   with the same rounding, beside torch.matmul.
4. Runs RolloutEngine.rollout at GENIE_138M (random weights from a seed,
   B=16, 8 prompt + 8 new frames, maskgit_steps 2, temperature 0), with
   the launch counters set to 0 just before and read just after; checks
   the counts and the output; times it (median of three runs) and the
   plain path (`PlainDecodeEngine`, this script's own oracle); profiles one
   more run for device time by kernel; and holds the prefill cache and the
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
   TFLOP/s beside torch.matmul's.
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
   a (16, 32, 16, 256, 512) cache), the spatial block with the qk-LN, the
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
9. Prints the `kernels` JSON line, the card line, and last the result line.

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
import json
import math
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from tpu1x_torch import kernels
from tpu1x_torch.data.corruption import draw_noise, maskgit_corrupt
from tpu1x_torch.model_zoo import genie_138m
from tpu1x_torch.models.sampler import generate_cached_fused
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
from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.step import make_train_step

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_TENSOR = 989e12
PEAK_FP32 = 67e12
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
# the temporal attention forward twice (forward, and recompute in its
# backward) and its backward once; the spatial train block's backward
# launches the fused attention forward (recompute) and backward once each
TRAIN_PER_LAYER = {"spatial_block": 1, "spatial_train_block_bwd": 1,
                   "temporal_train_block": 1, "temporal_train_block_bwd": 1,
                   "mlp_train_block": 1, "mlp_train_block_bwd": 1,
                   "temporal_attention": 2, "temporal_attention_bwd": 1,
                   "flash_mha": 1, "flash_mha_bwd": 1}
# under qk_norm: the fused attention pair on the spatial axis, the MLP train
# block without LN; the rest is plain torch under autograd
TRAIN_PER_LAYER_QK = {"flash_mha": 1, "flash_mha_bwd": 1,
                      "mlp_train_block": 1, "mlp_train_block_bwd": 1}


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


def check_temporal_attention(inp, C, H):
    qkv = inp.normal(B, P, 256, 3 * C)
    q, k, v = qkv.split(C, dim=-1)  # the prefill's strided views
    scale = (C // H) ** -0.5
    kw = dict(scale=scale, num_heads=H)
    err = compare("temporal_attention", temporal_attention(q, k, v, **kw),
                  temporal_attention_plain(q, k, v, **kw), 3e-2, 3e-2)
    D = C // H

    def heads(t):  # (B, T, S, C) -> (B, S, H, T, D) view
        return t.reshape(B, P, 256, H, D).permute(0, 2, 3, 1, 4)
    qh, kh, vh = heads(q), heads(k), heads(v)
    pairs = P * (P + 1) // 2
    # q.k and, with probabilities rounded to bf16, p.v: both bf16 products
    bms, by = bound(4 * B * P * 256 * C * 2,
                    tensor_flops=4 * B * 256 * C * pairs)
    return dict(
        max_abs_err=err, shape=list(q.shape), bound_ms=bms, bound_by=by,
        ms=time_ms(lambda: temporal_attention(q, k, v, **kw)),
        plain_ms=time_ms(lambda: temporal_attention_plain(q, k, v, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=scale)))


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
                             timed=True):
    """K2 (one frame) or K3 (the pair) against its plain version at C
    channels and H heads, with the tanh or the exact-erf GELU (the two
    instantiations of the GEMM's GELU epilogue); with `timed`, its event and
    device time, its plain version's and its bound."""
    kc, vc = caches
    T = kc.shape[0]
    w = block_weights(inp, C)
    frames = 2 if pair else 1
    x = inp.normal(B, frames, 256, C) if pair else inp.normal(B, 256, C)
    # a different frame index per row, and a layer other than 0
    t_B = (P + torch.arange(B, device=x.device) % (T - P - frames + 1)).to(
        torch.int32)
    layer = L // 2
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, gelu_tanh=gelu_tanh, **w)
    name = "temporal_mlp_block_pair" if pair else "temporal_mlp_block"
    name += f"[C={C},{'tanh' if gelu_tanh else 'erf'}]"
    kernel = temporal_mlp_block_pair if pair else temporal_mlp_block
    plain = temporal_mlp_block_pair_plain if pair else temporal_mlp_block_plain
    got = kernel(x, kc, vc, t_B, layer=layer, **kw)
    want = plain(x, kc[:, layer], vc[:, layer], t_B, **kw)
    err = compare(name, got[0], want[0], 3e-2, 3e-2)
    compare(name + " k", got[1], want[1], 2e-2, 2e-2)
    compare(name + " v", got[2], want[2], 2e-2, 2e-2)
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
        return dict(max_abs_err=err, shape=list(x.shape))
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
                layer=layer, bound_ms=bms, bound_by=by, ms=time_ms(run),
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
    slot is valid). `scales`: None for the bf16 cache."""
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
    slots = int(t_B.sum())  # this run's data: slots t < t_B[b] per row
    cache_bytes = 2 * slots * S * (C * kc.element_size()
                                   + (4 if scales is not None else 0))
    macs = B * S * C * (frames * slots / B + frames * (frames + 1) / 2)
    # q.k: bf16 operands (int8 values are exact in bf16); p.v in fp32
    bms, by = bound(cache_bytes + nbytes(qkv, t_B) + frames * B * S * C * 2,
                    tensor_flops=2 * macs, fp32_flops=2 * macs)
    return {name: dict(
        max_abs_err=err, shape=list(qkv.shape), t_B=t_B.tolist(),
        bound_ms=bms, bound_by=by,
        ms=time_ms(lambda: kernel(*args, layer=layer, **kw)),
        device_ms=device_ms(lambda: kernel(*args, layer=layer, **kw)),
        plain_ms=time_ms(lambda: plain(*args, layer=layer, **kw), iters=5),
        library_ms=None)}


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
    out["temporal_attention"] = check_temporal_attention(inp, C, H)
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
        # every product of the rollout runs on csrc/gemm_sm90.cuh
        device_time = profile_device(lambda: kernel_path(seeded()))

    return dict(launches=launches, rollout_s=wall, rollout_s_runs=walls,
                plain_rollout_s=wall_plain, s_per_frame=wall / NEW,
                s_per_frame_per_row=wall / (NEW * B), token_agreement=agree,
                layers=cfg.num_layers, qk_norm=cfg.qk_norm,
                cache_dtype=cache_dtype,
                action_vocab_size=cfg.action_vocab_size,
                device_time=device_time,
                **check_prefill_and_logits(model, cfg, prompt, engine, plain,
                                           actions))


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
    return {"wall_ms": wall * 1e3, "device_ms": total,
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
    S, T, D = 256, 16, C // H
    t = dict(qkv=inp.normal(TB, T, S, 3 * C))
    dout = inp.normal(TB, T, S, C)
    scale = D ** -0.5
    out = {}
    for causal in (True, False):
        name = "temporal_attention_bwd" + ("" if causal else "[non-causal]")
        kw = dict(scale=scale, num_heads=H, causal=causal)

        def kernel(qkv):
            return ta.temporal_attention(*qkv.split(C, dim=-1), **kw)

        def plain(qkv):
            return ta.temporal_attention_plain(*qkv.split(C, dim=-1), **kw)

        out_err, grads = both_paths(name, kernel, plain, t, dout)
        q, k, v = t["qkv"].split(C, dim=-1)

        def heads(x):  # (B, T, S, C) -> (B, S, H, T, D) view
            return x.reshape(TB, T, S, H, D).permute(0, 2, 3, 1, 4)
        lq, lk, lv = (heads(x).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                                 scale=scale)
        pairs = T * (T + 1) // 2 if causal else T * T
        # logits, dp, dq, dk, dv: five products of 2 D per (query, key, head)
        bnd = bound(7 * TB * T * S * C * 2,
                    tensor_flops=10 * TB * S * C * pairs)
        out[name] = entry(
            grads["qkv"]["max_abs_err"], dict(grads, out=out_err), q.shape,
            time_ms(lambda: ta.launch_backward(q, k, v, dout, **kw)),
            plain_ms(plain, t, dout), bnd,
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), heads(dout), retain_graph=True)))
    return out


def check_train_kernels(C, H, device):
    inp = Inputs(1, device)
    out = {}
    out.update(check_temporal_attention_bwd(inp, C, H))
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
    # qk-LN attention is the qk_norm models')
    pre_ln = {} if cfg.qk_norm else dict(
        must=("flash_fwd_kernel", "flash_bwd_kernel"),
        must_not=("spatial_attention",))
    device_time = profile_device(lambda: step(tokens, noise=noise), **pre_ln)
    out = dict(launches=launches, losses=losses, grad_norms=norms,
               accs=[float(m["acc"]) for m in metrics], step_s=step_s,
               step_s_runs=walls, tokens_per_s=TB * cfg.T * cfg.S / step_s,
               peak_memory_bytes=peak, batch=TB, layers=cfg.num_layers,
               qk_norm=cfg.qk_norm, lr=TRAIN_LR, device_time=device_time)
    del step, optimizer, metrics
    model.load_state_dict(init)
    return model, out


def check_step_against_plain(model, cfg, device, per_layer=TRAIN_PER_LAYER):
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
    3.9% from fp32 where the plain path has 2.2%."""
    g = torch.Generator(device=device).manual_seed(2)
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (CB, cfg.T, side, side),
                           generator=g, device=device)
    batch = maskgit_corrupt(tokens, draw_noise(tokens.shape, cfg, g, device),
                            cfg)
    actions = (torch.randint(0, cfg.action_vocab_size, (CB, cfg.T),
                             generator=g, device=device)
               if cfg.action_vocab_size > 0 else None)
    ref = STMaskGIT(dataclasses.replace(cfg, dtype="float32"), device=device)
    ref.load_state_dict(model.state_dict())

    def run(m, plain):
        m.train().zero_grad(set_to_none=True)
        with plain_blocks() if plain else contextlib.nullcontext():
            out = m(batch["input_ids"], batch["labels"], actions)
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
        model, train_qk = check_training(cfg_qk, device, TRAIN_PER_LAYER_QK)
        print("training qk_norm: " + json.dumps(train_qk), flush=True)
        print(f"training qk_norm phase: {time.perf_counter() - t0:.1f} s; "
              f"{train_qk['step_s']:.4f} s/step, "
              f"{train_qk['tokens_per_s']:.0f} tokens/s, peak "
              f"{train_qk['peak_memory_bytes'] / 2**30:.2f} GiB at B={TB} on "
              f"{card}", flush=True)
        t0 = time.perf_counter()
        print("qk_norm train step against the plain path: " + json.dumps(
            check_step_against_plain(model, cfg_qk, device,
                                     TRAIN_PER_LAYER_QK)), flush=True)
        print(f"qk_norm plain-path comparison: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del model

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
