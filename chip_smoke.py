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
   cores' rate and its fp32 arithmetic over the fp32 units' rate.
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
   changes from run to run).
6. Trains GENIE_138M (random weights and tokens from seed 0, B=8, T=16)
   through `make_train_step` on the card: the launch counters are set to 0
   before the first step and read after it; ten steps on the one batch and
   corruption at a constant learning rate must give a finite loss that
   starts within 1.5 of 2 ln 512 and falls; prints the median step time of the last
   five, the device's busy share and device time by kernel over one more
   step, and the peak memory. Then holds the loss, the gradient norm and
   every parameter's gradient of the kernel path against the plain path and
   an fp32 plain run on the card (see `check_step_against_plain`).
7. Prints the `kernels` JSON line, the card line, and last the result line.

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
from tpu1x_torch.ops import mlp_train_block as mtb
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
    "spatial_train_block_bwd": ("tpu1x_torch/csrc/spatial_block.cu",
                                "tpu1x/ops/spatial_train_block.py:256"),
    "temporal_train_block": ("tpu1x_torch/csrc/train_block.cu",
                             "tpu1x/ops/temporal_train_block.py:213"),
    "temporal_train_block_bwd": ("tpu1x_torch/csrc/train_block.cu",
                                 "tpu1x/ops/temporal_train_block.py:254"),
    "mlp_train_block": ("tpu1x_torch/csrc/train_block.cu",
                        "tpu1x/ops/mlp_train_block.py:219"),
    "mlp_train_block_bwd": ("tpu1x_torch/csrc/train_block.cu",
                            "tpu1x/ops/mlp_train_block.py:260"),
}
# launches per layer in one rollout: the prefill, 9 single-frame decodes
# (2 steps of the first new frame, then step 1 of the other 7), 7 pairs
PER_LAYER = {"spatial_block": 1 + 9 + 7, "temporal_mlp_block": 9,
             "temporal_mlp_block_pair": 7, "temporal_attention": 1,
             "layer_norm": 1}
# launches per layer in one train step; the temporal train block launches
# the temporal attention forward twice (forward, and recompute in its
# backward) and its backward once
TRAIN_PER_LAYER = {"spatial_block": 1, "spatial_train_block_bwd": 1,
                   "temporal_train_block": 1, "temporal_train_block_bwd": 1,
                   "mlp_train_block": 1, "mlp_train_block_bwd": 1,
                   "temporal_attention": 2, "temporal_attention_bwd": 1}


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
    return dict(max_abs_err=err, shape=list(x.shape), bound_ms=bms,
                bound_by=by,
                ms=time_ms(lambda: layer_norm(x, g, b)),
                plain_ms=time_ms(lambda: layer_norm_plain(x, g, b)),
                library_ms=time_ms(lambda: F.layer_norm(x, (C,), gb, bb)))


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


def check_spatial_block(inp, C, H, N):
    w = spatial_weights(inp, C)
    x = inp.normal(N, 256, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5, **w)
    err = compare(f"spatial_block N={N}", spatial_block(x, **kw),
                  spatial_block_plain(x, **kw), 3e-2, 3e-2)
    S = 256
    bms, by = bound(nbytes(x, x, *w.values()),
                    tensor_flops=2 * N * S * C * (4 * C + 2 * S))
    return dict(max_abs_err=err, shape=list(x.shape), bound_ms=bms,
                bound_by=by, ms=time_ms(lambda: spatial_block(x, **kw)),
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


def check_temporal_mlp_block(inp, C, H, L, caches, pair):
    kc, vc = caches
    T = kc.shape[0]
    w = block_weights(inp, C)
    frames = 2 if pair else 1
    x = inp.normal(B, frames, 256, C) if pair else inp.normal(B, 256, C)
    # a different frame index per row, and a layer other than 0
    t_B = (P + torch.arange(B, device=x.device) % (T - P - frames + 1)).to(
        torch.int32)
    layer = L // 2
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, gelu_tanh=True, **w)
    name = "temporal_mlp_block_pair" if pair else "temporal_mlp_block"
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
    S = 256
    slots = int(t_B.sum())  # this run's data: slots t < t_B[b] per row
    cache_bytes = 2 * slots * S * C * 2
    io = nbytes(x, x, t_B, *w.values()) + 2 * B * S * C * 2
    flops = 2 * frames * B * S * C * 12 * C  # the four weight products
    # q.k of bf16 operands for every logit; p.v with fp32 probabilities
    logit_macs = B * S * C * (frames * slots / B + frames * (frames + 1) / 2)
    bms, by = bound(cache_bytes + io, tensor_flops=flops + 2 * logit_macs,
                    fp32_flops=2 * logit_macs)
    return dict(max_abs_err=err, shape=list(x.shape), t_B=t_B.tolist(),
                layer=layer, bound_ms=bms, bound_by=by,
                ms=time_ms(lambda: kernel(x, kc, vc, t_B, layer=layer, **kw)),
                plain_ms=time_ms(lambda: plain(x, kc[:, layer], vc[:, layer],
                                               t_B, **kw), iters=5),
                library_ms=None)


def check_kernels(C, H, L, device):
    inp = Inputs(0, device)
    out = {}
    out["layer_norm"] = check_layer_norm(inp, C)
    out["temporal_attention"] = check_temporal_attention(inp, C, H)
    for N in (B, 2 * B, B * P):
        out[f"spatial_block[N={N}]"] = check_spatial_block(inp, C, H, N)
    T = 16
    caches = (inp.normal(T, L, B, 256, C), inp.normal(T, L, B, 256, C))
    out["temporal_mlp_block"] = check_temporal_mlp_block(
        inp, C, H, L, caches, pair=False)
    out["temporal_mlp_block_pair"] = check_temporal_mlp_block(
        inp, C, H, L, caches, pair=True)
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
    )


def plain_rollout(cfg, engine, params, prompt, generator):
    """What `RolloutEngine.rollout` does, through `engine`'s ops."""
    tokens, _ = generate_cached_fused(
        functools.partial(engine.prefill, params),
        functools.partial(engine.decode_frame, params, return_kv=False),
        functools.partial(engine.decode_frame_pair, params),
        prompt.reshape(B, -1), NEW, generator, cfg, maskgit_steps=STEPS,
        temperature=0.0)
    return tokens.reshape(B, 1, P + NEW, *prompt.shape[2:])


def check_rollout(cfg, device):
    g = torch.Generator(device=device).manual_seed(0)
    model = STMaskGIT(cfg, device=device).init_weights(g)
    engine = RolloutEngine(model, cfg, device=device, maskgit_steps=STEPS,
                           temperature=0.0)
    plain = PlainDecodeEngine(cfg, device=device)
    side = cfg.latent_side_len
    prompt = torch.randint(0, cfg.image_vocab_size, (B, P, side, side),
                           generator=g, device=device)

    def seeded():
        return torch.Generator(device=device).manual_seed(1)

    def timed(rollout):
        t0 = time.perf_counter()
        out = rollout(seeded())
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def kernel_path(gen):
        return engine.rollout(prompt, NEW, gen)

    def plain_path(gen):
        return plain_rollout(cfg, plain, engine.params, prompt, gen)

    kernel_path(seeded())  # first-call set-up, not timed
    torch.cuda.synchronize()
    kernels.reset_launches()
    out, wall = timed(kernel_path)
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(PER_LAYER, cfg.num_layers)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    if tuple(out.shape) != (B, 1, P + NEW, side, side):
        raise AssertionError(f"rollout shape {tuple(out.shape)}")
    if not torch.equal(out[:, 0, :P], prompt):
        raise AssertionError("rollout changed the prompt frames")
    if int(out.min()) < 0 or int(out.max()) >= cfg.image_vocab_size:
        raise AssertionError("rollout tokens out of the vocabulary")

    walls = sorted([wall] + [timed(kernel_path)[1] for _ in range(2)])
    wall = walls[1]  # the median of three
    out_plain, wall_plain = timed(plain_path)
    agree = float((out[:, 0, P:] == out_plain[:, 0, P:]).float().mean())

    return dict(launches=launches, rollout_s=wall, rollout_s_runs=walls,
                plain_rollout_s=wall_plain, s_per_frame=wall / NEW,
                s_per_frame_per_row=wall / (NEW * B), token_agreement=agree,
                layers=cfg.num_layers,
                device_time=profile_device(
                    lambda: engine.rollout(prompt, NEW, seeded())),
                **check_prefill_and_logits(model, cfg, prompt, engine, plain))


def profile_device(run, top: int = 12):
    """Device time by kernel over one call of `run` (one more rollout, one
    more train step), from torch.profiler: the total, its share of that
    call's wall time (the device's busy share; the profiler's own host cost
    is in the wall), and the largest kernels in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device = [a for a in prof.key_averages()
                 if a.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(a.self_device_time_total for a in on_device) / 1e3
    ranked = sorted(on_device, key=lambda a: -a.self_device_time_total)
    return {"wall_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3),
            "top": [[a.key[:60], a.count, a.self_device_time_total / 1e3]
                    for a in ranked[:top]]}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_prefill_and_logits(model, cfg, prompt, engine, plain):
    """The prefill cache and the first new frame's step-0 logits of the
    kernel path against the plain path, each path on its own cache.

    Layer 0 of the cache is held elementwise (atol = rtol = 3e-2). Deeper
    down, two bf16 paths drift apart by their rounding alone, so the whole
    cache and the logits are held by relative L2 error: at most 3e-2 from
    the plain path, and no farther from an fp32 plain run than the bf16
    plain path is (1.25x + 1e-3)."""
    device = engine.device
    ref = PlainDecodeEngine(cfg, device=device, compute_dtype=torch.float32,
                            gelu="tanh")
    ref_params = prepare_serving_params(model, cfg, torch.float32, device)
    masked = torch.full((B, cfg.S), cfg.mask_token_id, dtype=torch.long,
                        device=device)
    got = {}
    for name, eng, params in (("kernel", engine.engine, engine.params),
                              ("plain", plain, engine.params),
                              ("fp32", ref, ref_params)):
        cache = eng.prefill(params, prompt)
        logits, _ = eng.decode_frame(params, masked, P, cache,
                                     return_kv=False)
        got[name] = {"k": cache["k"][:P], "v": cache["v"][:P],
                     "logits": logits}
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


def entry(err, grads, shape, ms, plain, bnd, library_ms=None):
    return dict(max_abs_err=err, grads=grads, shape=list(shape), ms=ms,
                plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms)


def check_spatial_train_block(inp, C, H):
    S, N = 256, TB * 16
    t = dict(x=inp.normal(N, S, C), **{
        k: v.float() for k, v in spatial_weights(inp, C).items()})
    dout = inp.normal(N, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    out_err, grads = both_paths(
        "spatial_train_block",
        functools.partial(stb.spatial_train_block, **kw),
        functools.partial(stb.spatial_train_block_plain, **kw), t, dout)
    w16 = (tk.as_bf16(t["wqkv"]), tk.as_bf16(t["wproj"]), None,
           t["ln_scale"], t["ln_bias"])
    R = N * S
    moved = 3 * R * C * 2 + 4 * C * C * (2 + 4) + 5 * C * 4
    # products: qkv (recompute) 6, d_o 2, dWproj 2, dWqkv 6, d_xn 6 R C^2;
    # per head logits, o, dp, dq, dk, dv of 2 S S D each
    bnd = bound(moved, tensor_flops=R * C * (22 * C + 12 * S),
                fp32_flops=20 * R * C + 10 * N * H * S * S)
    return {"spatial_train_block_bwd": entry(
        grads["x"]["max_abs_err"], dict(grads, out=out_err), t["x"].shape,
        time_ms(lambda: stb.spatial_train_block_bwd(
            t["x"], dout, *w16, proj_bias=True, **kw)),
        plain_ms(functools.partial(stb.spatial_train_block_plain, **kw), t,
                 dout), bnd)}


def check_temporal_train_block(inp, C, H):
    S, T = 256, 16
    t = dict(x=inp.normal(TB, T, S, C),
             wqkv=inp.normal(C, 3 * C, std=0.05, dtype=torch.float32),
             wproj=inp.normal(C, C, std=0.05, dtype=torch.float32),
             bproj=inp.normal(C, std=0.1, dtype=torch.float32))
    dout = inp.normal(TB, T, S, C)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    plain = functools.partial(ttb.temporal_train_block_plain, **kw)
    out_err, grads = both_paths(
        "temporal_train_block",
        functools.partial(ttb.temporal_train_block, **kw), plain, t, dout)
    w16 = [tk.as_bf16(t[k]) for k in ("wqkv", "wproj")]
    b16 = tk.as_bf16(t["bproj"])
    R, pairs = TB * T * S, T * (T + 1) // 2
    weights = 4 * C * C
    fwd = bound(2 * R * C * 2 + weights * 2,
                tensor_flops=8 * R * C * C + 4 * TB * S * C * pairs)
    bwd = bound(3 * R * C * 2 + weights * (2 + 4) + C * 4,
                tensor_flops=22 * R * C * C + 12 * TB * S * C * pairs)
    return {
        "temporal_train_block": entry(
            out_err, {}, t["x"].shape,
            time_ms(lambda: ttb.temporal_train_block_fwd(
                t["x"], *w16, None, b16, **kw)),
            plain_ms(plain, t), fwd),
        "temporal_train_block_bwd": entry(
            grads["x"]["max_abs_err"], grads, t["x"].shape,
            time_ms(lambda: ttb.temporal_train_block_bwd(
                t["x"], dout, *w16, None, proj_bias=True, **kw)),
            plain_ms(plain, t, dout), bwd)}


def check_mlp_train_block(inp, C):
    S, N, F4 = 256, TB * 16, 4 * C
    w = block_weights(inp, C)
    t = dict(x=inp.normal(N, S, C), **{
        k: w[k].float() for k in ("wfc1", "wfc2", "bfc1", "bfc2", "ln_scale",
                                  "ln_bias")})
    dout = inp.normal(N, S, C)
    out = {}
    for approx in (False, True):  # exact erf is the shipped configs' GELU
        name = "mlp_train_block" + ("[tanh]" if approx else "")
        plain = functools.partial(mtb.mlp_train_block_plain,
                                  gelu_approx=approx)
        out_err, grads = both_paths(
            name, functools.partial(mtb.mlp_train_block, gelu_approx=approx),
            plain, t, dout)
        w16 = [tk.as_bf16(t[k]) for k in ("wfc1", "wfc2", "bfc1", "bfc2")]
        ln = (t["ln_scale"], t["ln_bias"])
        R = N * S
        weights = 2 * C * F4
        fwd = bound(2 * R * C * 2 + weights * 2,
                    tensor_flops=4 * R * C * F4, fp32_flops=10 * R * F4)
        # fc1 (recompute), dWfc2, d_g, dWfc1, d_xn: 2 R C F4 each
        bwd = bound(3 * R * C * 2 + weights * (2 + 4) + (F4 + 3 * C) * 4,
                    tensor_flops=10 * R * C * F4,
                    fp32_flops=20 * R * F4 + 20 * R * C)
        out[name] = entry(
            out_err, {}, t["x"].shape,
            time_ms(lambda: mtb.mlp_train_block_fwd(
                t["x"], *w16, *ln, gelu_approx=approx)),
            plain_ms(plain, t), fwd)
        out[name.replace("block", "block_bwd")] = entry(
            grads["x"]["max_abs_err"], grads, t["x"].shape,
            time_ms(lambda: mtb.mlp_train_block_bwd(
                t["x"], dout, *w16[:3], *ln, gelu_approx=approx, bias=True)),
            plain_ms(plain, t, dout), bwd)
    return out


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
                                  mlp=mtb.mlp_train_block_plain)
    try:
        yield
    finally:
        STBlock.ops = kernel_ops


def check_training(cfg, device):
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
    want = expected_launches(TRAIN_PER_LAYER, cfg.num_layers)
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
    device_time = profile_device(lambda: step(tokens, noise=noise))
    out = dict(launches=launches, losses=losses, grad_norms=norms,
               accs=[float(m["acc"]) for m in metrics], step_s=step_s,
               step_s_runs=walls, tokens_per_s=TB * cfg.T * cfg.S / step_s,
               peak_memory_bytes=peak, batch=TB, layers=cfg.num_layers,
               lr=TRAIN_LR, device_time=device_time)
    del step, optimizer, metrics
    model.load_state_dict(init)
    return model, out


def check_step_against_plain(model, cfg, device):
    """Loss, gradient norm and every parameter's gradient after one forward
    and backward from the same weights and the same corrupted batch, at the
    full depth and width and B = CB (the plain path's autograd keeps every
    (N, H, S, S) probability tensor, which does not fit at B = 8): the
    kernel path against the plain path, and both against an fp32 plain run.

    Two bf16 paths drift apart by rounding alone over 32 layers forward and
    32 back, so gradients are held in relative L2: every parameter's, and
    all parameters' together, within 3e-2 of the plain path's, and the
    kernel path no farther from the fp32 run than the bf16 plain path is
    (1.25x + 1e-3)."""
    g = torch.Generator(device=device).manual_seed(2)
    side = cfg.latent_side_len
    tokens = torch.randint(0, cfg.image_vocab_size, (CB, cfg.T, side, side),
                           generator=g, device=device)
    batch = maskgit_corrupt(tokens, draw_noise(tokens.shape, cfg, g, device),
                            cfg)
    ref = STMaskGIT(dataclasses.replace(cfg, dtype="float32"), device=device)
    ref.load_state_dict(model.state_dict())

    def run(m, plain):
        m.train().zero_grad(set_to_none=True)
        with plain_blocks() if plain else contextlib.nullcontext():
            out = m(batch["input_ids"], batch["labels"])
            out["loss"].backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        norm = torch.linalg.vector_norm(torch.stack(
            [x.norm() for x in grads.values()]))
        return float(out["loss"].detach()), float(norm), grads

    kernels.reset_launches()
    got = {"kernel": run(model, False)}
    want = expected_launches(TRAIN_PER_LAYER, cfg.num_layers)
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
    fk, fp, f32 = flat("kernel"), flat("plain"), flat("fp32")
    out = {"batch": CB, "layers": cfg.num_layers,
           "loss": {k: v[0] for k, v in got.items()},
           "grad_norm": {k: v[1] for k, v in got.items()},
           "grads_rel_l2": {"kernel_vs_plain": rel_l2(fk, fp),
                            "kernel_vs_fp32": rel_l2(fk, f32),
                            "plain_vs_fp32": rel_l2(fp, f32)},
           "worst_params_kernel_vs_plain": worst}
    r = out["grads_rel_l2"]
    loss_k, loss_p, loss_32 = (out["loss"][k] for k in ("kernel", "plain",
                                                        "fp32"))
    ok = (worst[0][1] <= 3e-2 and r["kernel_vs_plain"] <= 3e-2
          and r["kernel_vs_fp32"] <= 1.25 * r["plain_vs_fp32"] + 1e-3
          and abs(loss_k - loss_p) <= 2e-2
          and abs(loss_k - loss_32) <= 1.25 * abs(loss_p - loss_32) + 2e-2
          and abs(out["grad_norm"]["kernel"] / out["grad_norm"]["plain"] - 1)
          <= 5e-2)
    if not ok:
        raise AssertionError(f"train step against the plain path: {out}")
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
                if "registers" in line or "spill" in line:
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

        line = []
        for name in SOURCES:
            # spatial_block is reported at the single-frame decode shape,
            # the one with the most launches. `launches` is the count of
            # the path that the kernel first served (the rollout for the
            # serving kernels, the train step for the training kernels);
            # `train_launches` is the train step's count for all of them.
            r = results[f"{name}[N={B}]" if name == "spatial_block" else name]
            source, replaces = SOURCES[name]
            path = roll if name in PER_LAYER else train
            line.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path["launches"][name],
                "train_launches": train["launches"][name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
