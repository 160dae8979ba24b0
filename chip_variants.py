"""Time builds of one kernel source side by side on one NVIDIA GPU.

    python3 chip_variants.py flash NAME=LIB ...
    python3 chip_variants.py gemm NAME=LIB ...
    python3 chip_variants.py tn NAME=LIB ...
    python3 chip_variants.py ta NAME=LIB ...
    python3 chip_variants.py da NAME=LIB ...
    python3 chip_variants.py block
    python3 chip_variants.py mlp
    python3 chip_variants.py train
    python3 chip_variants.py temporal
    python3 chip_variants.py l2
    python3 chip_variants.py decode
    python3 chip_variants.py rollout
    python3 chip_variants.py fresh
    python3 chip_variants.py k2gate
    python3 chip_variants.py cli
    python3 chip_variants.py cli_bare
    python3 chip_variants.py tp_cards   (needs four cards on one host)
    python3 chip_variants.py tp_faults [pre_ln | qk_norm]
    python3 chip_variants.py tp_c9
    python3 chip_variants.py tp_steps [SETUP]
    python3 chip_variants.py genie_35m
    python3 chip_variants.py mup
    python3 chip_variants.py h64_debug [h72]
    python3 chip_variants.py h128_debug
    python3 chip_variants.py h128
    python3 chip_variants.py h72
    python3 chip_variants.py w32_debug
    python3 chip_variants.py w32_times
    python3 chip_variants.py s1024_debug
    python3 chip_variants.py s1024
    python3 chip_variants.py s1024_times
    python3 chip_variants.py k12gate
    python3 chip_variants.py widths_debug
    python3 chip_variants.py ab_times [h32 | h64 | h72 | h128 | groups |
                                      one_head | widths | ln_rows]
    python3 chip_variants.py c8

Each LIB is a shared library built from a variant of a source in
`tpu1x_torch/csrc` (nvcc with `kernels.NVCC_FLAGS`, `-I` its own copy of the
headers), a variant `.cu` file (built here, beside it, all at once), or
`cur` for this checkout's own build; every build has this checkout's entry
points. The builds run in turns, first to last and back,
in one process on one card; every time is the profiler's device time
(`chip_smoke.device_ms`).

- `flash`: K9 and K10 (`flash_attention.cu`) at the qk_norm train step's
  (R, N, H, D) = (128, 256, 16, 32) and at FLASH_CASES' other token counts
  (up to 1024) and head_dim 64 and 128, q, k, v as thirds of one tensor,
  causal and not; K10's dq, dk, dv contiguous, as the qk_norm step has them, and its delta
  scratch passed; each build's o, dq, dk, dv held against the first
  build's by `chip_smoke.grad_errors`. A build whose launchers send N =
  256 to the streamed forms (copies of `flash_attention.cu` and `.cuh`
  with `N > FA_N` edited to `N > 192`) times those against the
  whole-item forms at 256; at head_dim 128 only the streamed form
  exists.
- `gemm`: the blocks' GEMM (`spatial_block.cu`'s `tpu1x_gemm_sm90`) at
  K1's products (4096 / 8192 / 32768 rows; 512 -> 1536 with bias, 512 ->
  512 with bias and residual) and K2's and K3's MLP products (4096 / 8192
  rows; 512 -> 2048 with bias and the tanh GELU, 2048 -> 512 with bias and
  residual), each result held against `gemm_sm90_plain` (atol = rtol =
  3e-2).
- `tn`: the weight gradients of the train blocks (`train_block.cu`'s
  `tpu1x_gemm90_train`, form TN, the fp32 buffer zeroed in each call) at
  the pre-LN train step's 32768 rows: K13's dWfc2 = g^T dout (2048 x 512)
  and dWfc1 = xn^T d_h (512 x 2048), K11's and K12's dWproj = o^T dout
  (512 x 512) and dWqkv = xn^T dqkv (512 x 1536), each held against
  `gemm90_plain` by `chip_smoke.grad_errors`. A variant of
  `gemm_sm90.cuh`'s chunk rule (`launch_gemm90_act`) times another number
  of chunks of the reduction.
- `ta`: K4 and K6 (`temporal_attention.cu`) through the C entry points,
  q, k, v the thirds of one qkv tensor, causal: K4 at the pre-LN train
  step's (8, 16, 256, 512) and the rollout prefill's (16, 8, 256, 512), K6
  at the former without and with `o`; K4's output held against
  `temporal_attention_plain` (atol = rtol = 3e-2) and K6's dq, dk, dv
  against `temporal_attention_bwd_plain` by `chip_smoke.grad_errors`. A
  variant that edits the tile's constants (`TA_POSITIONS`, `TA_HEADS`,
  `TA_WARPS`, `TA_MAX_STAGES`) times another tile.
- `da`: K7 and K8 (`decode_attention.cu`) through the C entry point, the
  cases of `decode` (both cache types, both t_B mixes, one frame and the
  pair), each result held against the plain version (atol = rtol = 3e-2).
  A variant that edits the tile's constants (`DA_ROWS`, `DA_SMEM`,
  `DA_SMEM_Q8`) times another tile.
- `block`: K2 and K3 (`temporal_mlp_block`, one frame and the pair)
  through this checkout's own wrappers, at the pre-LN rollout's shapes
  (GENIE_138M: B=16, S=256, C=512, 16 heads, F4=2048, a (16, 32, 16, 256,
  512) cache, t_B as `chip_smoke.py` draws it): the device time of one call
  (median of three windows) and of each of its launches, in order. It
  takes no builds: run it from a checkout (a parent's copy too) to time
  that checkout's kernels.
- `mlp`: K13 (`mlp_train_block_fwd` / `_bwd`) through this checkout's own
  wrappers, at the pre-LN train step's shape (GENIE_138M, B=8: x (128, 256,
  512) bf16, F4 = 2048, exact-erf GELU, biases), with the LN and without
  it (the qk_norm step's form): the device time of one call (median of
  three windows) and of each of its launches, in order, by kernel name.
  No builds, as `block`.
- `train`: K11's backward (`spatial_train_block_bwd`: LN1, the serving
  qkv product, K9's forward, d_o, K10's backward, the weight gradients,
  the column sums, d_xn, the LN backward) and K12's forward and backward
  (`temporal_train_block_fwd` / `_bwd`: the training forms around K4 and
  K6) at the pre-LN train step's shapes, timed as `mlp`, each launch by
  its kernel's name. No builds.
- `temporal`: K4 (`temporal_attention.launch_forward`) and K6
  (`launch_backward`) through this checkout's own wrappers, q, k, v the
  thirds of one qkv tensor: K4 at the pre-LN train step's (8, 16, 256,
  512), causal and not, and at the rollout prefill's (16, 8, 256, 512); K6
  at the train step's shape, causal and not, and causal with `o` (the
  forward's output written beside the gradients, where the wrapper takes
  `o`: K12's backward then launches no K4); then the same at C = 256 (8
  heads, GENIE_35M), C = 128 (4 heads, head groups of 4) and C = 64 (2
  heads, head groups of 2; a rank's share of GENIE_35M's heads at tp = 2
  and 4), labels tagged [C=...]; a width the checkout's wrapper refuses
  prints a `refused` line (a parent's tree from before it). Timed as
  `mlp`. No builds.
- `l2`: three of K12's products at the pre-LN train step's shape (the
  forward's proj with bias and residual, d_ao = dout Wproj^T, dWproj =
  ao^T dout) through this checkout's wrappers, each after one of: nothing
  (the same product before it), a read of 256 MB, a write of 256 MB (each
  more than the card's 50 MB L2), K4 (whose output proj and dWproj then
  take), or K6 (causal, without `o`). Timed as `mlp`, by launch: the
  product is the last launch of each line. Run in a parent's copy and in
  this checkout, it tells whether a product's time follows the kernel
  before it. No builds.
- `decode`: K7 and K8 (`temporal_decode_attention`, `..2_attention`)
  through this checkout's own wrappers at GENIE_138M's decode shape (B=16,
  S=256, C=512, 16 heads, layer 16 of a (16, 32, 16, 256, 512) cache), q,
  k, v the column thirds of one (B, frames, S, 3C) qkv tensor (K2's and
  K3's layout), with the bf16 cache and the int8 one, at two t_B mixes:
  `mixed` (chip_smoke.py's, 0..15, 0 included) and `rollout` (the pre-LN
  rollout's: one frame 8..15, the pair t_prev 8..14). Each result is held
  against the plain version (atol = rtol = 3e-2); prints the device time
  and the bound (the bytes of the slots t < t_B[b] read once, the scales
  of an int8 cache, q, k, v and out; or the operations, as chip_smoke.py
  counts them). The `rollout` rows are K2's and K3's attention launch. No
  builds.
- `rollout`: the pre-LN GENIE_138M rollout of chip_smoke.py (random
  weights from seed 0, B=16, 8 + 8 frames, maskgit_steps 2, temperature 0)
  through this checkout's `RolloutEngine`: the host clock around eight
  synchronized rollouts, the first untimed; prints the seven walls and
  their median. Run in turns in a parent's copy and in this checkout,
  one process each, it compares the end-to-end wall. No builds.
- `fresh`: `fresh_thread_launches`, the check of `chip_smoke.py` phase 5:
  a training-form GEMM launch and K10's backward through their C entry
  points, each as the first card call of a new thread; prints each return
  code and, where it is 0, the error against the plain version. Run in a
  parent's copy, it shows whether that tree's launchers fail there. No
  builds.

- `k2gate`: K2 with the exact-erf GELU on the one input set known to
  put an element of its output past `chip_smoke.py`'s elementwise gate
  (atol = rtol = 3e-2) against the plain bf16 version: the inputs of
  `check_kernels`' erf check when the evaluator-shape checks of
  `check_eval_kernels` draw from the same stream before it. Prints that
  element (kernel, plain, an fp32 run of the plain version on the same
  inputs, and the fp32 residual x1 there) and, against the fp32 run, how
  many elements of the kernel's and of the plain path's output lie
  outside the same gate and their relative L2: whether the kernel or the
  gate is at fault (ROADMAP C4); and what `chip_smoke.held_to_plain`, the
  gate that replaced the elementwise one, gives there. No builds.
- `cli` and `cli_bare`: `chip_smoke.check_evaluation` with its tokenizer
  phase (`cli`) or without it (`cli_bare`), then `check_cli_run`, the
  train CLI at GENIE_138M; prints the CLI's update walls, s/update, busy
  share and device time over two updates. Run in turns, one process each,
  they show whether the tokenizer phase moves the CLI's walls. No builds.
- `tp_cards`: tensor parallelism across four cards over NCCL, one rank a
  card (dp 2 x tp 2; four cards on one host): GENIE_138M at 8 layers,
  pre-LN and qk_norm, under DDP and under FSDP2, one update each against
  one process and the oracles by `chip_smoke.tp_compare`'s gates (every
  rank's parameters bit for bit rank 0's among them), exact launch counts
  per rank, the 16-row rollout over the four ranks token for token. No
  builds; no TP speed.
- `tp_faults`: what the TP phase's update gates (`chip_smoke.tp_update_gates`
  and the ranks' parameters bit for bit) catch. For each of the TP phase's
  setups (`chip_smoke.TP_SETUPS`), the ranks on this card over gloo take
  the update of each model, at the phase's step (`TP_LR`), once as the
  port is and once under each planted fault of a reduction over the model
  group (`TP_FAULTS`); with an architecture named, that model alone and
  only the planted runs (every fault acts on the qk_norm model; the run
  as the port is stands in `chip_smoke.py`'s TP phase); prints, per setup, run and model, the gates that fail,
  each rank's gradient norm against one process's of the same gradients,
  and the parameters past their envelopes (the distance beside the
  limit), and last a line with every parameter's distances and envelope.
  No builds.
- `tp_c9`: ROADMAP C9, one candidate at a time (`C9_VARIANTS`): the
  qk_norm model's TP update in each setup as the port is, with the
  column-parallel or the row-parallel products on cuBLAS, and with the
  spatial flash pair replaced by the plain attention (in the one-process
  reference too); prints per setup and variant each kind's farthest
  distance from fp32, TP's beside one process's, and every spatial qkv
  weight's. No builds.
- `tp_steps`: ROADMAP C9's cause. The TP phase's update gates at the
  train phase's step (1e-5) and at the phase's own (`TP_LR`, 0.1) for
  GENIE_35M at tp = 8 and 4 and GENIE_138M at tp = 2 (or the one setup
  named by its key, such as `genie_35m_tp8`): the gates that fail, the
  largest distances over their envelopes, the share of each update's
  elements that are exactly 0 (below half an ulp of their fp32 weight),
  and for the three farthest parameters the same distances over only the
  elements whose update is nonzero in all four runs (TP, one process, the
  plain bf16 path, fp32). No builds.
- `genie_35m`: `chip_smoke.py`'s GENIE_35M phase alone (the rollout, the
  train step against the plain path, `score_policies`, the evaluator
  batch, the train CLI on configs/genie_35m.json and its resume, all at
  full depth), then its TP setup (four ranks on this card), each printed
  as chip_smoke.py prints it; `mup` the muP phase alone. The kernels
  build at first use.
- `h64_debug`: every library rebuilt with ptxas's register and spill
  counts printed, then each attention check of `chip_smoke.py` (K1 both
  modes, K4, K6, K9/K10, K2/K3/K7/K8 on a 4-layer cache, the decode batch
  sizes, K11/K12) at C = 512 with 8 heads (head_dim 64) and with 16 (32),
  each in a process of its own with a time limit (`H64_DEBUG`): the first
  call after a kernel change, which reports every fault or hang and not
  only the first. `h128_debug` runs every such check at 4 heads (head_dim
  128), with K9/K10 at N = 64 / 192 / 320 / 1024 (`flash_sweep`) and K4 /
  K6 at T = 8 and 32 beside them, then the flash, spatial and frame-axis
  ones at 8 and 16 heads (`H128_DEBUG_NARROW`); `h64_debug h72` every
  check at C = 1152 in 16 heads of 72, then those at C = 576 in 8 (a tp =
  2 rank's width) (`HEAD_DEBUG`). `h128` runs chip_smoke.py's
  head_dim-128 phase alone, then the TP setups at head_dim 64 and 128;
  `h72` the head_dim-72 phase alone.
- `w32_debug`: the temporal, decode and temporal+MLP libraries' ptxas
  lines, then each frame-axis check of `chip_smoke.py` at GENIE_138M-T32's
  window (`W32_DEBUG`: K4 and K6 at T = 20 / 24 / 32 for every head group
  and head_dim 64, then timed at the train step's shape; K2/K3/K7/K8 on a
  4-layer cache of 32 slots; the decode batch sizes; K12; and the T <= 16
  forms), each in a process of its own with a time limit. `w32_times` is
  `ab_times` at T = 32 (caches of 32 slots, K4 and K6 at the train step's
  32 frames, K4's "prefill" the evaluator's), SDPA beside. `k12gate`
  holds K12's forward gate over many draws and splits the error of an
  element past it by stage (ROADMAP C11).
- `ab_times`: the device time of every attention kernel form at
  GENIE_138M's main-path shapes (16 heads) through this checkout's
  wrappers, one JSON line; run in a parent's copy and here in turns
  (parent, change, change, parent) to hold the head_dim-32 forms' times.
  No builds. `ab_times CONFIG` takes one of `AB_CONFIGS`: `h32`, `h64`
  and `h128` the same at 16, 8 and 4 heads (head_dim 32, 64 and 128, the
  same bytes and operations at C = 512), `h72` at C = 1152 in 16 heads
  (GENIE_138M-h72's), with K11, K12 and the SDPA calls
  beside K4, K6, K7, K8, K9 and K10 (run each in a process of its own for
  the widths side by side); `groups` the head_dim-32 forms with K4 / K6
  at head groups of 4 and 2, the serving GEMM chain alone and K13 beside
  them; `one_head` the forms
  one head a rank takes, with their bounds: K4 / K6 at head groups of 1,
  the GEMM at a GENIE_35M tp = 8 rank's products, and each TP sub-layer's
  launch sequence at the rank's shapes of GENIE_35M at tp = 8 and
  GENIE_138M-h128 at tp = 4; `widths` the decode ring's (K7, K8, bf16 and
  int8), K2's and K3's forms at C = 256 and 512, K11, K13 and the LN rows
  at 512: what the model widths' kernels share with the parent's.
- `widths_debug`: the decode, temporal+MLP block, train block and
  layer-norm libraries' ptxas lines, then each check of the model widths
  phase (`WIDTHS_DEBUG`: the decode ring and the LN rows at C = 96 to
  2048 with short last tiles, every kernel form of GENIE_138M-C384 and
  -C1600 at full size, timed with its bound, and the decode batch sizes
  at both widths), each in a process of its own with a time limit.
- `s1024_debug`: the flash and spatial libraries' ptxas lines, then
  each spatial check of `chip_smoke.py` at GENIE_138M-S1024's grid
  (`S1024_DEBUG`: the S sweep of K9, K10, K1 and K11 at S = 64 to 4096,
  K9 / K10 at full shape at both head widths, K1 and K11, the train
  blocks, the decode ring on a 2^32-element cache, K9 / K10 at S = 256 and
  their other token counts at both widths, and the train blocks'
  `held_to_plain` gates at S = 256), each in a process of its own with a
  time limit. `s1024` runs `chip_smoke.check_grid_1024` alone;
  `s1024_times` times K9, K10 (with SDPA beside them), K1 and K11 at
  GENIE_138M-S1024's shapes in a fresh process.
- `c8`: the tokenizer phase's update gate (ROADMAP C8) run after run, with
  cuDNN as the step sets it and with deterministic algorithms, unsteered
  and steered: each run's errors, `undecided` count, gradient digests and
  cuDNN kernels. No builds.

Prints one line per build and case, and the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs
from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import spatial_block as sb

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long


def builds(args, source):
    """{name: library} from NAME=LIB arguments. A LIB that is a `.cu` file
    is built first, beside it, with `kernels.NVCC_FLAGS`, its own folder
    ahead of `tpu1x_torch/csrc` on the include path; all such builds run at
    once."""
    import subprocess
    out, procs = {}, {}
    for arg in args:
        name, path = arg.split("=", 1)
        if path.endswith(".cu"):
            so = path[:-3] + ".so"
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                   str(Path(path).parent), "-I", str(kernels.CSRC), "-o", so,
                   path]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), so)
            out[name] = None
        else:
            out[name] = (kernels.lib(source) if path == "cur"
                         else ctypes.CDLL(path))
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = ctypes.CDLL(so)
    return out


def in_turns(names):
    return list(names) + list(names)[::-1]


# (N, H, D) of `flash`: the qk_norm train step's 256 tokens first, then the
# flash pair's other token counts and head_dim 64, GENIE_138M-S1024's
# 1024 (the streamed forward), and head_dim 128 (GENIE_138M-h128's 4 heads)
FLASH_CASES = ((256, 16, 32), (64, 16, 32), (128, 16, 32), (192, 16, 32),
               (256, 8, 64), (128, 8, 64), (1024, 16, 32), (1024, 8, 64),
               (256, 4, 128), (64, 4, 128), (128, 4, 128), (1024, 4, 128))


def flash(libs, dev):
    R = 128
    for N, H, D in FLASH_CASES:
        g = torch.Generator(device=dev).manual_seed(0)
        qkv = torch.randn(R, N, 3, H, D, generator=g, device=dev).bfloat16()
        q, k, v = qkv.unbind(-3)
        dout = torch.randn(R, N, H, D, generator=g, device=dev).bfloat16()
        rs, ts, crs, cts = q.stride(0), q.stride(1), N * H * D, H * D
        o = torch.empty(R, N, H, D, dtype=torch.bfloat16, device=dev)
        lse = torch.empty(R, H, N, dtype=torch.float32, device=dev)
        dq, dk, dv = (torch.empty_like(o) for _ in range(3))
        work = torch.empty_like(lse)  # the streamed backward's delta
        stream = torch.cuda.current_stream().cuda_stream
        ptr = [t.data_ptr() for t in (q, k, v, o, dout, lse, dq, dk, dv,
                                      work)]
        for lib in libs.values():
            lib.tpu1x_flash_mha.argtypes = ([P] * 5 + [L] * 6 + [I] * 4
                                            + [F, I, P])
            lib.tpu1x_flash_mha_bwd.argtypes = (
                [P] * 10 + [L] * 16 + [I] * 4 + [F, I, P])
        first = {}  # the first build's o and gradients, by causal
        for name in in_turns(libs):
            lib = libs[name]
            for causal in (0, 1):
                shape = (R, N, H, D, D ** -0.5, causal, stream)

                def fwd():
                    return lib.tpu1x_flash_mha(*ptr[:4], ptr[5], rs, ts, rs,
                                               ts, rs, ts, *shape)

                def bwd():
                    return lib.tpu1x_flash_mha_bwd(
                        *ptr, rs, ts, rs, ts, rs, ts, crs, cts, crs, cts,
                        *(crs, cts) * 3, *shape)
                if fwd() != 0 or bwd() != 0:
                    raise RuntimeError(f"{name}: a launch failed")
                got = [t.clone() for t in (o, dq, dk, dv)]
                want = first.setdefault(causal, got)
                errs = {n: cs.grad_errors(f"{name} {n} N={N} D={D}", a, b)
                        for n, a, b in zip(("o", "dq", "dk", "dv"), got,
                                           want)}
                f_ms = cs.device_ms(fwd)
                fwd()  # the backward's o and lse
                print(json.dumps(dict(
                    build=name, N=N, H=H, D=D, causal=causal,
                    fwd_device_ms=f_ms, bwd_device_ms=cs.device_ms(bwd),
                    rel_l2_to_first={n: e["rel_l2"]
                                     for n, e in errs.items()})),
                      flush=True)
        del qkv, q, k, v, dout, o, lse, dq, dk, dv, work
        torch.cuda.empty_cache()


def gemm(libs, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.tpu1x_gemm_sm90.argtypes = [P] * 5 + [I] * 4 + [P]
    cases = [(M, 512, N, resid, None) for M in (4096, 8192, 32768)
             for N, resid in ((1536, False), (512, True))]
    cases += [(M, K, N, resid, act) for M in (4096, 8192)
              for K, N, resid, act in ((512, 2048, False, "tanh"),
                                       (2048, 512, True, None))]
    for M, K, N, resid, act in cases:
        a = torch.randn(M, K, generator=g, device=dev).bfloat16()
        b = (torch.randn(K, N, generator=g, device=dev) * 0.05).bfloat16()
        bias = (torch.randn(N, generator=g, device=dev) * 0.1).bfloat16()
        r = (torch.randn(M, N, generator=g, device=dev).bfloat16()
             if resid else None)
        want = sb.gemm_sm90_plain(a, b, bias, r, act)
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        args = [a.data_ptr(), b.data_ptr(), out.data_ptr(),
                bias.data_ptr(), None if r is None else r.data_ptr(), M,
                N, K, sb.GEMM_ACTS[act]]
        for name in in_turns(libs):
            lib = libs[name]

            def run():
                return lib.tpu1x_gemm_sm90(*args, stream)
            if run() != 0:
                raise RuntimeError(f"{name}: the GEMM did not launch")
            err = cs.compare(f"{name} M={M} N={N}", out, want, 3e-2, 3e-2)
            ms = cs.device_ms(run)
            print(json.dumps(dict(
                build=name, M=M, K=K, N=N, resid=resid, act=act,
                max_abs_err=err, device_ms=ms,
                tflops=cs.tflops(2 * M * K * N, ms))), flush=True)


def tn(libs, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        lib.tpu1x_gemm90_train.argtypes = [P] * 8 + [I] * 5 + [P]
    R, C, F4 = cs.TB * 16 * 256, 512, 2048
    for name, M, N in (("dWfc2", F4, C), ("dWfc1", C, F4),
                       ("dWproj", C, C), ("dWqkv", C, 3 * C)):
        a = torch.randn(R, M, generator=g, device=dev).bfloat16()
        b = torch.randn(R, N, generator=g, device=dev).bfloat16()
        want = tk.gemm90_plain(a, b, form="tn")
        out = torch.empty(M, N, dtype=torch.float32, device=dev)
        for build in in_turns(libs):
            lib = libs[build]

            def run():
                out.zero_()
                return lib.tpu1x_gemm90_train(
                    a.data_ptr(), b.data_ptr(), None, None, out.data_ptr(),
                    None, None, None, M, N, R, tk.MODE["tn"], 0, stream)
            if run() != 0:
                raise RuntimeError(f"{build}: the GEMM did not launch")
            err = cs.grad_errors(f"{build} {name}", out, want)["max_abs_err"]
            ms = cs.device_ms(run)
            print(json.dumps(dict(
                build=build, case=name, M=M, N=N, K=R, max_abs_err=err,
                device_ms=ms, tflops=cs.tflops(2 * M * N * R, ms))),
                flush=True)


def by_launch(fn, iters: int = 20):
    """[[kernel name, device ms], ...] for each launch of one call of `fn`,
    in launch order, the mean over `iters` calls in one profiler window;
    None if the window's kernels do not split into `iters` equal calls (a
    window that lost events)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    n = len(ev) // iters
    if n == 0 or n * iters != len(ev) or any(
            ev[i].name != ev[i % n].name for i in range(len(ev))):
        return None
    return [[ev[i].name, sum(ev[i + j * n].time_range.elapsed_us()
                             for j in range(iters)) / 1e3 / iters]
            for i in range(n)]


def block(dev):
    from tpu1x_torch.ops import temporal_mlp_block as tmb
    inp = cs.Inputs(0, dev)
    C, H, L, T, S = 512, 16, 32, 16, 256
    kc, vc = inp.normal(T, L, cs.B, S, C), inp.normal(T, L, cs.B, S, C)
    for pair in (False, True):
        w = cs.block_weights(inp, C)
        frames = 2 if pair else 1
        x = inp.normal(cs.B, frames, S, C) if pair else inp.normal(cs.B, S, C)
        t_B = (cs.P + torch.arange(cs.B, device=dev) % (T - cs.P - frames + 1)
               ).to(torch.int32)
        kernel = tmb.temporal_mlp_block_pair if pair else tmb.temporal_mlp_block
        kw = dict(layer=L // 2, scale=(C // H) ** -0.5, num_heads=H,
                  gelu_tanh=True, **w)

        def run():
            return kernel(x, kc, vc, t_B, **kw)
        print(json.dumps(dict(kernel=kernel.__name__, shape=list(x.shape),
                              device_ms=cs.device_ms(run),
                              event_ms=cs.time_ms(run),
                              by_launch=by_launch(run))), flush=True)


def timed_calls(calls):
    """One line for each (label, fn) of `calls`: device time, event time and
    device time by launch of one call."""
    for label, fn in calls:
        print(json.dumps(dict(kernel=label, device_ms=cs.device_ms(fn),
                              event_ms=cs.time_ms(fn),
                              by_launch=by_launch(fn))), flush=True)


def mlp(dev):
    from tpu1x_torch.ops import mlp_train_block as mtb
    inp = cs.Inputs(0, dev)
    C, N, S = 512, cs.TB * 16, 256
    w = cs.block_weights(inp, C)
    x, dout = inp.normal(N, S, C), inp.normal(N, S, C)
    calls = []
    for tag, ln in (("", (w["ln_scale"], w["ln_bias"])),
                    ("[no-ln]", (None, None))):
        calls += [
            ("mlp_train_block" + tag, lambda ln=ln: mtb.mlp_train_block_fwd(
                x, w["wfc1"], w["wfc2"], w["bfc1"], w["bfc2"], *ln,
                gelu_approx=False)),
            ("mlp_train_block_bwd" + tag,
             lambda ln=ln: mtb.mlp_train_block_bwd(
                 x, dout, w["wfc1"], w["wfc2"], w["bfc1"], *ln,
                 gelu_approx=False, bias=True))]
    timed_calls(calls)


def train(dev):
    from tpu1x_torch.ops import spatial_train_block as stb
    from tpu1x_torch.ops import temporal_train_block as ttb
    inp = cs.Inputs(0, dev)
    C, H, S, T = 512, 16, 256, 16
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    sw = cs.spatial_weights(inp, C)
    xs, ds = inp.normal(cs.TB * T, S, C), inp.normal(cs.TB * T, S, C)
    xt, dt = inp.normal(cs.TB, T, S, C), inp.normal(cs.TB, T, S, C)
    timed_calls([
        ("spatial_train_block_bwd", lambda: stb.spatial_train_block_bwd(
            xs, ds, sw["wqkv"], sw["wproj"], None, sw["ln_scale"],
            sw["ln_bias"], proj_bias=True, **kw)),
        ("temporal_train_block", lambda: ttb.temporal_train_block_fwd(
            xt, sw["wqkv"], sw["wproj"], None, sw["bproj"], **kw)),
        ("temporal_train_block_bwd", lambda: ttb.temporal_train_block_bwd(
            xt, dt, sw["wqkv"], sw["wproj"], None, proj_bias=True, **kw))])


def temporal(dev):
    """K4 and K6 at GENIE_138M's C = 512 and GENIE_35M's C = 256 (head
    groups of 8), at C = 128 (4 heads, head groups of 4: a rank's share at
    tp = 2 of GENIE_35M) and at C = 64 (2 heads, head groups of 2: a rank's
    share at tp = 4), their labels tagged [C=...] but at C = 512. A width
    that the checkout's wrapper refuses prints a `refused` line."""
    from tpu1x_torch.ops import temporal_attention as ta
    for C in (512, 256, 128, 64):
        try:
            ta._check_qkv(*cs.Inputs(0, dev).normal(1, 16, 256, 3 * C).split(
                C, dim=-1), C // 32)
        except ValueError as e:  # a tree from before this width
            print(json.dumps(dict(kernel=f"temporal_attention[C={C}]",
                                  refused=str(e))), flush=True)
            continue
        timed_calls(temporal_calls(dev, C))


def temporal_calls(dev, C):
    import inspect
    from tpu1x_torch.ops import temporal_attention as ta
    inp = cs.Inputs(0, dev)
    H = C // 32
    kw = dict(scale=(C // H) ** -0.5, num_heads=H)
    width = "" if C == 512 else f"[C={C}]"
    calls = []
    for tag, (Bt, T) in (("train", (cs.TB, 16)), ("prefill", (cs.B, cs.P))):
        q, k, v = inp.normal(Bt, T, 256, 3 * C).split(C, dim=-1)
        for causal in ((True, False) if tag == "train" else (True,)):
            calls.append((f"temporal_attention[{tag},causal={causal}]"
                          + width,
                          lambda q=q, k=k, v=v, causal=causal:
                          ta.launch_forward(q, k, v, causal=causal, **kw)))
        if tag != "train":
            continue
        dout = inp.normal(Bt, T, 256, C)
        for causal in (True, False):
            calls.append((f"temporal_attention_bwd[causal={causal}]"
                          + width,
                          lambda q=q, k=k, v=v, causal=causal:
                          ta.launch_backward(q, k, v, dout, causal=causal,
                                             **kw)))
        if "o" in inspect.signature(ta.launch_backward).parameters:
            o = torch.empty_like(dout)
            calls.append(("temporal_attention_bwd[causal=True,o]" + width,
                          lambda q=q, k=k, v=v: ta.launch_backward(
                              q, k, v, dout, causal=True, o=o, **kw)))
    return calls


def ta_builds(libs, dev):
    from tpu1x_torch.ops import temporal_attention as ta
    inp = cs.Inputs(0, dev)
    C, H = 512, 16
    scale = (C // H) ** -0.5
    kw = dict(scale=scale, num_heads=H, causal=True)
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        for fn, argtypes in kernels.SIGNATURES["temporal_attention"]:
            getattr(lib, fn).argtypes = argtypes
    for tag, (Bt, T) in (("train", (cs.TB, 16)), ("prefill", (cs.B, cs.P))):
        qkv = inp.normal(Bt, T, 256, 3 * C)
        q, k, v = qkv.split(C, dim=-1)
        dout = inp.normal(Bt, T, 256, C)
        o = torch.empty_like(dout)
        dqkv = torch.empty_like(qkv)
        ptr = [t.data_ptr() for t in (q, k, v, dout, o, *dqkv.split(C, -1))]
        want_o = ta.temporal_attention_plain(q, k, v, **kw)
        want_d = (ta.temporal_attention_bwd_plain(q, k, v, dout, **kw)
                  if tag == "train" else None)
        for name in in_turns(libs):
            lib = libs[name]

            def fwd():
                return lib.tpu1x_temporal_attention(
                    *ptr[:3], ptr[4], Bt, T, 256, C, C // H, 3 * C, scale, 1,
                    stream)

            def bwd(with_o):
                return lib.tpu1x_temporal_attention_bwd(
                    *ptr[:4], ptr[4] if with_o else None, *ptr[5:], Bt, T,
                    256, C, C // H, 3 * C, C, 3 * C, scale, 1, stream)
            if fwd() != 0:
                raise RuntimeError(f"{name}: the forward did not launch")
            row = dict(build=name, case=tag, shape=[Bt, T, 256, C],
                       fwd_err=cs.compare(f"{name} {tag}", o, want_o, 3e-2,
                                          3e-2),
                       fwd_device_ms=cs.device_ms(fwd))
            for with_o in ((False, True) if want_d is not None else ()):
                if bwd(with_o) != 0:
                    raise RuntimeError(f"{name}: the backward did not launch")
                for i, g in enumerate("qkv"):
                    cs.grad_errors(f"{name} d{g}", dqkv.split(C, -1)[i],
                                   want_d.split(C, -1)[i])
                row["bwd_o_device_ms" if with_o else "bwd_device_ms"] = \
                    cs.device_ms(lambda with_o=with_o: bwd(with_o))
            print(json.dumps(row), flush=True)


def l2(dev):
    from tpu1x_torch.ops import temporal_attention as ta
    inp = cs.Inputs(0, dev)
    C, H, S, T = 512, 16, 256, 16
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, causal=True)
    sw = cs.spatial_weights(inp, C)
    x, dout = inp.normal(cs.TB, T, S, C), inp.normal(cs.TB, T, S, C)
    x2, do2 = x.view(-1, C), dout.view(-1, C)
    q, k, v = tk.gemm90(x2, sw["wqkv"]).view(cs.TB, T, S, 3 * C).split(
        C, dim=-1)
    ao = ta.launch_forward(q, k, v, **kw)
    d_ao = tk.gemm90(do2, sw["wproj"], form="nt").view(x.shape)
    buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    products = {
        "proj": lambda a: tk.gemm90(a.reshape(-1, C), sw["wproj"],
                                    bias=sw["bproj"], resid=x2),
        "d_ao": lambda a: tk.gemm90(do2, sw["wproj"], form="nt"),
        "dWproj": lambda a: tk.gemm90(a.reshape(-1, C), do2, form="tn")}
    # what runs before the product; the product takes the attention output
    # it returns (K4's own, else the one above)
    before = {
        "alone": lambda: ao,
        "read 256 MB": lambda: (buf.sum(), ao)[1],
        "write 256 MB": lambda: (buf.zero_(), ao)[1],
        "K4": lambda: ta.launch_forward(q, k, v, **kw),
        "K6": lambda: (ta.launch_backward(q, k, v, d_ao, **kw), ao)[1]}
    calls = [(f"{name}[after {b}]", lambda p=p, f=f: p(f()))
             for name, p in products.items() for b, f in before.items()]
    timed_calls(calls)

def rollout(dev):
    from tpu1x_torch.model_zoo import genie_138m
    from tpu1x_torch.models.st_maskgit import STMaskGIT
    from tpu1x_torch.rollout.engine import RolloutEngine
    cfg = genie_138m()
    g = torch.Generator(device=dev).manual_seed(0)
    model = STMaskGIT(cfg, device=dev).init_weights(g)
    engine = RolloutEngine(model, cfg, device=dev, maskgit_steps=cs.STEPS,
                           temperature=0.0)
    side = cfg.latent_side_len
    prompt = torch.randint(0, cfg.image_vocab_size, (cs.B, cs.P, side, side),
                           generator=g, device=dev)
    walls = []
    for _ in range(8):
        gen = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.rollout(prompt, cs.NEW, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls = walls[1:]  # the first call sets up
    print(json.dumps(dict(kernel="rollout", walls=walls,
                          median=sorted(walls)[len(walls) // 2])), flush=True)


# GENIE_138M's decode: C, heads, layers, T, S
DECODE_SHAPE = (512, 16, 32, 16, 256)


def decode_bound(t_B, S, C, frames, kc, scales):
    """The decode attention's bound at this run's t_B: the cache slots t <
    t_B[b] read once (and an int8 cache's scales), q, k, v read and out
    written once; or its operations. `chip_smoke.py` takes it from here."""
    Bt = t_B.numel()
    slots = int(t_B.sum())  # this run's data: slots t < t_B[b] per row
    cache_bytes = 2 * slots * S * (C * kc.element_size()
                                   + (4 if scales is not None else 0))
    macs = Bt * S * C * (frames * slots / Bt + frames * (frames + 1) / 2)
    # q.k: bf16 operands (int8 values are exact in bf16); p.v in fp32
    return cs.bound(cache_bytes + 4 * frames * Bt * S * C * 2
                    + cs.nbytes(t_B), tensor_flops=2 * macs,
                    fp32_flops=2 * macs)


def decode_cases(dev):
    """The K7/K8 cases of `decode` and `da`: dicts with the wrapper, its
    plain version, their arguments and the bound."""
    from tpu1x_torch.ops import decode_attention as da
    inp = cs.Inputs(0, dev)
    C, H, L, T, S = DECODE_SHAPE
    B = cs.B
    kc, vc = inp.normal(T, L, B, S, C), inp.normal(T, L, B, S, C)
    (kq, ks), (vq, vs) = cs.quantize_cache(kc), cs.quantize_cache(vc)
    caches = {"bf16": (kc, vc, None, None), "int8": (kq, vq, ks, vs)}
    rows = torch.arange(B, device=dev)
    cases = []
    for frames in (1, 2):
        q, k, v = inp.normal(B, frames, S, 3 * C).split(C, dim=-1)
        q, k, v = q.unbind(1), k.unbind(1), v.unbind(1)
        for mix in ("mixed", "rollout"):
            t_B = (rows * 7 % (T - frames + 1) if mix == "mixed"
                   else cs.P + rows % (T - cs.P - frames + 1)).to(torch.int32)
            for cache, (kcc, vcc, ksc, vsc) in caches.items():
                if frames == 1:
                    args = (q[0], kcc, vcc, k[0], v[0], t_B)
                    kernel, plain = (da.temporal_decode_attention,
                                     da.temporal_decode_attention_plain)
                else:
                    args = (q[0], q[1], kcc, vcc, k[0], v[0], k[1], v[1],
                            t_B)
                    kernel, plain = (da.temporal_decode2_attention,
                                     da.temporal_decode2_attention_plain)
                kw = dict(layer=L // 2, scale=(C // H) ** -0.5, num_heads=H,
                          k_scale=ksc, v_scale=vsc)
                bms, by = decode_bound(t_B, S, C, frames, kcc, ksc)
                cases.append(dict(
                    name=f"{kernel.__name__}[{cache},{mix}]", frames=frames,
                    kernel=kernel, plain=plain, args=args, kw=kw, q=q, k=k,
                    v=v, caches=(kcc, vcc, ksc, vsc), t_B=t_B,
                    dims=(B, frames, S, C, T, L), bound_ms=bms, bound_by=by,
                    t_B_list=t_B.tolist()))
    return cases


def decode(dev):
    for c in decode_cases(dev):
        got = c["kernel"](*c["args"], **c["kw"])
        want = c["plain"](*c["args"], **c["kw"])
        if c["frames"] == 1:
            got, want = (got,), (want,)
        err = max(cs.compare(c["name"], g, w, 3e-2, 3e-2)
                  for g, w in zip(got, want))
        ms = cs.device_ms(lambda: c["kernel"](*c["args"], **c["kw"]))
        print(json.dumps(dict(
            kernel=c["name"], t_B=c["t_B_list"], max_abs_err=err,
            device_ms=ms, bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            share_of_bound=c["bound_ms"] / ms if ms else None)), flush=True)


def da_builds(libs, dev):
    from tpu1x_torch.ops import decode_attention as da
    stream = torch.cuda.current_stream().cuda_stream
    for lib in libs.values():
        for fn, argtypes in kernels.SIGNATURES["decode_attention"]:
            getattr(lib, fn).argtypes = argtypes
    for c in decode_cases(dev):
        B, frames, S, C, T, L = c["dims"]
        kcc, vcc, ksc, vsc = c["caches"]
        want = c["plain"](*c["args"], **c["kw"])
        want = (want,) if frames == 1 else want
        out = torch.empty(frames, B, S, C, dtype=torch.bfloat16, device=dev)

        def second(ts):
            return ts[1].data_ptr() if frames == 2 else None
        q, k, v = c["q"], c["k"], c["v"]
        args = (q[0].data_ptr(), second(q), k[0].data_ptr(), second(k),
                v[0].data_ptr(), second(v), *q[0].stride()[:2],
                *k[0].stride()[:2], *v[0].stride()[:2], kcc.data_ptr(),
                vcc.data_ptr(), None if ksc is None else ksc.data_ptr(),
                None if vsc is None else vsc.data_ptr(), c["t_B"].data_ptr(),
                out[0].data_ptr(), out[1].data_ptr() if frames == 2 else None,
                S * C, C, None, None, B, frames, S, C,
                C // c["kw"]["num_heads"], T, L, c["kw"]["layer"],
                c["kw"]["scale"], stream)
        for name in in_turns(libs):
            lib = libs[name]

            def run():
                return lib.tpu1x_decode_attention(*args)
            out.zero_()
            if run() != 0:
                raise RuntimeError(f"{name}: the kernel did not launch")
            err = max(cs.compare(f"{name} {c['name']}", out[f], want[f],
                                 3e-2, 3e-2) for f in range(frames))
            ms = cs.device_ms(run)
            print(json.dumps(dict(
                build=name, kernel=c["name"], max_abs_err=err, device_ms=ms,
                bound_ms=c["bound_ms"],
                share_of_bound=c["bound_ms"] / ms if ms else None)),
                flush=True)


def fresh_thread_launches(inp, C, H):
    """A training-form GEMM launch (K13's fc1 at 4096 rows: bias and the
    erf GELU) and K10's backward (at (8, 256, H, 32), from the forward's
    residuals), each through its C entry point as the first call to the card
    of a new thread, which has no CUDA context current yet, as autograd's
    backward thread has none when a backward is the first thing it runs: the
    tensor-map encoder fails there unless the launcher binds the card.
    Inputs and outputs come from this thread, where each entry point has
    launched once before (so no first-use setup runs in the new one). Returns
    {name: {"rc": the return code, and where it is 0 the error against the
    plain version, by the gates of chip_smoke.py phase 5}}."""
    import threading
    from tpu1x_torch.ops import attention as attn
    a, w = inp.normal(4096, C), inp.normal(C, 4 * C, std=0.05)
    bias = inp.normal(4 * C, std=0.1)
    g = torch.empty(4096, 4 * C, dtype=torch.bfloat16, device=a.device)
    qkv = inp.normal(8, 256, 3, H, 32)
    q, k, v = qkv.unbind(-3)
    dout = inp.normal(8, 256, H, 32)
    kw = dict(scale=32 ** -0.5, causal=False)
    o, lse = attn.flash_mha_fwd(q, k, v, **kw)
    dq, dk, dv = (torch.empty_like(dout) for _ in range(3))
    work = torch.empty_like(lse)
    rs, ts, crs, cts = q.stride(0), q.stride(1), *dout.stride()[:2]
    stream = torch.cuda.current_stream().cuda_stream
    train, flash = kernels.lib("train_block"), kernels.lib("flash_attention")
    launches = {
        "gemm90[nn, gelu_erf]": lambda: train.tpu1x_gemm90_train(
            a.data_ptr(), w.data_ptr(), g.data_ptr(), None, None,
            bias.data_ptr(), None, None, 4096, 4 * C, C, tk.MODE["nn"],
            tk.ACT["gelu_erf"], stream),
        "flash_mha_bwd": lambda: flash.tpu1x_flash_mha_bwd(
            *(t.data_ptr() for t in (q, k, v, o, dout, lse, dq, dk, dv,
                                     work)),
            rs, ts, rs, ts, rs, ts, *(crs, cts) * 5, 8, 256, H, 32,
            kw["scale"], 0, stream)}
    rc = {}
    for name, launch in launches.items():
        kernels.check(launch(), name)  # this thread's, with its context
        torch.cuda.synchronize()
        th = threading.Thread(target=lambda n=name, f=launch: rc.update(
            {n: f()}))
        th.start()
        th.join()
        torch.cuda.synchronize()
    out = {name: {"rc": r} for name, r in rc.items()}
    if rc["gemm90[nn, gelu_erf]"] == 0:
        out["gemm90[nn, gelu_erf]"]["max_abs_err"] = cs.compare(
            "gemm90 in a new thread", g,
            tk.gemm90_plain(a, w, bias=bias, act="gelu_erf"), 3e-2, 3e-2)
    if rc["flash_mha_bwd"] == 0:
        want = attn.flash_mha_bwd_plain(q, k, v, o, lse, dout, **kw)
        out["flash_mha_bwd"].update({
            f"d{c}": cs.grad_errors(f"flash_mha_bwd in a new thread d{c}",
                                    got, w_)
            for c, got, w_ in zip("qkv", (dq, dk, dv), want)})
    return out


def fresh(dev):
    print(json.dumps(fresh_thread_launches(cs.Inputs(3, dev), 512, 16)),
          flush=True)


def k2gate(dev):
    from tpu1x_torch.ops._util import dense
    from tpu1x_torch.ops.decode_attention import (
        temporal_decode_attention_reference)
    from tpu1x_torch.ops.temporal_mlp_block import (temporal_mlp_block,
                                                    temporal_mlp_block_plain)
    C, H, L, B = 512, 16, 32, cs.B
    timing = cs.time_ms, cs.device_ms
    cs.time_ms = cs.device_ms = lambda fn, **kw: 0.0  # inputs only
    inp = cs.Inputs(0, dev)
    try:  # check_kernels' draws up to the erf check, the eval checks' too
        cs.check_layer_norm(inp, C)
        cs.check_temporal_attention(inp, C, H)
        cs.check_temporal_attention(inp, C, H, eval_shapes=True)
        cs.check_temporal_attention(inp, 256, 8)
        for n in (B, 2 * B, B * cs.P, B * 16):
            cs.check_spatial_block(inp, C, H, n)
        cs.check_spatial_block(inp, 256, 8, B)
        cs.check_gemm_sm90(inp, C)
        kc, vc = (inp.normal(16, L, B, 256, C), inp.normal(16, L, B, 256, C))
        cs.check_temporal_mlp_block(inp, C, H, L, (kc, vc), False)
    finally:
        cs.time_ms, cs.device_ms = timing
    w = cs.block_weights(inp, C)  # the erf check's draws, as it makes them
    x = inp.normal(B, 256, C)
    t_B = (cs.P + torch.arange(B, device=dev) % (16 - cs.P)).to(torch.int32)
    layer = L // 2
    kw = dict(scale=(C // H) ** -0.5, num_heads=H, gelu_tanh=False, **w)
    kl, vl = kc[:, layer], vc[:, layer]
    got = temporal_mlp_block(x, kc, vc, t_B, layer=layer, **kw)[0].float()
    want = temporal_mlp_block_plain(x, kl, vl, t_B, **kw)[0].float()
    f32 = {k: v.float() if torch.is_tensor(v) else v for k, v in kw.items()}
    y32 = temporal_mlp_block_plain(x.float(), kl.float(), vl.float(), t_B,
                                   **f32)[0]
    q, k, v = dense(x.float(), f32["wqkv"], None).split(C, dim=-1)
    att = temporal_decode_attention_reference(
        q, kl.float(), vl.float(), k, v, t_B, scale=kw["scale"], num_heads=H)
    x1 = x.float() + dense(att, f32["wproj"], f32["bproj"])

    def past(a, ref):  # how far past the gate, elementwise
        return (a - ref).abs() - 3e-2 - 3e-2 * ref.abs()
    i = int(past(got, want).argmax())

    def at(t):
        return float(t.reshape(-1)[i])
    print(json.dumps({
        "k2gate": {"held_to_plain": cs.held_to_plain(
                       "k2gate", got, want, y32, 3e-2),
                   "past_gate_vs_plain": int((past(got, want) > 0).sum()),
                   "element": {"kernel": at(got), "plain": at(want),
                               "fp32": at(y32), "x1_fp32": at(x1)},
                   "past_gate_vs_fp32": {"kernel": int((past(got, y32) > 0)
                                                       .sum()),
                                         "plain": int((past(want, y32) > 0)
                                                      .sum())},
                   "rel_l2_vs_fp32": {"kernel": cs.rel_l2(got, y32),
                                      "plain": cs.rel_l2(want, y32)},
                   "elements": got.numel()}}), flush=True)


def cli_after_evaluation(dev, tokenizer=True):
    """`chip_smoke.check_cli_run` (the train CLI at GENIE_138M) after
    `check_evaluation`, with its tokenizer phase (`cli`) or without it
    (`cli_bare`), as chip_smoke.py orders them; prints the CLI's update
    walls and its busy share over two updates. Run the two in turns, one
    process each, to see whether the tokenizer phase moves the walls."""
    if not tokenizer:
        cs.check_tokenizer = lambda *a, **k: {}
    cfg = cs.genie_138m()
    cs.check_evaluation(cfg, dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.check_cli_run(cfg, dev, Path(tmp))
    busy = out["busy_updates_4_5"]
    print(json.dumps(dict(
        kernel="cli", tokenizer_phase=tokenizer, walls=out["update_walls_s"],
        s_per_update=out["s_per_update"], busy_share=busy["busy_share"],
        device_ms=busy["device_ms"])), flush=True)


def tp_cards(dev, cards: int = 4):
    """Tensor parallelism across `cards` cards over NCCL, one rank a card
    (dp 2 x tp 2 on four): GENIE_138M at 8 layers, pre-LN and qk_norm,
    with DDP and with FSDP2 over the data axis, one update each against
    this process's references (the gates of `chip_smoke.tp_compare`),
    exact launch counts per rank, and the 16-row rollout over every rank,
    token for token this process's. Prints one line with the results and
    the ranks' wall (no TP speed: the wall holds start-up, the build's load
    and the references)."""
    if dev.type == "cuda" and torch.cuda.device_count() < cards:
        raise RuntimeError(f"tp_cards needs {cards} cards, found "
                           f"{torch.cuda.device_count()}")
    inputs = cs.tp_inputs(dev)
    refs, rollouts = cs.tp_references(inputs, dev)
    ranks, wall = cs.tp_children(
        inputs, cards, lambda r, port, tmp: [
            str(Path(__file__).resolve()), "tp_cards_rank", str(r),
            str(cards), str(port), tmp, dev.type])
    out = cs.tp_compare(inputs, refs, ranks, rollouts)
    print(json.dumps(dict(kernel="tp_cards", cards=cards, ranks_wall_s=wall,
                          results=cs.tp_summary(out))), flush=True)


def tp_cards_rank(rank: int, cards: int, port: int, tmp: str,
                  device: str) -> int:
    """One rank of `tp_cards`: its own card, NCCL between the cards (gloo
    on the CPU); writes its results to DIR/rank{R}.pt."""
    from tpu1x_torch.parallel.mesh import init_distributed
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device(device)
    init_distributed(device, f"tcp://localhost:{port}", cards, rank)
    try:
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        res = {}
        for fsdp in (False, True):
            for arch in cs.TP_ARCHS:
                metrics, launches, whole, state = cs.tp_update(
                    arch, inputs[arch], dev, tp=2, fsdp=fsdp)
                res[arch + ("+fsdp" if fsdp else "")] = dict(
                    metrics=metrics, launches=launches, params=whole)
                mesh = cs.mesh_of(state.model)
                del state
        res["rollouts"] = cs.tp_rollouts(inputs["pre_ln"]["init"],
                                         inputs["pre_ln"]["cfg"],
                                         inputs["prompt"], dev, mesh)
        torch.save(res, Path(tmp) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


# planted faults of a reduction over the model group, for `tp_faults`
TP_FAULTS = {
    "qk_ln": "each rank's qk-LN gradient from its own heads alone "
             "(Megatron's f left off the qk-LN's parameters)",
    "f": "Megatron's f left off the column-parallel products: their input "
         "gets the rank's partial gradient",
    "mlp_dxn": "the MLP sub-layer's backward leaves d_xn unsummed",
    "norm": "the split parameters' squares not summed over the model group "
            "in the gradient norm",
    "agree": "the replicated parameters' gradients not made alike over the "
             "model group",
}


def _plant(fault: str) -> None:
    """Plant `fault` (a key of TP_FAULTS) in this process."""
    from tpu1x_torch.parallel import tensor as tpl
    from tpu1x_torch.train import optim
    if fault == "qk_ln":
        f = tpl.copy_to_model
        tpl.copy_to_model = lambda t, m: t if t.dim() == 1 else f(t, m)
    elif fault == "f":
        def backward(ctx, dy):
            x, wc = ctx.saved_tensors
            dy = dy.contiguous()
            dx = tk.gemm90(dy, wc.t().contiguous(), form="nt",
                           fp32_out=True).to(x.dtype)  # not summed
            dw = tpl._counted("tp_column_parallel_bwd", x,
                              tk.gemm90(dy, x, form="tn"))
            return dx, dw.to(ctx.wdtype), None
        tpl._ColumnParallel.backward = staticmethod(backward)
    elif fault == "mlp_dxn":
        steps = tpl.mtb.mlp_train_block_steps

        def unsummed(*args, **kw):
            g = steps(*args, **kw)
            part = next(g)
            own = part.clone()  # the all-reduce sums in place
            yield part  # the sum comes back, and is dropped
            try:
                g.send(own)
            except StopIteration as done:
                return done.value
        tpl.mtb.mlp_train_block_steps = unsummed
    elif fault == "norm":
        optim.model_all_reduce = lambda t, m: t
    elif fault == "agree":
        optim.TrainOptimizer._agree = lambda self, local: None


def tp_faults(dev, arch=None):
    """The TP phase's update gates against planted faults (`TP_FAULTS`):
    for each of `chip_smoke.TP_SETUPS` the ranks, on this card over gloo,
    take each model's update (at `TP_LR`) as the port is, then under each
    fault; with `arch` ("pre_ln" or "qk_norm") that model's alone and only
    under the faults. Each run is held to this process's references by
    `chip_smoke.tp_update_gates` (the gradient norm read against one
    process's of the same gradients among them) and the ranks' parameters
    to rank 0's bit for bit. Prints a line per setup, run and model, then
    one with the per-parameter tables."""
    archs = cs.TP_ARCHS if arch is None else (arch,)
    runs = ("none", *TP_FAULTS) if arch is None else tuple(TP_FAULTS)
    out = {}
    # the largest model groups first: the one-head-a-rank setups
    for setup, make, tp in sorted(cs.TP_SETUPS, key=lambda s: -s[2]):
        inputs = cs.tp_inputs(dev, make, tp)
        inputs["archs"] = archs
        refs, _ = cs.tp_references(inputs, dev)
        for fault in runs:
            ranks, wall = cs.tp_children(
                inputs, tp, lambda r, port, tmp: [
                    str(Path(__file__).resolve()), "tp_fault_rank", str(r),
                    str(port), tmp, str(dev), fault])
            for arch in archs:
                init = inputs[arch]["init"]
                res, failed = cs.tp_update_gates(init, ranks[0][arch],
                                                 refs[arch])
                apart = sorted(
                    k for r in ranks[1:] for k, v in r[arch]["params"].items()
                    if not torch.equal(v, ranks[0][arch]["params"][k]))
                if apart:
                    failed.append(f"the ranks' parameters differ: {apart}")
                out[f"{cs.setup_key(setup, tp)}/{fault}/{arch}"] = res[
                    "per_parameter"]
                print(json.dumps(dict(
                    kernel="tp_faults", setup=setup, tp=tp, fault=fault,
                    arch=arch, what=TP_FAULTS.get(fault, "the port as it is"),
                    fails=[f[:300] for f in failed],
                    update_rel_l2=res["update_rel_l2"],
                    grad_norm=[res["metrics"]["grad_norm"],
                               res["one_process"]["grad_norm"]],
                    grad_norm_vs_whole=[
                        abs(r[arch]["metrics"]["grad_norm"]
                            / r[arch]["metrics"]["grad_norm_whole"] - 1)
                        for r in ranks],
                    over={k: (d["tp_fp32"], d["envelope"])
                          for k, d in res["per_parameter_over"].items()},
                    nearest_envelope=[(k, d["tp_fp32"], d["envelope"])
                                      for k, d in res["nearest_envelope"]],
                    ranks_apart=len(apart), wall_s=wall)), flush=True)
    print(json.dumps(dict(kernel="tp_faults_tables", tables=out)),
          flush=True)


def tp_fault_rank(rank: int, port: int, tmp: str, device: str,
                  fault: str) -> int:
    """One rank of `tp_faults` and `tp_c9`: the update of each model of the
    inputs (`archs`, else TP_ARCHS) split over their model group with
    `fault` planted (a key of TP_FAULTS) or swapped in (a key of
    C9_VARIANTS); "none" or "as_is": as the port is."""
    from tpu1x_torch.parallel.mesh import init_distributed
    if fault in TP_FAULTS:
        _plant(fault)
    dev = torch.device(device)
    inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    init_distributed(str(dev), f"tcp://localhost:{port}", inputs["tp"], rank,
                     backend="gloo")
    try:
        res = {}
        with c9_swapped(fault):
            for arch in inputs.get("archs", cs.TP_ARCHS):
                metrics, launches, whole, state = cs.tp_update(
                    arch, inputs[arch], dev, tp=inputs["tp"])
                res[arch] = dict(metrics=metrics, launches=launches,
                                 params=whole)
                del state
        torch.save(res, Path(tmp) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


# one candidate at a time for the qk_norm TP update's distance from fp32
# (ROADMAP C9), for `tp_c9`
C9_VARIANTS = {
    "as_is": "the port as it is",
    "column": "column_parallel's backward products on cuBLAS (an fp32 "
              "partial of dx from torch.matmul of fp32 copies, dw by "
              "torch.matmul in bf16, as one process's autograd) instead "
              "of gemm90",
    "row": "row_parallel's products on cuBLAS (the partial by torch.matmul "
           "of fp32 copies, the backward by torch.matmul in bf16) instead "
           "of gemm90",
    "plain_attn": "the spatial attention's flash pair (K9, K10) replaced "
                  "by the plain attention under autograd, in the ranks and "
                  "in the one-process reference",
}


def tp_steps(dev, only=None):
    """ROADMAP C9's cause: the TP phase's update gates at the train phase's
    step (TRAIN_LR, 1e-5) and at the phase's own (TP_LR), for GENIE_35M at
    tp = 8 and 4 and GENIE_138M at tp = 2 (or the setup whose key is
    `only`) on this card: per setup, step and model the gates that fail,
    the largest distance from fp32 over its envelope (three parameters),
    the share of each update's elements that are exactly 0 (an update
    below half an ulp of its fp32 weight), and for those three parameters
    each run's distance from fp32 over only the elements whose update is
    nonzero in the TP run, one process's, the plain bf16 path's and fp32's
    (`masked`, with that share of the elements): a fault of the TP update
    parts it there as well, a rounding to 0 does not. No builds."""
    from tpu1x_torch.model_zoo import genie_35m
    setups = (("genie_35m", genie_35m, 8), ("genie_35m", genie_35m, 4),
              ("genie_138m", cs.genie_138m, 2))
    setups = [s for s in setups
              if only is None or cs.setup_key(s[0], s[2]) == only]
    for lr in (cs.TRAIN_LR, cs.TP_LR):
        cs.TP_OPT = dict(cs.TP_OPT, learning_rate=lr)
        for name, make, tp in setups:
            inputs = cs.tp_inputs(dev, make, tp)
            refs, _ = cs.tp_references(inputs, dev)
            ranks, wall = cs.tp_children(inputs, tp, lambda r, port, tmp: [
                str(Path(cs.__file__).resolve()), "--tp-rank", str(r),
                str(port), tmp, str(dev)])
            for arch in cs.TP_ARCHS:
                init = inputs[arch]["init"]
                res, failed = cs.tp_update_gates(init, ranks[0][arch],
                                                 refs[arch])
                worst = sorted(((d["tp_fp32"] / d["envelope"], k) for k, d
                                in res["per_parameter"].items()),
                               reverse=True)[:3]
                runs = dict(tp=ranks[0][arch], **refs[arch])
                masked = {}
                for _, k in worst:
                    u = {n: r["params"][k] - init[k].float()
                         for n, r in runs.items()}
                    keep = torch.stack([v != 0 for v in u.values()]).all(0)
                    masked[k] = dict(
                        share=float(keep.float().mean()),
                        **{f"{n}_fp32": cs.tp_distance(u[n][keep],
                                                       u["fp32"][keep])
                           for n in ("tp", "one", "bf16")})
                print(json.dumps(dict(
                    kernel="tp_steps", lr=lr,
                    setup=cs.setup_key(name, tp), arch=arch,
                    failed=[f[:300] for f in failed],
                    update_rel_l2=res["update_rel_l2"], worst=worst,
                    masked=masked, zero_share=res["zero_share"],
                    wall_s=wall)), flush=True)
    cs.TP_OPT = dict(cs.TP_OPT, learning_rate=cs.TP_LR)


@contextlib.contextmanager
def c9_swapped(variant: str):
    """`variant` of C9_VARIANTS in this process, with the launch counts
    that `chip_smoke.tp_update` then expects."""
    from types import SimpleNamespace
    from tpu1x_torch.models.st_transformer import STBlock
    from tpu1x_torch.ops import attention as attn
    from tpu1x_torch.parallel import tensor as tpl
    saved = (tpl._ColumnParallel.backward, tpl._RowParallel.forward,
             tpl._RowParallel.backward, STBlock.ops, cs.tp_per_layer)
    if variant == "column":
        def column_bwd(ctx, dy):
            x, wc = ctx.saved_tensors
            dy = dy.contiguous()
            part = torch.matmul(dy.float(), wc.float())
            dx = tpl.model_all_reduce(part, ctx.mesh).to(x.dtype)
            dw = tpl._counted("tp_column_parallel_bwd", x,
                              torch.matmul(dy.t(), x))
            return dx, dw.to(ctx.wdtype), None
        tpl._ColumnParallel.backward = staticmethod(column_bwd)
    elif variant == "row":
        def row_fwd(ctx, h, w, m):
            wc = tpl._cast(w, h.dtype)
            ctx.save_for_backward(h, wc)
            ctx.wdtype = w.dtype
            part = tpl._counted("tp_row_parallel", h, torch.matmul(
                h.float(), wc.float().t()))
            return tpl.model_all_reduce(part, m).to(h.dtype)

        def row_bwd(ctx, g):
            h, wc = ctx.saved_tensors
            g = g.contiguous()
            dw = tpl._counted("tp_row_parallel_bwd", h,
                              torch.matmul(g.t(), h))
            return torch.matmul(g, wc), dw.to(ctx.wdtype), None
        tpl._RowParallel.forward = staticmethod(row_fwd)
        tpl._RowParallel.backward = staticmethod(row_bwd)
    elif variant == "plain_attn":
        STBlock.ops = SimpleNamespace(**{**vars(STBlock.ops),
                                         "mha": attn.mha_reference})
        counts = saved[4]
        cs.tp_per_layer = lambda arch, split: {
            k: v for k, v in counts(arch, split).items()
            if not k.startswith("flash_mha")}
    try:
        yield
    finally:
        (tpl._ColumnParallel.backward, tpl._RowParallel.forward,
         tpl._RowParallel.backward, STBlock.ops, cs.tp_per_layer) = saved


def tp_c9(dev):
    """ROADMAP C9: which candidate puts the qk_norm TP update farther from
    fp32 than one process's. For each of `chip_smoke.TP_SETUPS` (GENIE_138M
    at tp = 2: 8 heads a rank; GENIE_35M at tp = 4: 2 heads a rank), the
    qk_norm model's one update over the ranks on this card (as
    `chip_smoke.py`'s TP phase) under each of C9_VARIANTS, one swapped at a
    time, held by `chip_smoke.tp_update_gates` to this process's updates
    (one process on the kernels, with the same swap where it touches one
    process; the plain path in bf16 and fp32). Prints per setup and
    variant each kind's farthest distance from fp32 of the TP update and
    of one process's, and every spatial qkv weight's."""
    arch = "qk_norm"
    for setup, make, tp in cs.TP_SETUPS:
        inputs = dict(cs.tp_inputs(dev, make, tp), archs=(arch,))
        base = {}
        for name, oracle in (("one", None), ("bf16", "bf16"),
                             ("fp32", "fp32")):
            metrics, _, whole, state = cs.tp_update(arch, inputs[arch], dev,
                                                    oracle=oracle)
            base[name] = dict(metrics=metrics, params=whole)
            del state
        for variant in C9_VARIANTS:
            refs = dict(base)
            if variant == "plain_attn":
                with c9_swapped(variant):
                    metrics, _, whole, state = cs.tp_update(
                        arch, inputs[arch], dev)
                refs["one"] = dict(metrics=metrics, params=whole)
                del state
            ranks, wall = cs.tp_children(
                inputs, tp, lambda r, port, tmp: [
                    str(Path(__file__).resolve()), "tp_fault_rank", str(r),
                    str(port), tmp, str(dev), variant])
            res, failed = cs.tp_update_gates(inputs[arch]["init"],
                                             ranks[0][arch], refs)
            kinds = {}
            for k, d in res["per_parameter"].items():
                kind = re.sub(r"\.\d+\.", ".#.", k)
                tp_d, one_d = kinds.get(kind, (0.0, 0.0))
                kinds[kind] = (max(tp_d, d["tp_fp32"]),
                               max(one_d, d["one_fp32"]))
            print(json.dumps(dict(
                kernel="tp_c9", setup=setup, tp=tp, variant=variant,
                what=C9_VARIANTS[variant], fails=[f[:300] for f in failed],
                update_rel_l2=res["update_rel_l2"],
                kinds_tp_one_fp32=kinds,
                spatial_qkv={k: (d["tp_fp32"], d["one_fp32"],
                                 d["bf16_fp32"])
                             for k, d in res["per_parameter"].items()
                             if "spatial_attn.qkv.weight" in k},
                wall_s=wall)), flush=True)


# the checks of `h64_debug`, each run in a process of its own: (d_model,
# head count, what it checks)
H64_DEBUG = {
    "spatial": lambda inp, C, H: {
        f"qk_ln={qk},N={n}": cs.check_spatial_block(inp, C, H, n, qk)
        for qk in (False, True) for n in (cs.B, cs.B * cs.P)},
    "temporal": lambda inp, C, H: cs.check_temporal_attention(inp, C, H),
    "temporal_bwd": lambda inp, C, H: cs.check_temporal_attention_bwd(
        inp, C, H),
    "flash": lambda inp, C, H: cs.check_flash_mha(inp, H, D=C // H),
    "decode": lambda inp, C, H: decode_checks(inp, H, C=C),
    "decode_batches": lambda inp, C, H: cs.check_decode_batches(C, H,
                                                                inp.device),
    "train_blocks": lambda inp, C, H: dict(
        cs.check_spatial_train_block(inp, C, H),
        **cs.check_temporal_train_block(inp, C, H)),
    "flash_sweep": lambda inp, C, H: flash_sweep(inp, H, C=C),
    "temporal_t": lambda inp, C, H: {
        f"T={T},causal={causal}": cs.temporal_case(
            inp, C, H, f"[T={T}]", cs.TB, T, causal, timed=False)
        for T in (8, 32) for causal in (True, False)},
    "temporal_bwd_t": lambda inp, C, H: {
        T: cs.check_temporal_attention_bwd(inp, C, H, T=T, timed=False)
        for T in (8, 32)},
}
# the checks of `h128_debug` at head_dim 32 and 64 beside head_dim 128's
H128_DEBUG_NARROW = ("spatial", "temporal", "temporal_bwd", "flash",
                     "flash_sweep", "temporal_bwd_t")
# `h64_debug`'s configurations: (d_model, head count, checks) runs. "h72":
# head_dim 72 at GENIE_138M-h72's width (16 heads) and at a tp = 2 rank's
# (8 heads of 72, C = 576: head groups of 4 and 8 heads a tile's problems)
HEAD_DEBUG = {
    "h64": ((512, 8, tuple(H64_DEBUG)), (512, 16, tuple(H64_DEBUG))),
    "h128": ((512, 4, tuple(H64_DEBUG)), (512, 8, H128_DEBUG_NARROW),
             (512, 16, H128_DEBUG_NARROW)),
    "h72": ((1152, 16, tuple(H64_DEBUG)), (576, 8, H128_DEBUG_NARROW)),
}


def flash_sweep(inp, H, sizes=(64, 192, 320, 1024), C=512):
    """K9 and K10 (`chip_smoke.flash_case`) at each N of `sizes` (2 rows),
    causal, not, and at a negative scale, at C and H heads."""
    D, out = C // H, {}
    for n in sizes:
        qkv, dout = inp.normal(2, n, 3, H, D), inp.normal(2, n, H, D)
        for causal, sc in ((False, D ** -0.5), (True, D ** -0.5),
                           (False, -D ** -0.5)):
            key = f"N={n},causal={causal},scale={sc:.4f}"
            out[key] = cs.flash_case(key, qkv, dout, sc, causal)
    return out


# the checks of `w32_debug` at T = 32 (and the K4 / K6 sweep's 20 and 24),
# each run in a process of its own, then the T = 16 forms beside them
W32_DEBUG = {
    "temporal": lambda inp: {
        **{tag: cs.temporal_case(inp, C, H, tag, 2, T, causal, timed=False)
           for T in cs.W32_SWEEP_T for C, H in cs.W32_SWEEP_CH
           for causal in (True, False)
           for tag in [f"[T={T},C={C},H={H},causal={causal}]"]},
        **{tag: cs.temporal_case(inp, 512, 16, tag, Bt, 32, causal)
           for tag, Bt, causal in (("[train]", cs.TB, True),
                                   ("[train,non-causal]", cs.TB, False),
                                   ("[eval prefill]", cs.B, True))}},
    "temporal_bwd": lambda inp: {
        **{f"{k}[H={H}]": r for T in cs.W32_SWEEP_T
           for C, H in cs.W32_SWEEP_CH
           for k, r in cs.check_temporal_attention_bwd(
               inp, C, H, T=T, Bt=2, timed=False).items()},
        **cs.check_temporal_attention_bwd(inp, 512, 16, T=32)},
    "decode": lambda inp: decode_checks(inp, 16, T=32),
    "decode_batches": lambda inp: cs.check_decode_batches(512, 16,
                                                          inp.device, T=32),
    "train_blocks": lambda inp: dict(
        cs.check_temporal_train_block(inp, 512, 16, T=32),
        **{f"{k}[H=8]": r for k, r in cs.check_temporal_train_block(
            inp, 512, 8, timed=False, T=32).items()}),
    "t16": lambda inp: dict(
        cs.check_temporal_attention(inp, 512, 16),
        **cs.check_temporal_attention_bwd(inp, 512, 16),
        **cs.check_temporal_attention(inp, 512, 8),
        **cs.check_temporal_attention_bwd(inp, 128, 4),
        **cs.check_temporal_train_block(inp, 512, 16),
        **decode_checks(inp, 16)),
}


def w32_one(name: str) -> int:
    """One check of W32_DEBUG, in this process, inside GENIE_138M-T32's
    window (`chip_smoke.window_of`: P = 16), the T = 16 forms' outside."""
    dev = torch.device("cuda")
    with (contextlib.nullcontext() if name == "t16"
          else cs.window_of(cs.genie_138m_t32())):
        out = W32_DEBUG[name](cs.Inputs(9, dev))
    torch.cuda.synchronize()
    print(json.dumps({"check": name, "result": out}, default=str),
          flush=True)
    return 0


def w32_debug(dev):
    """The first call after a change of the frame-axis kernels: every
    kernel library rebuilt with ptxas's counts (the temporal, decode and
    temporal+MLP sources' lines printed), then each check of W32_DEBUG in a
    process of its own with a time limit, so that a fault or a hang in one
    leaves the others' results."""
    import subprocess
    logs = kernels.build_all(verbose=True)
    for name, log in logs.items():
        if name not in ("temporal_attention", "decode_attention",
                        "temporal_mlp_block"):
            continue
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    for name in W32_DEBUG:
        try:
            res = subprocess.run([sys.executable, __file__, "w32_one", name],
                                 capture_output=True, text=True, timeout=300)
            text, rc = (res.stdout + res.stderr)[-40000:], res.returncode
        except subprocess.TimeoutExpired:
            text, rc = "timed out", "timeout"
        print(f"== {name} rc={rc}\n{text}", flush=True)


# the checks of `s1024_debug`, each run in a process of its own: (inside
# GENIE_138M-S1024's grid, what it checks)
S1024_DEBUG = {
    "sweep_small": (False, lambda inp: cs.check_grid_sweep(inp, (320, 576))),
    "sweep": (False, lambda inp: cs.check_grid_sweep(inp, (64, 192, 1024,
                                                          4096))),
    "flash": (True, lambda inp: dict(cs.check_flash_mha(inp, 16),
                                     **{f"{k}[h64]": r for k, r in
                                        cs.check_flash_mha(
                                            inp, 8, D=64).items()})),
    "spatial": (True, lambda inp: dict(
        {f"qk_ln={qk},N={n}": cs.check_spatial_block(inp, 512, 16, n, qk)
         for qk in (False, True) for n in (cs.B, cs.B * cs.P)},
        **cs.check_spatial_train_block(inp, 512, 16))),
    "train_blocks": (True, lambda inp: dict(
        cs.check_temporal_train_block(inp, 512, 16),
        **cs.check_mlp_train_block(inp, 512, timed=False),
        **cs.check_temporal_attention_bwd(inp, 512, 16))),
    "decode": (True, lambda inp: decode_checks(inp, 16, L=32)),
    "flash_256": (False, lambda inp: dict(cs.check_flash_mha(inp, 16),
                                          **{f"{k}[h64]": r for k, r in
                                             cs.check_flash_mha(
                                                 inp, 8, D=64).items()})),
    "c11_256": (False, lambda inp: dict(
        cs.check_spatial_train_block(inp, 512, 16, timed=False),
        **cs.check_temporal_train_block(inp, 512, 16, timed=False),
        **cs.check_mlp_train_block(inp, 512, timed=False))),
}


def s1024_one(name: str) -> int:
    """One check of S1024_DEBUG, in this process."""
    dev = torch.device("cuda")
    grid, fn = S1024_DEBUG[name]
    with (cs.grid_of(cs.genie_138m_s1024()) if grid
          else contextlib.nullcontext()):
        out = fn(cs.Inputs(9, dev))
    torch.cuda.synchronize()
    print(json.dumps({"check": name, "result": out}, default=str),
          flush=True)
    return 0


def s1024_debug(dev, names=None):
    """The first call after a change of the spatial kernels: the flash and
    spatial libraries rebuilt with ptxas's counts, then each check of
    S1024_DEBUG (or of `names`) in a process of its own with a time limit,
    so that a fault or a hang in one leaves the others' results."""
    import subprocess
    logs = kernels.build_all(verbose=True)
    for name, log in logs.items():
        if name not in ("flash_attention", "spatial_block"):
            continue
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    for name in names or S1024_DEBUG:
        t0 = time.perf_counter()
        try:
            res = subprocess.run([sys.executable, __file__, "s1024_one",
                                  name], capture_output=True, text=True,
                                 timeout=300)
            text, rc = (res.stdout + res.stderr)[-6000:], res.returncode
        except subprocess.TimeoutExpired:
            text, rc = "timed out", "timeout"
        print(f"== {name} rc={rc} {time.perf_counter() - t0:.1f} s\n{text}",
              flush=True)


def s1024_times(dev):
    """Device ms (profiler) and event ms of the spatial kernels at
    GENIE_138M-S1024's shapes through this checkout's wrappers, in a fresh
    process: K9 and K10 at (128, 1024, H, D), causal and not, 16 heads of
    32 and 8 of 64, with SDPA's forward and backward beside them; K1 in
    both modes at N = 16 / 32 / 128 frames; K11 at 128 frames. One JSON
    line."""
    from tpu1x_torch.ops import attention as attn
    from tpu1x_torch.ops import spatial_train_block as stb
    F_ = torch.nn.functional
    C, S = 512, cs.S1024_S
    inp = cs.Inputs(0, dev)
    out = {}

    def both(key, fn):
        out[key] = {"device_ms": cs.device_ms(fn), "ms": cs.time_ms(fn)}
    for H in (16, 8):
        D = C // H
        R = cs.TB * 16
        qkv = inp.normal(R, S, 3, H, D)
        q, k, v = qkv.unbind(2)
        dout = inp.normal(R, S, H, D)
        for causal in (False, True):
            tag = ("" if D == 32 else "[h64]") + ("[causal]" if causal
                                                  else "")
            kw = dict(scale=D ** -0.5, causal=causal)
            o, lse = attn.flash_mha_fwd(q, k, v, **kw)
            both("K9" + tag, lambda: attn.flash_mha_fwd(q, k, v, **kw))
            both("K10" + tag,
                 lambda: attn.flash_mha_bwd(q, k, v, o, lse, dout, **kw))
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            lout = F_.scaled_dot_product_attention(lq, lk, lv,
                                                   is_causal=causal,
                                                   scale=D ** -0.5)
            both("SDPA" + tag, lambda: F_.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, scale=D ** -0.5))
            both("SDPA_bwd" + tag, lambda: torch.autograd.grad(
                lout, (lq, lk, lv), dout.transpose(1, 2),
                retain_graph=True))
            del lq, lk, lv, lout
        del qkv, q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    H = 16
    for qk in (False, True):
        w = cs.spatial_weights(inp, C)
        if qk:
            w.update(ln_scale=None, ln_bias=None,
                     qk_ln_scale=inp.normal(C // H, std=0.1, mean=1.0,
                                            dtype=torch.float32),
                     qk_ln_bias=inp.normal(C // H, std=0.1,
                                           dtype=torch.float32))
        for n in (cs.B, 2 * cs.B, cs.B * cs.P):
            x = inp.normal(n, S, C)
            both(f"K1{'[qk_ln]' if qk else ''}[N={n}]",
                 lambda: sb.spatial_block(x, num_heads=H,
                                          scale=(C // H) ** -0.5, **w))
    x, dout = inp.normal(cs.TB * 16, S, C), inp.normal(cs.TB * 16, S, C)
    w = cs.spatial_weights(inp, C)
    both("K11", lambda: stb.spatial_train_block_bwd(
        x, dout, w["wqkv"], w["wproj"], None, w["ln_scale"], w["ln_bias"],
        proj_bias=True, num_heads=H, scale=(C // H) ** -0.5))
    print(json.dumps({"s1024_ms": out}), flush=True)


def s1024(dev):
    """chip_smoke.py's S = 1024 phase alone."""
    out = cs.check_grid_1024(dev)
    print("s1024 phase walls: " + json.dumps(out["phase_walls_s"]),
          flush=True)


def k12gate(dev, seeds: int = 6):
    """K12's forward gate (atol = rtol = 3e-2 against
    `temporal_train_block_plain`; ROADMAP C11): first on the draw that
    follows `chip_smoke.check_w32_kernels`'s K12 check at head_dim 64 (the
    checks before it replayed, so that the generator reaches that state;
    8 heads there failed the gate on one element), then over `seeds`
    fresh draws at (TB, T, 256, 512) for T = 16 and 32 and 16 and 8 heads:
    per case the elements past the gate and the largest error; for the
    first element past it its place, x, the kernel's and the plain path's
    output, and the error split by stage at that element: the qkv product
    (gemm90 against the plain dense), the attention on the same q, k, v
    (K4 against the plain attention), and the proj product with the
    residual on the same attention output."""
    real = cs.check_temporal_train_block

    def replayed(inp, C, H, timed=True, T=16):
        out = real(inp, C, H, timed=timed, T=T)
        if T == 32:
            k12_case(inp, C, 8, T, "replay")
        return out
    cs.check_temporal_train_block = replayed
    try:
        with cs.window_of(cs.genie_138m_t32()):
            cs.check_w32_kernels(dev)
    finally:
        cs.check_temporal_train_block = real
    for T in (16, 32):
        for H in (16, 8):
            for seed in range(seeds):
                k12_case(cs.Inputs(100 + seed, dev), 512, H, T, seed)


def k12_case(inp, C, H, T, seed):
    """One draw of `k12gate`, in `chip_smoke.check_temporal_train_block`'s
    order."""
    from tpu1x_torch.ops import temporal_attention as ta
    from tpu1x_torch.ops import temporal_train_block as ttb
    from tpu1x_torch.ops._util import dense
    S = 256
    x = inp.normal(cs.TB, T, S, C)
    wqkv = inp.normal(C, 3 * C, std=0.05, dtype=torch.float32)
    wproj = inp.normal(C, C, std=0.05, dtype=torch.float32)
    bproj = inp.normal(C, std=0.1, dtype=torch.float32)
    kw = dict(num_heads=H, scale=(C // H) ** -0.5)
    w16 = [tk.as_bf16(w) for w in (wqkv, wproj, bproj)]
    got = ttb.temporal_train_block_fwd(x, w16[0], w16[1], None,
                                       w16[2], **kw)
    want = ttb.temporal_train_block_plain(x, wqkv, wproj,
                                          bproj=bproj, **kw)
    err = (got.float() - want.float()).abs()
    past = err > 3e-2 + 3e-2 * want.float().abs()
    row = dict(T=T, heads=H, seed=seed, past=int(past.sum()),
               max_abs_err=float(err.max()))
    if past.any():
        i = int(torch.nonzero(past.flatten())[0])
        at = [int(v) for v in torch.unravel_index(
            torch.tensor(i), got.shape)]
        b, t, s, c = at
        qk = ttb._qkv(x, w16[0], None)  # gemm90
        qp = dense(x, wqkv, None).split(C, dim=-1)  # plain
        ak = ta.launch_forward(*qk, scale=kw["scale"],
                               num_heads=H, causal=True)
        ap = ta.temporal_attention_plain(
            *qk, scale=kw["scale"], num_heads=H, causal=True)
        yk = tk.gemm90(ap.reshape(-1, C), w16[1], bias=w16[2],
                       resid=x.reshape(-1, C)).view(x.shape)
        yp = x + dense(ap, wproj, bproj)
        head = slice(c // (C // H) * (C // H),
                     (c // (C // H) + 1) * (C // H))
        row.update(
            at=at, x=float(x[b, t, s, c]),
            got=float(got[b, t, s, c]),
            want=float(want[b, t, s, c]),
            qkv_max_diff=max(float((a.float() - p.float()).abs()
                                   .max()) for a, p in zip(
                                       qk, qp)),
            attn_row_max_diff=float(
                (ak[b, t, s].float() - ap[b, t, s].float())
                .abs().max()),
            attn_max_diff=float((ak.float() - ap.float()).abs()
                                .max()),
            proj_diff_at=float(yk[b, t, s, c] - yp[b, t, s, c]),
            plain_on_kernel_qkv_at=float(yp[b, t, s, c]),
            attn_head_rows=[float((ak[b, t, s, head].float()
                                   - ap[b, t, s, head].float())
                                  .abs().max())])
    print(json.dumps(row), flush=True)


def decode_checks(inp, H, L=4, T=16, C=512):
    """K2, K3, K7 and K8 (both caches) at C and H heads on an L-layer cache
    of T slots, by `chip_smoke.py`'s gates (K2's and K3's t_B from
    chip_smoke's P)."""
    caches = (inp.normal(T, L, cs.B, cs.GRID, C),
              inp.normal(T, L, cs.B, cs.GRID, C))
    out = {}
    for name, pair in (("temporal_mlp_block", False),
                       ("temporal_mlp_block_pair", True)):
        out[name] = cs.check_temporal_mlp_block(inp, C, H, L, caches, pair,
                                                first=cs.P)
        out.update(cs.check_decode_attention(inp, C, H, L, caches, None,
                                             pair))
    (kq, ks), (vq, vs) = cs.quantize_cache(caches[0]), cs.quantize_cache(
        caches[1])
    for pair in (False, True):
        out.update(cs.check_decode_attention(inp, C, H, L, (kq, vq), (ks, vs),
                                             pair))
    return out


def h64_one(name: str, heads: int, C: int = 512) -> int:
    """One check of H64_DEBUG at d_model C in `heads` heads, in this
    process."""
    dev = torch.device("cuda")
    out = H64_DEBUG[name](cs.Inputs(7, dev), C, heads)
    torch.cuda.synchronize()
    print(json.dumps({"check": name, "C": C, "heads": heads, "result": out},
                     default=str), flush=True)
    return 0


def h64_debug(dev, config: str = "h64"):
    """Every kernel library rebuilt with ptxas's counts (the flash,
    temporal, decode and spatial sources' lines printed), then each check
    of H64_DEBUG in each run of HEAD_DEBUG[config] ((d_model, head count,
    check names): by default head_dim 64 (8 heads) and 32 (16 heads) at C =
    512), one process each with a time limit, so that a fault or a hang in
    one leaves the others' results; a check's whole output goes to
    chiprun_out/head_debug_NAME_C_H.log."""
    import subprocess
    logs = kernels.build_all(verbose=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    for C, heads, names in HEAD_DEBUG[config]:
        for name in names:
            try:
                res = subprocess.run(
                    [sys.executable, __file__, "h64_one", name, str(heads),
                     str(C)], capture_output=True, text=True, timeout=240)
                text, rc = res.stdout + res.stderr, res.returncode
            except subprocess.TimeoutExpired:
                text, rc = "timed out", "timeout"
            (out / f"head_debug_{name}_{C}_{heads}.log").write_text(text)
            print(f"== {name} C={C} heads={heads} rc={rc}\n{text[-3000:]}",
                  flush=True)


# the checks of `widths_debug`, each run in a process of its own: the
# decode ring and the LN rows across widths, then each configuration's
# kernel forms (timed, with their bounds) and decode batch sizes
WIDTHS_DEBUG = {
    "sweep": lambda dev: cs.check_width_sweep(dev),
    "c384": lambda dev: cs.check_width_kernels(384, 6, "c384", dev),
    "c1600": lambda dev: cs.check_width_kernels(1600, 25, "c1600", dev),
    "c384_batches": lambda dev: cs.check_decode_batches(384, 6, dev),
    "c1600_batches": lambda dev: cs.check_decode_batches(1600, 25, dev),
}


def widths_one(name: str) -> int:
    """One check of WIDTHS_DEBUG, in this process."""
    dev = torch.device("cuda")
    out = WIDTHS_DEBUG[name](dev)
    torch.cuda.synchronize()
    print(json.dumps({"check": name, "result": out}, default=str),
          flush=True)
    return 0


def widths_debug(dev):
    """The first call after a change of the decode ring or the LN rows:
    every kernel library rebuilt with ptxas's counts (the decode, temporal
    +MLP block, train block and layer-norm sources' lines printed), then
    each check of WIDTHS_DEBUG in a process of its own with a time limit,
    so that a fault or a hang in one leaves the others' results; each
    check's whole output goes to chiprun_out/widths_NAME.log."""
    import subprocess
    logs = kernels.build_all(verbose=True)
    for name, log in logs.items():
        if name not in ("decode_attention", "temporal_mlp_block",
                        "train_block", "layer_norm"):
            continue
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    for name in WIDTHS_DEBUG:
        try:
            res = subprocess.run([sys.executable, __file__, "widths_one",
                                  name], capture_output=True, text=True,
                                 timeout=300)
            text, rc = res.stdout + res.stderr, res.returncode
        except subprocess.TimeoutExpired:
            text, rc = "timed out", "timeout"
        (out / f"widths_{name}.log").write_text(text)
        print(f"== {name} rc={rc}\n{text[-3000:]}", flush=True)


def width_loss(dev):
    """The first loss of `chip_smoke.check_training`'s model (seed 0, the
    JAX package's initialisation, normal std 0.02 at every width) on one
    corrupted batch of CB rows, forward only, through the kernel path, the
    plain train blocks in bf16 and an fp32 plain run, with the logits'
    spread, for GENIE_138M (C = 512) and GENIE_138M-C384 and -C1600 at 8,
    16 and 32 layers; then the same with every 2-D weight drawn at std
    0.02 sqrt(512 / C) (`fan_in`). Whether a first loss far from the
    uniform guess is the initialisation's or a kernel's."""
    from tpu1x_torch.data.corruption import draw_noise, maskgit_corrupt
    from tpu1x_torch.models.st_maskgit import STMaskGIT
    for make in (cs.genie_138m, cs.genie_138m_c384, cs.genie_138m_c1600):
        for layers in (8, 16, 32):
            for fan_in in (False, True):
                cfg = make(num_layers=layers)
                g = torch.Generator(device=dev).manual_seed(0)
                model = STMaskGIT(cfg, device=dev).init_weights(g)
                if fan_in:
                    with torch.no_grad():
                        for n, p in model.named_parameters():
                            if n.endswith("weight") and p.dim() == 2:
                                p.mul_(min(1.0, (512 / cfg.d_model) ** 0.5))
                side = cfg.latent_side_len
                tokens = torch.randint(0, cfg.image_vocab_size,
                                       (cs.CB, cfg.T, side, side),
                                       generator=g, device=dev)
                batch = maskgit_corrupt(
                    tokens, draw_noise(tokens.shape, cfg, g, dev), cfg)
                ref = STMaskGIT(dataclasses.replace(cfg, dtype="float32",
                                                    remat=False), device=dev)
                ref.load_state_dict(model.state_dict())
                res = {}
                with torch.no_grad():
                    for name, m, plain in (("kernel", model, False),
                                           ("plain", model, True),
                                           ("fp32", ref, True)):
                        with (cs.plain_blocks() if plain
                              else contextlib.nullcontext()):
                            out = m(batch["input_ids"], batch["labels"])
                            logits = m.compute_logits(
                                batch["input_ids"].reshape(tokens.shape))
                        res[name] = dict(loss=float(out["loss"]),
                                         logit_std=float(logits.std()))
                print(json.dumps(dict(d_model=cfg.d_model, layers=layers,
                                      fan_in=fan_in, **res)), flush=True)
                del model, ref
                torch.cuda.empty_cache()


def width_times(dev):
    """`ab_times widths`: device ms (profiler) of the forms that the model
    widths' kernels share with GENIE_138M's, through this checkout's
    wrappers: K2, K3, K7 and K8 (bf16 and int8 cache, chip_smoke.py's
    t_B) at C = 256 (8 heads) and 512 (16 heads), the cache (16, 32, 16,
    256, C); K11's backward and K13's forward and backward (erf, with LN)
    at the pre-LN train step's (128, 256, 512); the LN row passes alone at
    its 32768 rows of 512. Only names that a tree from before the widths
    has, so that a parent's copy runs it too."""
    from tpu1x_torch.ops import decode_attention as da
    from tpu1x_torch.ops import mlp_train_block as mtb
    from tpu1x_torch.ops import spatial_train_block as stb
    from tpu1x_torch.ops._train_kernels import ln_bwd, ln_fwd
    from tpu1x_torch.ops.temporal_mlp_block import (temporal_mlp_block,
                                                    temporal_mlp_block_pair)
    inp = cs.Inputs(0, dev)
    times = {}
    L, T = 32, 16
    for C, H in ((256, 8), (512, 16)):
        caches = (inp.normal(T, L, cs.B, 256, C),
                  inp.normal(T, L, cs.B, 256, C))
        wb = cs.block_weights(inp, C)
        for pair, fn in ((False, temporal_mlp_block),
                         (True, temporal_mlp_block_pair)):
            frames = 2 if pair else 1
            x = (inp.normal(cs.B, 2, 256, C) if pair
                 else inp.normal(cs.B, 256, C))
            t_B = (cs.P + torch.arange(cs.B, device=dev)
                   % (T - cs.P - frames + 1)).to(torch.int32)
            times[f"K{3 if pair else 2}[C={C}]"] = cs.device_ms(
                lambda: fn(x, *caches, t_B, layer=L // 2,
                           scale=(C // H) ** -0.5, num_heads=H,
                           gelu_tanh=True, **wb))
        (kq, ks), (vq, vs) = (cs.quantize_cache(caches[0]),
                              cs.quantize_cache(caches[1]))
        for cache, kv, skw in (("bf16", caches, {}),
                               ("int8", (kq, vq),
                                dict(k_scale=ks, v_scale=vs))):
            for frames in (1, 2):
                q, k, v = inp.normal(frames * cs.B, 256, 3 * C).split(
                    C, dim=-1)
                t_B = (torch.arange(cs.B, device=dev) * 7
                       % (T - frames + 1)).to(torch.int32)
                kw = dict(layer=L // 2, scale=(C // H) ** -0.5, num_heads=H,
                          **skw)
                run = (functools.partial(da.temporal_decode_attention, q,
                                         *kv, k, v, t_B, **kw)
                       if frames == 1 else functools.partial(
                           da.temporal_decode2_attention, q[:cs.B],
                           q[cs.B:], *kv, k[:cs.B], v[:cs.B], k[cs.B:],
                           v[cs.B:], t_B, **kw))
                times[f"K{7 if frames == 1 else 8}[{cache},C={C}]"] = (
                    cs.device_ms(run))
        del caches, kq, vq
        torch.cuda.empty_cache()
    C, H = 512, 16
    x = inp.normal(cs.TB * 16, 256, C)
    dout = inp.normal(cs.TB * 16, 256, C)
    w = cs.spatial_weights(inp, C)
    times["K11"] = cs.device_ms(lambda: stb.spatial_train_block_bwd(
        x, dout, w["wqkv"], w["wproj"], None, w["ln_scale"], w["ln_bias"],
        proj_bias=True, num_heads=H, scale=(C // H) ** -0.5))
    wb = cs.block_weights(inp, C)
    w16 = [wb[k] for k in ("wfc1", "wfc2", "bfc1", "bfc2")]
    ln = (wb["ln_scale"], wb["ln_bias"])
    times["K13"] = cs.device_ms(lambda: mtb.mlp_train_block_fwd(
        x, *w16, *ln, gelu_approx=False))
    times["K13[bwd]"] = cs.device_ms(lambda: mtb.mlp_train_block_bwd(
        x, dout, *w16[:3], *ln, gelu_approx=False, bias=True))
    rows = x.reshape(-1, C)
    xn, stats = ln_fwd(rows, *ln)
    d_xn = inp.normal(*rows.shape, dtype=torch.float32)
    times["ln_fwd"] = cs.device_ms(lambda: ln_fwd(rows, *ln))
    times["ln_bwd"] = cs.device_ms(lambda: ln_bwd(rows, stats, ln[0], d_xn,
                                                  dout.reshape(-1, C)))
    print(json.dumps({"ab_device_ms": times}), flush=True)


def ln_row_times(dev, widths=(384, 1600, 2048), rows=32768):
    """`ab_times ln_rows`: device ms (profiler) and byte bound of the
    training LN row passes alone (`_train_kernels.ln_fwd`, `ln_bwd`) at
    the train step's 32768 rows of GENIE_138M-C384's, -C1600's and the
    widest C, forms that a tree from before the widths refuses past 1024
    (so no A/B). One JSON line."""
    inp = cs.Inputs(1, dev)
    out = {}
    for C in widths:
        x = inp.normal(rows, C, mean=0.3)
        g = inp.normal(C, std=0.1, mean=1.0, dtype=torch.float32)
        b = inp.normal(C, std=0.1, dtype=torch.float32)
        d_xn = inp.normal(rows, C, dtype=torch.float32)
        dout = inp.normal(rows, C)
        xn, stats = tk.ln_fwd(x, g, b)
        # forward: x read, xn and the stats written; backward: x, the
        # stats, d_xn and dout read, dx written, the C-wide sums
        fwd = cs.bound(cs.nbytes(x, xn, stats, g, b))
        bwd = cs.bound(cs.nbytes(x, stats, d_xn, dout, x, g) + 8 * C)
        out[f"ln_fwd[C={C}]"] = dict(
            device_ms=cs.device_ms(lambda: tk.ln_fwd(x, g, b)),
            bound_ms=fwd[0], bound_by=fwd[1])
        out[f"ln_bwd[C={C}]"] = dict(
            device_ms=cs.device_ms(lambda: tk.ln_bwd(x, stats, g, d_xn,
                                                     dout)),
            bound_ms=bwd[0], bound_by=bwd[1])
    print(json.dumps({"ln_rows": out}), flush=True)


# `ab_times CONFIG`: each configuration's keyword arguments of `ab_times`.
# "h32", "h64", "h128": every attention form at 16, 8 or 4 heads of C =
# 512 with K11, K12 and SDPA beside them; "groups": the head_dim-32 forms
# with K4 and K6 at their head groups of 4 and 2 too, the serving GEMM
# chain alone and K13 (what the head groups of 1 and the GEMM's
# overhanging tiles must leave as fast as they were); "one_head": the
# forms one head a rank takes (`one_head_times`), which a tree from before
# them refuses; "widths": the decode ring's, K2's, K3's and the LN rows'
# forms at GENIE_138M's widths (`width_times`); "ln_rows": the LN rows at
# the model widths' C, with their bounds (`ln_row_times`, no A/B)
AB_CONFIGS = {"h32": dict(heads=16, extra=True),
              "h64": dict(heads=8, extra=True),
              "h128": dict(heads=4, extra=True),
              "h72": dict(C=1152, heads=16, extra=True),
              "groups": dict(heads=16, extra=True, groups=True),
              "one_head": dict(one_head=True),
              "widths": dict(widths=True),
              "ln_rows": dict(ln_rows=True)}


def ab_times(dev, heads: int = 16, extra: bool = False, T: int = 16,
             groups: bool = False, one_head: bool = False,
             widths: bool = False, ln_rows: bool = False, C: int = 512):
    """Device ms (profiler) of every attention kernel form through this
    checkout's wrappers at GENIE_138M's main-path shapes (C = 512, `heads`
    heads: 16 of 32 channels, or 8 of 64 for `ab_times h64`; at C = 1152 in
    16 heads of 72, GENIE_138M-h72's, for `ab_times h72`): K1 both modes at
    N = 16 / 32 / 128, K2, K3, K4 (train, causal and not; prefill), K6
    (causal, with o, non-causal), K7 and K8 (bf16 and int8, chip_smoke.py's
    t_B), K9 and K10 (causal and not); with `extra` also K11's backward,
    K12's forward and backward and one PyTorch call beside K4, K6, K7, K8
    (bf16), K9 and K10 (SDPA, `library_device_ms`). With T = 32
    (`w32_times`, inside `chip_smoke.window_of`) the frame-axis forms take
    a 32-frame window: caches of 32 slots, the train step's 32 frames and
    the evaluator prefill's for K4's "prefill". With `groups` also K4 and
    K6 (train, causal and not, with o) at C = 128 (4 heads: head groups of
    4) and C = 64 (2 heads: of 2), the serving GEMM (`gemm_sm90`) alone at
    K1's qkv and proj (N = 16 / 32 / 128 frames of 256 tokens) and K2's /
    K3's fc1 (tanh and erf GELU) and fc2 (4096 / 8192 rows), and K13's
    forward and backward (erf, with LN). `one_head` times only
    `one_head_times`, `widths` only `width_times`, `ln_rows` only
    `ln_row_times`. One JSON line; run in a
    parent's copy and here in turns for an A/B. No builds."""
    if one_head:
        return one_head_times(dev)
    if widths:
        return width_times(dev)
    if ln_rows:
        return ln_row_times(dev)
    from tpu1x_torch.ops import attention as attn
    from tpu1x_torch.ops import decode_attention as da
    from tpu1x_torch.ops import temporal_attention as ta
    H, L = heads, 32
    inp = cs.Inputs(0, dev)
    times, library = {}, {}
    for qk in (False, True):
        w = cs.spatial_weights(inp, C)
        if qk:
            w.update(ln_scale=None, ln_bias=None,
                     qk_ln_scale=inp.normal(C // H, std=0.1, mean=1.0,
                                            dtype=torch.float32),
                     qk_ln_bias=inp.normal(C // H, std=0.1,
                                           dtype=torch.float32))
        for n in (cs.B, 2 * cs.B, cs.B * cs.P):
            x = inp.normal(n, 256, C)
            times[f"K1{'[qk_ln]' if qk else ''}[N={n}]"] = cs.device_ms(
                lambda: sb.spatial_block(x, num_heads=H,
                                         scale=(C // H) ** -0.5, **w))
    caches = (inp.normal(T, L, cs.B, 256, C), inp.normal(T, L, cs.B, 256, C))
    wb = cs.block_weights(inp, C)
    from tpu1x_torch.ops.temporal_mlp_block import (temporal_mlp_block,
                                                    temporal_mlp_block_pair)
    for pair, fn in ((False, temporal_mlp_block),
                     (True, temporal_mlp_block_pair)):
        frames = 2 if pair else 1
        x = (inp.normal(cs.B, 2, 256, C) if pair
             else inp.normal(cs.B, 256, C))
        t_B = (cs.P + torch.arange(cs.B, device=dev)
               % (T - cs.P - frames + 1)).to(torch.int32)
        times["K3" if pair else "K2"] = cs.device_ms(
            lambda: fn(x, *caches, t_B, layer=L // 2, scale=(C // H) ** -0.5,
                       num_heads=H, gelu_tanh=True, **wb))
    (kq, ks), (vq, vs) = cs.quantize_cache(caches[0]), cs.quantize_cache(
        caches[1])
    for cache, kv, skw in (("bf16", caches, {}),
                           ("int8", (kq, vq), dict(k_scale=ks, v_scale=vs))):
        for frames in (1, 2):
            qkv = inp.normal(frames * cs.B, 256, 3 * C)
            q, k, v = qkv.split(C, dim=-1)
            t_B = (torch.arange(cs.B, device=dev) * 7
                   % (T - frames + 1)).to(torch.int32)
            kw = dict(layer=L // 2, scale=(C // H) ** -0.5, num_heads=H,
                      **skw)
            if frames == 1:
                run = functools.partial(da.temporal_decode_attention, q,
                                        *kv, k, v, t_B, **kw)
            else:
                run = functools.partial(
                    da.temporal_decode2_attention, q[:cs.B], q[cs.B:], *kv,
                    k[:cs.B], v[:cs.B], k[cs.B:], v[cs.B:], t_B, **kw)
            key = f"K{7 if frames == 1 else 8}[{cache}]"
            times[key] = cs.device_ms(run)
            if extra and cache == "bf16":
                args = ((q[:cs.B], q[cs.B:], *kv, k[:cs.B], v[:cs.B],
                         k[cs.B:], v[cs.B:], t_B) if frames == 2
                        else (q, *kv, k, v, t_B))
                library[key] = cs.device_ms(cs.decode_sdpa(
                    args, frames == 2, L // 2, C // H, (C // H) ** -0.5))
    del caches, kq, vq
    torch.cuda.empty_cache()
    for tag, Bt, Tt, causal in (("train", cs.TB, T, True),
                                ("train,non-causal", cs.TB, T, False),
                                ("prefill", cs.B, cs.P if T == 16 else T,
                                 True)):
        qkv = inp.normal(Bt, Tt, 256, 3 * C)
        q, k, v = qkv.split(C, dim=-1)
        dout = inp.normal(Bt, Tt, 256, C)
        kw = dict(scale=(C // H) ** -0.5, num_heads=H, causal=causal)
        times[f"K4[{tag}]"] = cs.device_ms(
            lambda: ta.launch_forward(q, k, v, **kw))
        if extra and tag == "train":
            def heads_of(x):  # (B, T, S, C) -> (B, S, H, T, D) view
                return x.reshape(Bt, Tt, 256, H, C // H).permute(0, 2, 3, 1,
                                                                4)
            lq, lk, lv = (heads_of(x).detach().requires_grad_(True)
                          for x in (q, k, v))
            lout = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True, scale=(C // H) ** -0.5)
            library["K4[train]"] = cs.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    lq, lk, lv, is_causal=True, scale=(C // H) ** -0.5))
            library["K6[train]"] = cs.device_ms(
                lambda: torch.autograd.grad(lout, (lq, lk, lv),
                                            heads_of(dout),
                                            retain_graph=True))
        if tag.startswith("train"):
            times[f"K6[{tag}]"] = cs.device_ms(
                lambda: ta.launch_backward(q, k, v, dout, **kw))
            if causal:
                o = torch.empty_like(dout)
                times["K6[train,o]"] = cs.device_ms(
                    lambda: ta.launch_backward(q, k, v, dout, o=o, **kw))
    R, D = cs.TB * 16, C // H
    qkv = inp.normal(R, 256, 3, H, D)
    q, k, v = qkv.unbind(2)
    dout = inp.normal(R, 256, H, D)
    for causal in (False, True):
        kw = dict(scale=D ** -0.5, causal=causal)
        o, lse = attn.flash_mha_fwd(q, k, v, **kw)
        tag = "[causal]" if causal else ""
        times["K9" + tag] = cs.device_ms(lambda: attn.flash_mha_fwd(q, k, v,
                                                                    **kw))
        times["K10" + tag] = cs.device_ms(
            lambda: attn.flash_mha_bwd(q, k, v, o, lse, dout, **kw))
        if extra:
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            lout = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, scale=D ** -0.5)
            library["K9" + tag] = cs.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    lq, lk, lv, is_causal=causal, scale=D ** -0.5))
            library["K10" + tag] = cs.device_ms(
                lambda: torch.autograd.grad(lout, (lq, lk, lv),
                                            dout.transpose(1, 2),
                                            retain_graph=True))
    if extra:
        from tpu1x_torch.ops import spatial_train_block as stb
        from tpu1x_torch.ops import temporal_train_block as ttb
        del qkv, q, k, v, dout
        torch.cuda.empty_cache()
        x = inp.normal(cs.TB * 16, 256, C)
        dout = inp.normal(cs.TB * 16, 256, C)
        w = cs.spatial_weights(inp, C)
        kw = dict(num_heads=H, scale=(C // H) ** -0.5)
        times["K11"] = cs.device_ms(lambda: stb.spatial_train_block_bwd(
            x, dout, w["wqkv"], w["wproj"], None, w["ln_scale"],
            w["ln_bias"], proj_bias=True, **kw))
        x = inp.normal(cs.TB, T, 256, C)
        dout = inp.normal(cs.TB, T, 256, C)
        wqkv, wproj = w["wqkv"], w["wproj"]
        times["K12"] = cs.device_ms(lambda: ttb.temporal_train_block_fwd(
            x, wqkv, wproj, None, w["bproj"], **kw))
        times["K12[bwd]"] = cs.device_ms(lambda: ttb.temporal_train_block_bwd(
            x, dout, wqkv, wproj, None, proj_bias=True, **kw))
        print(json.dumps({"library_device_ms": library}), flush=True)
    if groups:
        del x, dout
        torch.cuda.empty_cache()
        times.update(group_times(dev))
    print(json.dumps({"ab_device_ms": times}), flush=True)


def group_times(dev):
    """`ab_times`' `groups` part: device ms of K4 and K6 at their head
    groups of 4 and 2, the serving GEMM chain alone, and K13."""
    from tpu1x_torch.ops import mlp_train_block as mtb
    from tpu1x_torch.ops import temporal_attention as ta
    inp = cs.Inputs(1, dev)
    times = {}
    for C in (128, 64):
        kw = dict(scale=32 ** -0.5, num_heads=C // 32)
        q, k, v = inp.normal(cs.TB, 16, 256, 3 * C).split(C, dim=-1)
        dout = inp.normal(cs.TB, 16, 256, C)
        o = torch.empty_like(dout)
        for causal in (True, False):
            tag = f"[C={C}" + ("]" if causal else ",non-causal]")
            times["K4" + tag] = cs.device_ms(
                lambda: ta.launch_forward(q, k, v, causal=causal, **kw))
            times["K6" + tag] = cs.device_ms(
                lambda: ta.launch_backward(q, k, v, dout, causal=causal,
                                           **kw))
        times[f"K6[C={C},o]"] = cs.device_ms(
            lambda: ta.launch_backward(q, k, v, dout, causal=True, o=o, **kw))
    C, F4 = 512, 2048
    for n in (cs.B, 2 * cs.B, cs.B * cs.P):
        a, x = inp.normal(n * 256, C), inp.normal(n * 256, C)
        w, bias = inp.normal(C, 3 * C, std=0.05), inp.normal(3 * C, std=0.1)
        times[f"gemm_sm90 qkv[rows={n * 256}]"] = cs.device_ms(
            lambda: sb.gemm_sm90(a, w, bias))
        w, bias = inp.normal(C, C, std=0.05), inp.normal(C, std=0.1)
        times[f"gemm_sm90 proj[rows={n * 256}]"] = cs.device_ms(
            lambda: sb.gemm_sm90(a, w, bias, x))
    for M in (cs.B * 256, 2 * cs.B * 256):
        a, x, h = inp.normal(M, C), inp.normal(M, C), inp.normal(M, F4)
        w1, b1 = inp.normal(C, F4, std=0.05), inp.normal(F4, std=0.1)
        w2, b2 = inp.normal(F4, C, std=0.05), inp.normal(C, std=0.1)
        for act in ("tanh", "erf"):
            times[f"gemm_sm90 fc1[{act},rows={M}]"] = cs.device_ms(
                lambda: sb.gemm_sm90(a, w1, b1, None, act))
        times[f"gemm_sm90 fc2[rows={M}]"] = cs.device_ms(
            lambda: sb.gemm_sm90(h, w2, b2, x))
    del a, x, h
    w = cs.block_weights(inp, C)
    x, dout = inp.normal(cs.TB * 16, 256, C), inp.normal(cs.TB * 16, 256, C)
    times["K13"] = cs.device_ms(lambda: mtb.mlp_train_block_fwd(
        x, w["wfc1"], w["wfc2"], w["bfc1"], w["bfc2"], w["ln_scale"],
        w["ln_bias"], gelu_approx=False))
    times["K13[bwd]"] = cs.device_ms(lambda: mtb.mlp_train_block_bwd(
        x, dout, w["wfc1"], w["wfc2"], w["bfc1"], w["ln_scale"],
        w["ln_bias"], gelu_approx=False, bias=True))
    return times


# one head a rank: (label, C, heads, tp) of GENIE_35M over 8 ranks and
# GENIE_138M-h128 over 4
ONE_HEAD_RANKS = (("genie_35m_tp8", 256, 8, 8),
                  ("genie_138m_h128_tp4", 512, 4, 4))


def one_head_times(dev):
    """Device ms (profiler) and bound of the forms one head a rank takes, at
    a rank's train step (B = 8, T = 16, S = 256) of GENIE_35M at tp = 8
    (one head of 32) and of GENIE_138M-h128 at tp = 4 (one head of 128): K4
    (causal and not) and K6 (causal, with o, non-causal) at head groups of
    1, SDPA beside them; the GEMM at the tp = 8 rank's products
    (`chip_smoke.rank_gemm_cases`, N and K below 64); and each TP
    sub-layer's launch sequence at the rank's shapes, its one all-reduce
    taken as the identity (`tk.through`): K11's backward
    (`spatial_train_block_steps`) and the spatial forward's parts, K12's
    forward and backward (`temporal_fwd`, `temporal_train_block_steps`)
    and K13's (`mlp_fwd`, `mlp_train_block_steps`). One JSON line. No
    builds."""
    from tpu1x_torch.ops import mlp_train_block as mtb
    from tpu1x_torch.ops import spatial_train_block as stb
    from tpu1x_torch.ops import temporal_attention as ta
    from tpu1x_torch.ops import temporal_train_block as ttb
    from tpu1x_torch.parallel import tensor as tpl
    inp = cs.Inputs(2, dev)
    times, bounds, library = {}, {}, {}
    S, T, Bt = 256, 16, cs.TB
    R = Bt * T * S
    pairs = T * (T + 1) // 2
    for label, C, H, tp in ONE_HEAD_RANKS:
        h, c, f = C // tp, 3 * C // tp, 4 * C // tp  # proj rows, qkv, MLP
        D = C // H
        q, k, v = inp.normal(Bt, T, S, 3 * h).split(h, dim=-1)
        dout = inp.normal(Bt, T, S, h)
        o = torch.empty_like(dout)
        lq, lk, lv = (x.reshape(Bt, T, S, 1, D).permute(0, 2, 3, 1, 4)
                      .detach().requires_grad_(True) for x in (q, k, v))
        lout = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True, scale=D ** -0.5)
        for causal in (True, False):
            kw = dict(scale=D ** -0.5, num_heads=1, causal=causal)
            tag = f"[{label}" + ("]" if causal else ",non-causal]")
            times["K4" + tag] = cs.device_ms(
                lambda: ta.launch_forward(q, k, v, **kw))
            bounds["K4" + tag] = cs.temporal_bound(
                Bt, T, S, h, 4, pairs if causal else T * T, 2)[0]
            times["K6" + tag] = cs.device_ms(
                lambda: ta.launch_backward(q, k, v, dout, **kw))
            bounds["K6" + tag] = cs.temporal_bound(
                Bt, T, S, h, 7, pairs if causal else T * T, 5)[0]
        kw = dict(scale=D ** -0.5, num_heads=1, causal=True)
        times[f"K6[{label},o]"] = cs.device_ms(
            lambda: ta.launch_backward(q, k, v, dout, o=o, **kw))
        bounds[f"K6[{label},o]"] = cs.temporal_bound(Bt, T, S, h, 8, pairs,
                                                     6)[0]
        library[f"K4[{label}]"] = cs.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True, scale=D ** -0.5))
        library[f"K6[{label}]"] = cs.device_ms(
            lambda: torch.autograd.grad(
                lout, (lq, lk, lv),
                dout.reshape(Bt, T, S, 1, D).permute(0, 2, 3, 1, 4),
                retain_graph=True))
        del q, k, v, dout, o, lq, lk, lv, lout
        # the sub-layers at the rank's shapes, weights in the (in, out)
        # layout of the train blocks, proj's and fc2's as the TP forwards
        # take them (out, in)
        x, dx = inp.normal(Bt * T, S, C), inp.normal(Bt * T, S, C)
        xt, dxt = x.view(Bt, T, S, C), dx.view(Bt, T, S, C)
        wqkv, wproj = inp.normal(C, c, std=0.05), inp.normal(h, C, std=0.05)
        wproj_nt = wproj.t().contiguous()
        bqkv, bproj = inp.normal(c, std=0.1), inp.normal(C, std=0.1)
        ln_s = inp.normal(C, std=0.1, mean=1.0, dtype=torch.float32)
        ln_b = inp.normal(C, std=0.1, dtype=torch.float32)
        wfc1, wfc2 = inp.normal(C, f, std=0.05), inp.normal(f, C, std=0.05)
        wfc2_nt = wfc2.t().contiguous()
        bfc1, bfc2 = inp.normal(f, std=0.1), inp.normal(C, std=0.1)
        kw = dict(num_heads=1, scale=D ** -0.5)
        calls = {
            "K11[fwd parts]": lambda: tk.through(tpl.spatial_fwd(
                x, wqkv, wproj_nt, bqkv, bproj, ln_s, ln_b, **kw)),
            "K11": lambda: tk.through(stb.spatial_train_block_steps(
                x, dx, wqkv, wproj, bqkv, ln_s, ln_b, proj_bias=True, **kw)),
            "K12": lambda: tk.through(tpl.temporal_fwd(
                xt, wqkv, wproj_nt, bqkv, bproj, **kw)),
            "K12[bwd]": lambda: tk.through(ttb.temporal_train_block_steps(
                xt, dxt, wqkv, wproj, bqkv, proj_bias=True, split=True,
                **kw)),
            "K13": lambda: tk.through(tpl.mlp_fwd(
                x, wfc1, wfc2_nt, bfc1, bfc2, ln_s, ln_b, gelu_approx=False)),
            "K13[bwd]": lambda: tk.through(mtb.mlp_train_block_steps(
                x, dx, wfc1, wfc2, bfc1, ln_s, ln_b, gelu_approx=False,
                bias=True, split=True))}
        # tensor-core operations: the products of 2 R C x each (qkv c, proj
        # or its gradients h, the MLP f) and the attentions' of 2 D a pair;
        # bytes: x in and the fp32 partial out (forwards), or x, dout in and
        # dx out (backwards), 6 R C either way, the weights not counted
        attn_s, attn_t = 2 * R * h * S, 2 * Bt * S * h * pairs
        flops = {"K11[fwd parts]": 2 * R * C * (c + h) + 2 * attn_s,
                 "K11": 2 * R * C * (3 * c + 2 * h) + 6 * attn_s,
                 "K12": 2 * R * C * (c + h) + 2 * attn_t,
                 "K12[bwd]": 2 * R * C * (3 * c + 2 * h) + 6 * attn_t,
                 "K13": 4 * R * C * f, "K13[bwd]": 10 * R * C * f}
        for name, fn in calls.items():
            key = f"{name}[{label}]"
            times[key] = cs.device_ms(fn)
            bounds[key] = cs.bound(6 * R * C, tensor_flops=flops[name])[0]
        del x, dx, xt, dxt
        torch.cuda.empty_cache()
    serving, training = cs.rank_gemm_cases(inp)
    for name, a, w, bias, resid, act in serving:
        key = f"gemm_sm90 {name}[genie_35m_tp8]"
        times[key] = cs.device_ms(lambda: sb.gemm_sm90(a, w, bias, resid,
                                                       act))
        M, K = a.shape
        N = w.shape[1]
        bounds[key] = cs.bound(cs.nbytes(a, w, bias, resid) + M * N * 2,
                               tensor_flops=2 * M * N * K)[0]
    for name, a, b, kw in training:
        form = kw.get("form", "nn")
        key = f"gemm90 {form} {name}[genie_35m_tp8]"
        times[key] = cs.device_ms(lambda: tk.gemm90(a, b, **kw))
        K = a.shape[0] if form == "tn" else a.shape[1]
        M = a.shape[1] if form == "tn" else a.shape[0]
        N = b.shape[0] if form == "nt" else b.shape[1]
        out_bytes = M * N * (4 if form == "tn" or kw.get("fp32_out") else 2)
        bounds[key] = cs.bound(
            cs.nbytes(a, b, *(v for v in kw.values()
                              if isinstance(v, torch.Tensor))) + out_bytes
            * (2 if kw.get("pre_out") else 1),
            tensor_flops=2 * M * N * K)[0]
    print(json.dumps({"library_device_ms": library}), flush=True)
    print(json.dumps({"bound_ms": bounds}), flush=True)
    print(json.dumps({"ab_device_ms": times}), flush=True)


def w32_times(dev):
    """`ab_times` of the frame-axis forms at GENIE_138M-T32's window, with
    the SDPA calls beside them."""
    with cs.window_of(cs.genie_138m_t32()):
        ab_times(dev, extra=True, T=32)


def c8(dev, runs: int = 10):
    """ROADMAP C8: the tokenizer phase's update gate, run after run. The
    CPU's three micro-steps once (`chip_smoke.check_tokenizer_step_parity`'s
    last part: TT_SMALL, the perceptual term off), then the card's from the
    CPU's latent cotangents `runs` times with cuDNN as the step sets it and
    `runs` times with deterministic algorithms
    (`torch.use_deterministic_algorithms`), first as the check ran before
    its repair, then steered (`tokenizer_run`'s `steer`, the check's
    form). Each run prints
    `chip_smoke.tokenizer_errors` (the largest update error and where, the
    `undecided` count, what is past its limit), a digest of each call's
    discriminator and generator gradients (equal digests: bitwise equal
    runs) and the cuDNN kernels the run launched (by the profiler's names;
    the full list where it changes)."""
    import dataclasses
    import hashlib
    from torch.profiler import ProfilerActivity, profile
    frames = cs.synthetic_frames(cs.TT_STEPS * cs.TT_SMALL_B,
                                 cs.TT_SMALL.resolution, 21)
    batches = list((torch.from_numpy(frames).float() / 127.5 - 1.0).split(
        cs.TT_SMALL_B))
    cfg = dataclasses.replace(cs.TT_SMALL, perceptual_weight=0.0)
    cpu = cs.tokenizer_run(cfg, "cpu", batches, None)

    def digest(grads):
        h = hashlib.sha256()
        for call in grads:
            for k in sorted(call):
                h.update(call[k].detach().float().cpu().numpy().tobytes())
        return h.hexdigest()[:12]
    last = None
    for steer, det in ((False, False), (False, True), (True, False),
                       (True, True)):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for i in range(runs):
            with profile(activities=[ProfilerActivity.CUDA]
                         if dev.type == "cuda" else
                         [ProfilerActivity.CPU]) as prof:
                got = cs.tokenizer_run(cfg, dev, batches, None,
                                       cotangents=cpu["dz"],
                                       steer=cpu if steer else None)
                torch.cuda.synchronize()
            names = sorted({a.key for a in prof.key_averages()
                            if a.device_type == torch.autograd.DeviceType.CUDA
                            and any(w in a.key.lower() for w in (
                                "conv", "gemm", "wgrad", "dgrad", "fprop",
                                "cudnn", "xmma", "fft", "winograd", "dse"))})
            worst, bad = cs.tokenizer_errors(got, cpu)
            row = dict(steer=steer, deterministic=det, run=i,
                       update=worst["update"],
                       where=worst["where"].get("update"),
                       undecided=worst["undecided"], metric=worst["metric"],
                       state=worst["state"], bad=bad,
                       disc_grads=digest(got["grads"]["disc"]),
                       gen_grads=digest(got["grads"]["gen"]),
                       kernels=hashlib.sha256(
                           "|".join(names).encode()).hexdigest()[:12])
            if names != last:
                row["kernel_names"] = names
                last = names
            print(json.dumps(row, default=str), flush=True)
    torch.use_deterministic_algorithms(False)


def genie_35m(dev):
    """chip_smoke.py's GENIE_35M phase, then its TP setup, alone."""
    out = cs.check_genie_35m(dev)
    print("genie_35m phase walls: " + json.dumps(out["phase_walls_s"]),
          flush=True)
    cs.tp_setup(*next(x for x in cs.TP_SETUPS if x[0] == "genie_35m"), dev)


def mup(dev):
    """chip_smoke.py's muP phase alone."""
    print("mup: " + json.dumps(cs.check_mup(dev)), flush=True)


def h72(dev):
    """chip_smoke.py's head_dim-72 phase alone."""
    out = cs.check_head_dim_72(dev)
    print("h72 phase walls: " + json.dumps(out["phase_walls_s"]),
          flush=True)


def h128(dev):
    """chip_smoke.py's head_dim-128 phase alone, then the TP setups of
    GENIE_138M-h64 and -h128 (tp = 2, two ranks on this card)."""
    out = cs.check_head_dim_128(dev)
    print("h128 phase walls: " + json.dumps(out["phase_walls_s"]),
          flush=True)
    for setup in cs.TP_SETUPS:
        if setup[0] in ("genie_138m_h64", "genie_138m_h128"):
            cs.tp_setup(*setup, dev)


MODES = {"block": block, "mlp": mlp, "train": train, "temporal": temporal,
         "l2": l2, "decode": decode, "rollout": rollout, "fresh": fresh,
         "k2gate": k2gate, "cli": cli_after_evaluation,
         "cli_bare": functools.partial(cli_after_evaluation,
                                       tokenizer=False),
         "tp_cards": tp_cards, "tp_faults": tp_faults, "tp_c9": tp_c9,
         "tp_steps": tp_steps,
         "genie_35m": genie_35m, "mup": mup, "h64_debug": h64_debug,
         "h128": h128, "h72": h72,
         "ab_times": ab_times, "c8": c8, "w32_debug": w32_debug,
         "k12gate": k12gate, "w32_times": w32_times,
         "s1024_debug": s1024_debug, "s1024": s1024,
         "s1024_times": s1024_times, "widths_debug": widths_debug,
         "width_loss": width_loss,
         "h128_debug": functools.partial(h64_debug, config="h128")}
# mode: (the source its builds are variants of, the timing)
VARIANTS = {"flash": ("flash_attention", flash),
            "gemm": ("spatial_block", gemm), "tn": ("train_block", tn),
            "ta": ("temporal_attention", ta_builds),
            "da": ("decode_attention", da_builds)}


def main() -> int:
    if sys.argv[1:2] == ["tp_cards_rank"]:
        return tp_cards_rank(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), sys.argv[5], sys.argv[6])
    if sys.argv[1:2] == ["h64_one"]:
        return h64_one(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    if sys.argv[1:2] == ["h64_debug"] and len(sys.argv) == 3:
        if not torch.cuda.is_available() or sys.argv[2] not in HEAD_DEBUG:
            print(__doc__, file=sys.stderr)
            return 2
        h64_debug(torch.device("cuda"), sys.argv[2])
        print(cs.card_line(), flush=True)
        return 0
    if sys.argv[1:2] == ["w32_one"]:
        return w32_one(sys.argv[2])
    if sys.argv[1:2] == ["s1024_one"]:
        return s1024_one(sys.argv[2])
    if sys.argv[1:2] == ["widths_one"]:
        return widths_one(sys.argv[2])
    if sys.argv[1:2] == ["ab_times"] and len(sys.argv) == 3:
        if not torch.cuda.is_available() or sys.argv[2] not in AB_CONFIGS:
            print(__doc__, file=sys.stderr)
            return 2
        ab_times(torch.device("cuda"), **AB_CONFIGS[sys.argv[2]])
        print(cs.card_line(), flush=True)
        return 0
    if sys.argv[1:2] in (["tp_faults"], ["tp_steps"]) and len(sys.argv) == 3:
        if not torch.cuda.is_available():
            print(__doc__, file=sys.stderr)
            return 2
        MODES[sys.argv[1]](torch.device("cuda"), sys.argv[2])
        print(cs.card_line(), flush=True)
        return 0
    if sys.argv[1:2] == ["tp_fault_rank"]:
        return tp_fault_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             sys.argv[5], sys.argv[6])
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if not torch.cuda.is_available() or mode not in (*VARIANTS, *MODES) \
            or (mode not in MODES) != (len(sys.argv) > 2):
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if mode in MODES:
        MODES[mode](dev)
        print(cs.card_line(), flush=True)
        return 0
    source, fn = VARIANTS[mode]
    fn(builds(sys.argv[2:], source), dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
