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

Each LIB is a shared library built from a variant of a source in
`tpu1x_torch/csrc` (nvcc with `kernels.NVCC_FLAGS`, `-I` its own copy of the
headers), a variant `.cu` file (built here, beside it, all at once), or
`cur` for this checkout's own build; every build has this checkout's entry
points. The builds run in turns, first to last and back,
in one process on one card; every time is the profiler's device time
(`chip_smoke.device_ms`).

- `flash`: K9 and K10 (`flash_attention.cu`) at the qk_norm train step's
  (R, N, H, D) = (128, 256, 16, 32), q, k, v as thirds of one tensor,
  causal and not; K10's dq, dk, dv contiguous, as the qk_norm step has
  them.
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
  `o`: K12's backward then launches no K4). Timed as `mlp`. No builds.
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

Prints one line per build and case, and the card.
"""

from __future__ import annotations

import ctypes
import functools
import json
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


def flash(libs, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    R, N, H, D = 128, 256, 16, 32
    qkv = torch.randn(R, N, 3, H, D, generator=g, device=dev).bfloat16()
    q, k, v = qkv.unbind(-3)
    dout = torch.randn(R, N, H, D, generator=g, device=dev).bfloat16()
    rs, ts, crs, cts = q.stride(0), q.stride(1), N * H * D, H * D
    o = torch.empty(R, N, H, D, dtype=torch.bfloat16, device=dev)
    lse = torch.empty(R, H, N, dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(o) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [t.data_ptr() for t in (q, k, v, o, dout, lse, dq, dk, dv)]
    for lib in libs.values():
        lib.tpu1x_flash_mha.argtypes = [P] * 5 + [L] * 6 + [I] * 4 + [F, I, P]
        lib.tpu1x_flash_mha_bwd.argtypes = (
            [P] * 9 + [L] * 16 + [I] * 4 + [F, I, P])
    for name in in_turns(libs):
        lib = libs[name]
        for causal in (0, 1):
            shape = (R, N, H, D, D ** -0.5, causal, stream)

            def fwd():
                return lib.tpu1x_flash_mha(*ptr[:4], ptr[5], rs, ts, rs, ts,
                                           rs, ts, *shape)

            def bwd():
                return lib.tpu1x_flash_mha_bwd(
                    *ptr, rs, ts, rs, ts, rs, ts, crs, cts, crs, cts,
                    *(crs, cts) * 3, *shape)
            if fwd() != 0:
                raise RuntimeError(f"{name}: the forward did not launch")
            f_ms = cs.device_ms(fwd)
            fwd()  # the backward's o and lse
            if bwd() != 0:
                raise RuntimeError(f"{name}: the backward did not launch")
            print(json.dumps(dict(build=name, causal=causal, fwd_device_ms=f_ms,
                                  bwd_device_ms=cs.device_ms(bwd))),
                  flush=True)


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
    import inspect
    from tpu1x_torch.ops import temporal_attention as ta
    inp = cs.Inputs(0, dev)
    C, H = 512, 16
    kw = dict(scale=(C // H) ** -0.5, num_heads=H)
    calls = []
    for tag, (Bt, T) in (("train", (cs.TB, 16)), ("prefill", (cs.B, cs.P))):
        q, k, v = inp.normal(Bt, T, 256, 3 * C).split(C, dim=-1)
        for causal in ((True, False) if tag == "train" else (True,)):
            calls.append((f"temporal_attention[{tag},causal={causal}]",
                          lambda q=q, k=k, v=v, causal=causal:
                          ta.launch_forward(q, k, v, causal=causal, **kw)))
        if tag != "train":
            continue
        dout = inp.normal(Bt, T, 256, C)
        for causal in (True, False):
            calls.append((f"temporal_attention_bwd[causal={causal}]",
                          lambda q=q, k=k, v=v, causal=causal:
                          ta.launch_backward(q, k, v, dout, causal=causal,
                                             **kw)))
        if "o" in inspect.signature(ta.launch_backward).parameters:
            o = torch.empty_like(dout)
            calls.append(("temporal_attention_bwd[causal=True,o]",
                          lambda q=q, k=k, v=v: ta.launch_backward(
                              q, k, v, dout, causal=True, o=o, **kw)))
    timed_calls(calls)


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
                    *ptr[:3], ptr[4], Bt, T, 256, C, 3 * C, scale, 1, stream)

            def bwd(with_o):
                return lib.tpu1x_temporal_attention_bwd(
                    *ptr[:4], ptr[4] if with_o else None, *ptr[5:], Bt, T,
                    256, C, 3 * C, C, 3 * C, scale, 1, stream)
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
                S * C, C, None, None, B, frames, S, C, T, L, c["kw"]["layer"],
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
    rs, ts, crs, cts = q.stride(0), q.stride(1), *dout.stride()[:2]
    stream = torch.cuda.current_stream().cuda_stream
    train, flash = kernels.lib("train_block"), kernels.lib("flash_attention")
    launches = {
        "gemm90[nn, gelu_erf]": lambda: train.tpu1x_gemm90_train(
            a.data_ptr(), w.data_ptr(), g.data_ptr(), None, None,
            bias.data_ptr(), None, None, 4096, 4 * C, C, tk.MODE["nn"],
            tk.ACT["gelu_erf"], stream),
        "flash_mha_bwd": lambda: flash.tpu1x_flash_mha_bwd(
            *(t.data_ptr() for t in (q, k, v, o, dout, lse, dq, dk, dv)),
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


MODES = {"block": block, "mlp": mlp, "train": train, "temporal": temporal,
         "l2": l2, "decode": decode, "rollout": rollout, "fresh": fresh,
         "k2gate": k2gate, "cli": cli_after_evaluation,
         "cli_bare": functools.partial(cli_after_evaluation,
                                       tokenizer=False)}
# mode: (the source its builds are variants of, the timing)
VARIANTS = {"flash": ("flash_attention", flash),
            "gemm": ("spatial_block", gemm), "tn": ("train_block", tn),
            "ta": ("temporal_attention", ta_builds),
            "da": ("decode_attention", da_builds)}


def main() -> int:
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
