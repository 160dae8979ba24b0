"""Time builds of one kernel source side by side on one NVIDIA GPU.

    python3 chip_variants.py flash NAME=LIB ...
    python3 chip_variants.py gemm NAME=LIB ...
    python3 chip_variants.py tn NAME=LIB ...
    python3 chip_variants.py block
    python3 chip_variants.py mlp
    python3 chip_variants.py train

Each LIB is a shared library built from a variant of a source in
`tpu1x_torch/csrc` (nvcc with `kernels.NVCC_FLAGS`, `-I` its own copy of the
headers), or `cur` for this checkout's own build; every build has this
checkout's entry points. The builds run in turns, first to last and back,
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

Prints one line per build and case, and the card.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

import chip_smoke as cs
from tpu1x_torch import kernels
from tpu1x_torch.ops import _train_kernels as tk
from tpu1x_torch.ops import spatial_block as sb

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long


def builds(args, source):
    """{name: library} from NAME=LIB arguments."""
    out = {}
    for arg in args:
        name, path = arg.split("=", 1)
        out[name] = kernels.lib(source) if path == "cur" else ctypes.CDLL(path)
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


MODES = {"block": block, "mlp": mlp, "train": train}
# mode: (the source its builds are variants of, the timing)
VARIANTS = {"flash": ("flash_attention", flash),
            "gemm": ("spatial_block", gemm), "tn": ("train_block", tn)}


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
