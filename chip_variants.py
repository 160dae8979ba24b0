"""Time builds of one kernel source side by side on one NVIDIA GPU.

    python3 chip_variants.py flash NAME=LIB ...
    python3 chip_variants.py gemm NAME=LIB ...
    python3 chip_variants.py block

Each LIB is a shared library built from a variant of a source in
`tpu1x_torch/csrc` (nvcc with `kernels.NVCC_FLAGS`, `-I` its own copy of the
headers), or `cur` for this checkout's own build; every build has this
checkout's entry points. The builds run in turns, first to last and back,
in one process on one card; every time is the profiler's device time
(`chip_smoke.device_ms`).

- `flash`: K9 and K10 (`flash_attention.cu`) at the qk_norm train step's
  (R, N, H, D) = (128, 256, 16, 32), q, k, v as thirds of one tensor,
  causal and not.
- `gemm`: the blocks' GEMM (`spatial_block.cu`'s `tpu1x_gemm_sm90`) at
  K1's products (4096 / 8192 / 32768 rows; 512 -> 1536 with bias, 512 ->
  512 with bias and residual) and K2's and K3's MLP products (4096 / 8192
  rows; 512 -> 2048 with bias and the tanh GELU, 2048 -> 512 with bias and
  residual), each result held against `gemm_sm90_plain` (atol = rtol =
  3e-2).
- `block`: K2 and K3 (`temporal_mlp_block`, one frame and the pair)
  through this checkout's own wrappers, at the pre-LN rollout's shapes
  (GENIE_138M: B=16, S=256, C=512, 16 heads, F4=2048, a (16, 32, 16, 256,
  512) cache, t_B as `chip_smoke.py` draws it): the device time of one call
  (median of three windows) and of each of its launches, in order. It
  takes no builds: run it from a checkout (a parent's copy too) to time
  that checkout's kernels.

Prints one line per build and case, and the card.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

import chip_smoke as cs
from tpu1x_torch import kernels
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
            [P] * 9 + [L] * 10 + [I] * 4 + [F, I, P])
    for name in in_turns(libs):
        lib = libs[name]
        for causal in (0, 1):
            shape = (R, N, H, D, D ** -0.5, causal, stream)

            def fwd():
                return lib.tpu1x_flash_mha(*ptr[:4], ptr[5], rs, ts, rs, ts,
                                           rs, ts, *shape)

            def bwd():
                return lib.tpu1x_flash_mha_bwd(
                    *ptr, rs, ts, rs, ts, rs, ts, crs, cts, crs, cts, *shape)
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


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if not torch.cuda.is_available() or mode not in ("flash", "gemm", "block") \
            or (mode != "block") != (len(sys.argv) > 2):
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if mode == "block":
        block(dev)
        print(cs.card_line(), flush=True)
        return 0
    libs = builds(sys.argv[2:], "flash_attention" if mode == "flash"
                  else "spatial_block")
    (flash if mode == "flash" else gemm)(libs, dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
