"""Time builds of one kernel source side by side on one NVIDIA GPU.

    python3 chip_variants.py flash NAME=LIB ...
    python3 chip_variants.py gemm NAME=LIB ...

Each LIB is a shared library built from a variant of a source in
`tpu1x_torch/csrc` (nvcc with `kernels.NVCC_FLAGS`, `-I` its own copy of the
headers), or `cur` for this checkout's own build; every build has this
checkout's entry points. The builds run in turns, first to last and back,
in one process on one card; every time is the profiler's device time
(`chip_smoke.device_ms`).

- `flash`: K9 and K10 (`flash_attention.cu`) at the qk_norm train step's
  (R, N, H, D) = (128, 256, 16, 32), q, k, v as thirds of one tensor,
  causal and not.
- `gemm`: K1's GEMM (`spatial_block.cu`'s `tpu1x_gemm_sm90`) at K1's
  products (4096 / 8192 / 32768 rows; 512 -> 1536 with bias, 512 -> 512
  with bias and residual), each result held against `gemm_sm90_plain`
  (atol = rtol = 3e-2).

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
        lib.tpu1x_gemm_sm90.argtypes = [P] * 5 + [I] * 3 + [P]
    for M in (4096, 8192, 32768):
        for K, N, resid in ((512, 1536, False), (512, 512, True)):
            a = torch.randn(M, K, generator=g, device=dev).bfloat16()
            b = (torch.randn(K, N, generator=g, device=dev) * 0.05).bfloat16()
            bias = (torch.randn(N, generator=g, device=dev) * 0.1).bfloat16()
            r = (torch.randn(M, N, generator=g, device=dev).bfloat16()
                 if resid else None)
            want = sb.gemm_sm90_plain(a, b, bias, r)
            out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            args = [a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    bias.data_ptr(), None if r is None else r.data_ptr(), M,
                    N, K]
            for name in in_turns(libs):
                lib = libs[name]

                def run():
                    return lib.tpu1x_gemm_sm90(*args, stream)
                if run() != 0:
                    raise RuntimeError(f"{name}: the GEMM did not launch")
                err = cs.compare(f"{name} M={M} N={N}", out, want, 3e-2, 3e-2)
                ms = cs.device_ms(run)
                print(json.dumps(dict(
                    build=name, M=M, K=K, N=N, resid=resid, max_abs_err=err,
                    device_ms=ms, tflops=cs.tflops(2 * M * K * N, ms))),
                    flush=True)


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 3 or sys.argv[1] \
            not in ("flash", "gemm"):
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    mode = sys.argv[1]
    libs = builds(sys.argv[2:], "flash_attention" if mode == "flash"
                  else "spatial_block")
    (flash if mode == "flash" else gemm)(libs, dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
