"""Build and bind the port's CUDA kernels.

Every source in `tpu1x_torch/csrc/*.cu` compiles with `nvcc` into a shared
library with a plain C interface, one library per source, and is bound with
ctypes. The build runs at first use, all sources at once (one `nvcc` each,
started together), into `build/kernels/` at the repository root; a library
is named by a hash of its sources and flags, so a changed source rebuilds and
an unchanged one loads as it is.

Nothing here runs while the module is imported: the CPU tests import every
module on a machine with no `nvcc` and no card.

`LAUNCHES` counts, for each kernel, the wrapper calls that launched it on the
card. The wrappers in `tpu1x_torch/ops/` add one where they launch and
nowhere else; a CPU tensor takes the plain version and counts nothing. The
tensor-parallel sub-layers (`tpu1x_torch/parallel/tensor.py`, the kernels of
the train blocks at a rank's shapes) count under names of their own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
# C entry points of each library: (name, argtypes). Every entry point
# returns the cudaError_t of its launches (0 on success).
SIGNATURES = {
    "layer_norm": [
        # x, scale, bias, y, rows, C, eps, stream
        ("tpu1x_layer_norm", [P, P, P, P, I, I, F, P]),
    ],
    "spatial_block": [
        # x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, qk_ln_scale,
        # qk_ln_bias, xn_buf, qkv_buf, attn_buf, out, N, S, C, H, scale,
        # stream
        ("tpu1x_spatial_block", [P] * 13 + [I, I, I, I, F, P]),
        # A, B, C, bias, resid, M, N, K, act, stream
        ("tpu1x_gemm_sm90", [P] * 5 + [I] * 4 + [P]),
    ],
    "temporal_attention": [
        # q, k, v, out, B, T, S, C, D, ld, scale, causal, stream
        ("tpu1x_temporal_attention", [P] * 4 + [I] * 6 + [F, I, P]),
        # q, k, v, dout, o, dq, dk, dv, B, T, S, C, D, ld, ld_do, ld_out,
        # scale, causal, stream
        ("tpu1x_temporal_attention_bwd", [P] * 8 + [I] * 8 + [F, I, P]),
    ],
    "train_block": [
        # A, B, C, pre, Cf, bias, resid, aux, M, N, K, form, act, stream
        ("tpu1x_gemm90_train", [P] * 8 + [I] * 5 + [P]),
        # x, out, rows, N, ld, stream
        ("tpu1x_col_sum", [P, P, I, I, L, P]),
        # x, scale, bias, xn, stats, rows, C, eps, stream
        ("tpu1x_ln_fwd", [P, P, P, P, P, I, I, F, P]),
        # x, stats, scale, d_xn, dout, dx, dscale, dbias, rows, C, stream
        ("tpu1x_ln_bwd", [P] * 8 + [I, I, P]),
    ],
    "temporal_mlp_block": [
        # x, k_cache, v_cache, t_B, wqkv, bqkv, wproj, bproj, ln_scale,
        # ln_bias, wfc1, bfc1, wfc2, bfc2, qkv_buf, attn_buf, x1_buf, xn_buf,
        # h_buf, out, k_out, v_out, B, frames, S, C, D, F4, T, L, layer,
        # gelu_tanh, scale, stream
        ("tpu1x_temporal_mlp_block", [P] * 22 + [I] * 10 + [F, P]),
    ],
    "decode_attention": [
        # q0, q1, k0, k1, v0, v1, sbq, ldq, sbk, ldk, sbv, ldv, k_cache,
        # v_cache, k_scale, v_scale, t_B, out0, out1, osb, old, k_out, v_out,
        # B, frames, S, C, D, T, L, layer, scale, stream
        ("tpu1x_decode_attention", [P] * 6 + [L] * 6 + [P] * 7 + [L, L, P, P]
         + [I] * 8 + [F, P]),
    ],
    "flash_attention": [
        # q, k, v, out, lse, rsq, tsq, rsk, tsk, rsv, tsv, R, N, H, D, scale,
        # causal, stream
        ("tpu1x_flash_mha", [P] * 5 + [L] * 6 + [I] * 4 + [F, I, P]),
        # q, k, v, o, d_o, lse, dq, dk, dv, work, rsq, tsq, rsk, tsk, rsv,
        # tsv, rso, tso, rsg, tsg, rsdq, tsdq, rsdk, tsdk, rsdv, tsdv, R, N,
        # H, D, scale, causal, stream
        ("tpu1x_flash_mha_bwd", [P] * 10 + [L] * 16 + [I] * 4 + [F, I, P]),
    ],
}

LAUNCHES: Dict[str, int] = {
    "spatial_block": 0,
    "temporal_mlp_block": 0,
    "temporal_mlp_block_pair": 0,
    "temporal_attention": 0,
    "layer_norm": 0,
    "temporal_attention_bwd": 0,
    "spatial_train_block_bwd": 0,
    "temporal_train_block": 0,
    "temporal_train_block_bwd": 0,
    "mlp_train_block": 0,
    "mlp_train_block_bwd": 0,
    "temporal_decode_attention": 0,
    "temporal_decode2_attention": 0,
    "flash_mha": 0,
    "flash_mha_bwd": 0,
    "tp_spatial_train_block": 0,
    "tp_spatial_train_block_bwd": 0,
    "tp_temporal_train_block": 0,
    "tp_temporal_train_block_bwd": 0,
    "tp_mlp_train_block": 0,
    "tp_mlp_train_block_bwd": 0,
    "tp_row_parallel": 0,
    "tp_row_parallel_bwd": 0,
    "tp_column_parallel_bwd": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every kernel source that has no library yet, all in parallel.

    Returns {name: compiler output}; with `verbose` every source is rebuilt
    and the output holds ptxas's register, shared-memory and spill counts.
    Raises RuntimeError with the compiler's output if a build fails.
    """
    extra = ["-Xptxas", "-v"] if verbose else []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        path = _lib_path(name)
        if path.exists() and not verbose:
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The bound library of kernel source `name`, built at first use."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            cdll = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name]:
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
