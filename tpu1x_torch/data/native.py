"""ctypes binding to the native token-store runtime (native/token_store.cc).

The port's own binding to the runtime that the JAX package loads, built
by the same native/Makefile into a library of its own, `build/native/
libtoken_store.so`, at first use if it is missing or older than the source
and a compiler is there. Every entry point has a numpy form with the same
semantics, which runs when the library cannot be built or loaded or when
`TPU1X_DISABLE_NATIVE=1`. These are host helpers: batches stay numpy, and
callers move them to the device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR.parent / "build" / "native" / "libtoken_store.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    """Build `_LIB_PATH` with native/Makefile where it is missing or older
    than the source: `make` in a directory of this process's own (the
    source found through `vpath`), the library then renamed into place
    (`os.replace` is atomic). A loader in another process, as pytest's
    workers are, finds no library or a whole one, never one that a linker
    is still writing (which `ctypes.CDLL` refuses as "file too short")."""
    source = _NATIVE_DIR / "token_store.cc"
    if (_LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= source.stat().st_mtime):
        return
    own = _LIB_PATH.parent / f"build.{os.getpid()}"
    own.mkdir(parents=True, exist_ok=True)
    try:
        subprocess.run(["make", "-s", "-C", str(own), "-f",
                        str(_NATIVE_DIR / "Makefile"),
                        f"--eval=vpath %.cc {_NATIVE_DIR}"], check=True,
                       capture_output=True)
        os.replace(own / _LIB_PATH.name, _LIB_PATH)
    finally:
        shutil.rmtree(own, ignore_errors=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TPU1X_DISABLE_NATIVE") == "1":
        return None
    try:
        _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        return None

    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.build_window_index.restype = I64
    lib.build_window_index.argtypes = [P, I64, I64, P]
    lib.filter_overlaps.restype = I64
    lib.filter_overlaps.argtypes = [P, I64, I64, I64, I64, P]
    lib.gather_windows.restype = None
    lib.gather_windows.argtypes = [P, I64, I64, I64, P, I64, I32, I32, P]
    _lib = lib
    return _lib


def have_native() -> bool:
    return _load() is not None


def build_window_index_numpy(segment_ids: Optional[np.ndarray],
                             num_frames: int, video_len: int) -> np.ndarray:
    """Start frames s in [0, num_frames - video_len), where, given segment
    ids, frame s and frame s + video_len lie in one segment."""
    starts = np.arange(max(num_frames - video_len, 0), dtype=np.int64)
    if segment_ids is not None:
        seg = np.asarray(segment_ids)
        starts = starts[seg[starts] == seg[starts + video_len]]
    return starts


def filter_overlaps_numpy(starts: np.ndarray, window_size: int,
                          stride: int) -> np.ndarray:
    """Keep a start only if no kept start lies 1 .. window_size - 1 strides
    before it: each frame in at most one kept window."""
    kept: list[int] = []
    kept_set: set[int] = set()
    for s in np.asarray(starts, dtype=np.int64).tolist():
        if kept_set.isdisjoint(s - i * stride for i in range(1, window_size)):
            kept.append(s)
            kept_set.add(s)
    return np.asarray(kept, dtype=np.int64)


def gather_windows_numpy(data: np.ndarray, starts: np.ndarray, T: int,
                         stride: int) -> np.ndarray:
    """data (num_frames, H, W), starts (B,) -> (B, T, H, W) int32."""
    H, W = data.shape[1], data.shape[2]
    if len(starts) == 0:
        return np.empty((0, T, H, W), dtype=np.int32)
    return np.stack([
        np.asarray(data[s:s + (T - 1) * stride + 1:stride]).astype(np.int32)
        for s in np.asarray(starts).tolist()])


def build_window_index(segment_ids: Optional[np.ndarray], num_frames: int,
                       video_len: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        return build_window_index_numpy(segment_ids, num_frames, video_len)
    out = np.empty(max(num_frames - video_len, 0), dtype=np.int64)
    seg_ptr = seg_arr = None
    if segment_ids is not None:
        seg_arr = np.ascontiguousarray(segment_ids, dtype=np.int32)
        seg_ptr = seg_arr.ctypes.data_as(ctypes.c_void_p)
    n = lib.build_window_index(seg_ptr, num_frames, video_len,
                               out.ctypes.data_as(ctypes.c_void_p))
    return out[:n].copy()


def filter_overlaps(starts: np.ndarray, window_size: int, stride: int,
                    num_frames: int) -> np.ndarray:
    lib = _load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if lib is None:
        return filter_overlaps_numpy(starts, window_size, stride)
    out = np.empty_like(starts)
    n = lib.filter_overlaps(starts.ctypes.data_as(ctypes.c_void_p),
                            len(starts), window_size, stride, num_frames,
                            out.ctypes.data_as(ctypes.c_void_p))
    return out[:n].copy()


def gather_windows(data: np.ndarray, starts: np.ndarray, T: int, stride: int,
                   num_threads: int = 8) -> np.ndarray:
    """data: memmap (num_frames, H, W) of 2- or 4-byte ids; starts: (B,) ->
    (B, T, H, W) int32, gathered by `num_threads` native threads."""
    lib = _load()
    if lib is None:
        return gather_windows_numpy(data, starts, T, stride)
    H, W = data.shape[1], data.shape[2]
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    B = len(starts)
    out = np.empty((B, T, H, W), dtype=np.int32)
    itemsize = data.dtype.itemsize
    if itemsize not in (2, 4):
        raise ValueError(f"gather_windows takes 2- or 4-byte ids, got "
                         f"{data.dtype}")
    base = data if isinstance(data, np.memmap) else np.ascontiguousarray(data)
    lib.gather_windows(
        ctypes.c_void_p(base.ctypes.data), H * W, stride, T,
        starts.ctypes.data_as(ctypes.c_void_p), B, itemsize, num_threads,
        out.ctypes.data_as(ctypes.c_void_p))
    return out
