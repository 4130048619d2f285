"""ctypes bindings for the native batch gather (counterpart of moegan_tpu/data/native.py).

The port keeps its own copy of the C++ source, `data/csrc/batcher.cpp`, and
builds it at first use with `g++ -O3 -march=native -shared -fPIC ...
-lpthread` into `moegan_tpu_torch/_build/` (gitignored). The library is
named by a hash of the source, the flags and the host CPU's model and
feature flags (`-march=native` code built on one machine may not run on
another); it is written under a temporary name of its process and renamed
into place, so processes that build at once never load a half-written file.
A failed build raises with g++'s output: unlike the JAX module, nothing
falls back to numpy. Nothing is written next to the JAX package's
`native/` source.

The gathers take the JAX module's arguments. A float32 C-contiguous source,
a memory-mapped one included, is read in place (`np.ascontiguousarray` of
it is a view): a call copies the gathered rows only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from moegan_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "batcher.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _host_cpu() -> bytes:
    """The CPU's model name and feature flags, which decide what -march=native emits."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return os.uname().machine.encode()
    return b"\n".join(ln for ln in lines if ln.startswith((b"model name", b"flags")))


def library_path() -> Path:
    data = SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode() + _host_cpu()
    return BUILD_DIR / f"batcher-{hashlib.sha256(data).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; raise with g++'s output if that fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native batcher build failed ({' '.join(cmd)}): exit "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
            lib.gather_rows_f32.argtypes = [f32p, i64p, i64, i64, f32p, ctypes.c_int]
            lib.gather_images_f32.argtypes = [f32p, i64p, i64, i64, i64, i64, f32p, u8p,
                                              ctypes.c_int]
            lib.gather_normalize_f32.argtypes = [f32p, i64p, i64, i64, i64, f32p, f32p, f32p,
                                                 ctypes.c_int]
            for fn in (lib.gather_rows_f32, lib.gather_images_f32, lib.gather_normalize_f32):
                fn.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is loaded (building it raises if g++ fails)."""
    return load_library() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _inputs(src, idx):
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    if len(idx) and (idx.min() < -len(src) or idx.max() >= len(src)):
        raise IndexError(f"an index of {idx.min()}..{idx.max()} is out of range for "
                         f"{len(src)} rows")
    return src, np.where(idx < 0, idx + len(src), idx)


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """dst[i] = src[idx[i]] for a [N, ...] float32 array."""
    lib = load_library()
    src, idx = _inputs(src, idx)
    out = np.empty((len(idx),) + src.shape[1:], np.float32)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    lib.gather_rows_f32(_f32p(src), _i64p(idx), len(idx), row, _f32p(out), n_threads)
    return out


def gather_images(src: np.ndarray, idx: np.ndarray, flip: np.ndarray | None = None,
                  n_threads: int = 4) -> np.ndarray:
    """Gather [N, H, W, C] images, flipping sample i horizontally where flip[i]."""
    lib = load_library()
    src, idx = _inputs(src, idx)
    n, (h, w, c) = len(idx), src.shape[1:]
    out = np.empty((n, h, w, c), np.float32)
    if flip is not None:
        flip = np.ascontiguousarray(np.asarray(flip).astype(bool), np.uint8)
        if flip.shape != (n,):
            raise ValueError(f"flip must have shape ({n},), got {flip.shape}")
        fp = flip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        fp = ctypes.POINTER(ctypes.c_uint8)()
    lib.gather_images_f32(_f32p(src), _i64p(idx), n, h, w, c, _f32p(out), fp, n_threads)
    return out


def gather_normalize(src: np.ndarray, idx: np.ndarray, mean: np.ndarray, std: np.ndarray,
                     n_threads: int = 4) -> np.ndarray:
    """Gather [N, H, W, C] images in [-1, 1] and normalise them as CLIP does:
    ((x + 1) / 2 - mean[c]) / std[c]."""
    lib = load_library()
    src, idx = _inputs(src, idx)
    n, (h, w, c) = len(idx), src.shape[1:]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean and std must have shape ({c},), got {mean.shape}, {std.shape}")
    out = np.empty((n, h, w, c), np.float32)
    lib.gather_normalize_f32(_f32p(src), _i64p(idx), n, h * w, c, _f32p(mean), _f32p(std),
                             _f32p(out), n_threads)
    return out
