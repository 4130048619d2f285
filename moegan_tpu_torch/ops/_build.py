"""Builds the CUDA sources under `ops/csrc/` with nvcc and loads them with ctypes.

Each `.cu` file is compiled, at its first use, into a shared library with a
plain C interface: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`. The libraries go to `moegan_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source and of the shared headers
(`csrc/*.cuh`), so an edited source or header is built anew and an
unchanged one is reused. All missing libraries are built at
once, one nvcc process per source, started together. Each library is
written under a temporary name of its process and renamed into place, so
processes that build at once never load a half-written file; a program
that spawns ranks builds in the parent first (`build_all`).

Nothing here runs at import time: the CPU tests import every module, and
nvcc is needed only when a kernel is first launched on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = (
    "flash_attention.cu", "flash_attention_bwd.cu", "fused_moe.cu", "fused_moe_bwd.cu",
    "fused_moe_legacy.cu", "layer_norm.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return found


def library_path(source: str) -> Path:
    data = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel. Returns seconds."""
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu`, building it if needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(f"{stem}.cu")))
            lib.moegan_cuda_error_string.restype = ctypes.c_char_p
            lib.moegan_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[stem] = lib
        return lib


@functools.lru_cache(maxsize=None)
def entry(stem: str, name: str, argtypes: tuple):
    """(library, C entry point `name` of csrc/<stem>.cu), its argument types set once."""
    lib = load(stem)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return lib, fn


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.moegan_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
