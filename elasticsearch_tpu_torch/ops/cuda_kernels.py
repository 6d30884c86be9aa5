"""Build and bind the hand-written CUDA kernels under ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` (Hopper) into
``build/libestpu_torch_kernels.so`` at the repository root, the first time
a kernel is launched in a process, and again whenever a source or the
flags change (a sha256 stamp sits beside the library). Each source
compiles in its own ``nvcc`` process, all started together, then one link.
Nothing builds on import: the CPU path never needs ``nvcc``.

The library has a plain C interface and is loaded with ``ctypes``; every
pointer and the stream pass as ``c_void_p``. Each C entry point returns
the ``cudaError_t`` of its launch, which ``check`` turns into an error.
Every build, load and launch failure raises ``KernelError``, which the
search planes let through: a kernel fault is never served by another
rung.

``LAUNCHES`` counts kernel launches per kernel name. Wrappers add one
where they launch their kernel and nowhere else, so a caller can show that
a run went through the kernels (``reset_launch_counts`` zeroes them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
LIB_NAME = "libestpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_longlong = ctypes.c_longlong
_c_float = ctypes.c_float
_c_int_p = ctypes.POINTER(ctypes.c_int)

# C entry point -> argument types (restype is always c_int = cudaError_t)
_SIGNATURES = {
    "estpu_tile_scoring_dense": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_float, _c_void_p],
    "estpu_tile_scoring_topk": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_void_p],
    "estpu_tile_topk_max_clusters": [
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int_p],
    "estpu_segment_sum": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_longlong, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_longlong, _c_void_p],
    "estpu_segment_sum_gathered": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_void_p, _c_longlong, _c_longlong, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_longlong, _c_void_p],
    "estpu_segment_sum_combine": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int,
        _c_int, _c_void_p],
    "estpu_knn_score_tiles": [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_void_p],
    "estpu_knn_max_clusters": [
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int_p],
}

# the tile kernel's launch names: "tile_scoring" (dense, Q = 1),
# "tile_scoring_batched" (dense, Q > 1), "tile_scoring_topk", and
# "tile_scoring_topk_sel" (a tile subset), each with a "_packed" form for
# the packed codec
TILE_SCORING_LAUNCHES = tuple(
    base + suffix
    for base in ("tile_scoring", "tile_scoring_batched", "tile_scoring_topk",
                 "tile_scoring_topk_sel")
    for suffix in ("", "_packed"))
# the segment sum's main pass ("segment_sum") and its combine pass
SEGMENT_SUM_LAUNCHES = ("segment_sum", "segment_sum_combine")
LAUNCHES: Dict[str, int] = {**{name: 0 for name in TILE_SCORING_LAUNCHES},
                            **{name: 0 for name in SEGMENT_SUM_LAUNCHES},
                            "knn_scoring": 0}
_launch_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched."""


# compiler output of the last build (ptxas register/shared-memory report)
build_log: List[str] = []


def note_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise KernelError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path. Raises with the compiler's output when a build fails."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp_path = lib_path + ".sha256"
    digest = _digest()
    if os.path.exists(lib_path) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read().strip() == digest:
                return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    units = [p for p in sources() if p.endswith(".cu")]
    procs = []
    for src in units:
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise KernelError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    tmp = lib_path + f".tmp{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + ".o") for s in units]
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise KernelError("nvcc link failed\n" + link.stdout)
    os.replace(tmp, lib_path)
    with open(stamp_path, "w") as f:
        f.write(digest)
    build_log[:] = log
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _build_lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _c_int
            lib.estpu_error_string.argtypes = [_c_int]
            lib.estpu_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = library().estpu_error_string(rc).decode()
        raise KernelError(
            f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
