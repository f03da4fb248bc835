"""Build and load the port's CUDA kernels.

All sources under ``onnx_transformer_tpu_torch/csrc/`` are compiled by one
``nvcc`` call into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library goes
to ``onnx_transformer_tpu_torch/_build/`` under a name derived from the hash
of the sources and flags, so a changed source builds anew.  Nothing here
runs at import: the first CUDA launch calls :func:`library`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def _sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    import ctypes

    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libotk_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    built = False
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in srcs if s.endswith(".cu")]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        built = True
    _lib = ctypes.CDLL(so)
    build_info.update(path=so, built=built, seconds=time.perf_counter() - t0)
    return _lib
