"""Build and load the port's CUDA kernels.

Every ``.cu`` source under ``onnx_transformer_tpu_torch/csrc/`` is compiled
by its own ``nvcc`` process, all started together, and one more ``nvcc``
links the objects into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The library
goes to ``onnx_transformer_tpu_torch/_build/`` under a name derived from the
hash of the sources and flags, so a changed source builds anew.  Nothing
here runs at import: the first CUDA launch calls :func:`library`.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures of the entry points: "p" a pointer or the stream, "i" an int,
# "f" a float.  Each returns the launch's cudaError_t.
SIGNATURES = {
    "quant_w8a8_qout": "pppppiiiiip",
    "quant_w8a8_q8": "ppppppiiiiip",
    "quant_w4a8_qout": "pppppiiiiip",
    "quant_w4a8_q8": "ppppppiiiiip",
    "quant_w8a8_gemm": "pppppiiiiiip",
    "quant_w4a8_gemm": "pppppiiiiiip",
    "w8a8_gemm": "ppppppiiiip",
    "decode_attention_int8": "pppppppiiiiifip",
}

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


def _compile_and_link(cus: list[str], so: str) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link;
    the commands and the compiler's output go to ``_build/nvcc.log``."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(c)}.{tag}.o") for c in cus]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, c] for c, o in zip(cus, objs))]
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    tmp = f"{so}.{tag}"
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(log))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)


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
        _compile_and_link([s for s in srcs if s.endswith(".cu")], so)
        built = True
    _lib = ctypes.CDLL(so)
    build_info.update(path=so, built=built, seconds=time.perf_counter() - t0)
    return _lib


def launch(fn: str, device, *args) -> None:
    """Call the C entry point ``fn`` with the current stream of ``device``
    appended, and raise if the launch was refused."""
    import ctypes

    import torch

    f = getattr(library(), fn)
    if f.argtypes is None:
        types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        f.restype = ctypes.c_int
        f.argtypes = [types[c] for c in SIGNATURES[fn]]
    with torch.cuda.device(device):
        err = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")
