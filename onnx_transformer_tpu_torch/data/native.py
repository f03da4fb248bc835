"""ctypes binding of the native host data core ``native/dataio.cpp`` (port
of ``onnx_transformer_tpu/data/native.py``).

The shared C++ source is compiled on demand with ``g++`` into
``onnx_transformer_tpu_torch/_build/`` (never into ``native/``).  It is a
host-side encoder: callers check :func:`available` and take the
pure-Python path of ``data.dataset`` when it cannot build, as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "dataio.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(_BUILD_DIR, "libotxdataio.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    """Compile into a temporary file beside the library, then rename it
    over the library, so that processes building at once never load a
    half-written file."""
    if not os.path.exists(_SRC):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:   # a library this machine cannot load
        return None
    lib.otx_vocab_create.restype = ctypes.c_void_p
    lib.otx_vocab_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                                     ctypes.c_int32]
    lib.otx_vocab_free.restype = None
    lib.otx_vocab_free.argtypes = [ctypes.c_void_p]
    lib.otx_vocab_size.restype = ctypes.c_int32
    lib.otx_vocab_size.argtypes = [ctypes.c_void_p]
    lib.otx_vocab_lookup.restype = ctypes.c_int32
    lib.otx_vocab_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.otx_encode_batch.restype = None
    lib.otx_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.otx_line_lengths.restype = None
    lib.otx_line_lengths.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeVocab:
    """C++-backed vocab (a stoi hash) with the ids of the Python ``Vocab``."""

    def __init__(self, itos: Sequence[str], default_index: int = 3):
        lib = _load()
        if lib is None:
            raise RuntimeError("native dataio unavailable")
        self._lib = lib
        self._tokens = [t.encode("utf-8") for t in itos]
        arr = (ctypes.c_char_p * len(self._tokens))(*self._tokens)
        self._handle = ctypes.c_void_p(lib.otx_vocab_create(arr, len(self._tokens),
                                                            default_index))
        self.size = len(itos)

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.otx_vocab_free(self._handle)
            self._handle = None

    def lookup(self, token: str) -> int:
        return self._lib.otx_vocab_lookup(self._handle, token.encode("utf-8"))

    def encode_batch(self, lines: Sequence[str], max_padding: int, bos: int = 0,
                     eos: int = 1, pad: int = 2) -> np.ndarray:
        """<s> + ids + </s> per line, padded (or truncated, keeping </s>)
        to ``max_padding`` -> int32 [len(lines), max_padding]."""
        enc = [line.encode("utf-8") for line in lines]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        out = np.empty((len(enc), max_padding), dtype=np.int32)
        self._lib.otx_encode_batch(self._handle, arr, len(enc), max_padding, bos, eos, pad,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out


def line_lengths(lines: Sequence[str]) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native dataio unavailable")
    enc = [line.encode("utf-8") for line in lines]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    out = np.empty((len(enc),), dtype=np.int32)
    lib.otx_line_lengths(arr, len(enc), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
