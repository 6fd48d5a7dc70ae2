"""ctypes bindings to the native I/O codec (``csrc/kmcio.cpp``, port of
``kmc_tpu/io/native.py``).

The C++ file is the package's own copy of the JAX package's
``native/kmcio.cpp``, kept byte for byte the same.  It is compiled with
``g++`` at first use into ``kmc_tpu_torch/_build/kmcio-<hash>/libkmcio.so``
(the hash covers the source).  Where ``g++`` or the library is unavailable,
``available()`` is false and the writers (io/writers.py) format in Python,
as the JAX package's writers do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "kmcio.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")

_lib = None
_lock = threading.Lock()


def _library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f"kmcio-{digest}", "libkmcio.so")


def _compile(path: str) -> bool:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, SRC,
                        "-lpthread"], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, path)
    return True


def ensure_built() -> bool:
    """Compile and bind libkmcio.so if needed; returns availability."""
    global _lib
    with _lock:
        if _lib is not None:
            return True
        if not os.path.isfile(SRC):
            return False
        path = _library_path()
        if not os.path.isfile(path) and not _compile(path):
            return False
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return False
        lib.kmcio_format_gro.restype = ctypes.c_long
        lib.kmcio_format_gro.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.kmcio_format_cpt.restype = ctypes.c_long
        lib.kmcio_format_cpt.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.kmcio_writer_open.restype = ctypes.c_void_p
        lib.kmcio_writer_open.argtypes = [ctypes.c_char_p]
        lib.kmcio_writer_append.restype = None
        lib.kmcio_writer_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long
        ]
        lib.kmcio_writer_pending.restype = ctypes.c_long
        lib.kmcio_writer_pending.argtypes = [ctypes.c_void_p]
        lib.kmcio_writer_close.restype = ctypes.c_long
        lib.kmcio_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return True


def available() -> bool:
    return ensure_built()


def _need_lib():
    if not ensure_built():
        raise RuntimeError("native kmcio unavailable (g++ or "
                           "csrc/kmcio.cpp missing)")
    return _lib


def format_gro(pos: np.ndarray, n_a: int, n_b: int, t_ns: float,
               box) -> bytes:
    """One test.gro frame from positions f32[n, 4, 4, 3]."""
    lib = _need_lib()
    pos = np.ascontiguousarray(pos, np.float32)
    cap = (n_a * 4 + n_b * 3) * 64 + 256
    buf = ctypes.create_string_buffer(cap)
    n = lib.kmcio_format_gro(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_a, n_b, t_ns, box[0], box[1], box[2], buf, cap)
    if n < 0:
        raise RuntimeError("kmcio buffer too small")
    return buf.raw[:n]


def format_cpt(pos: np.ndarray, a_top: np.ndarray, b_top: np.ndarray,
               counters, n_a: int, n_b: int) -> bytes:
    """A position.cpt body; counters = (bond_num, rl, cis, mono_cis,
    max_complex, step)."""
    lib = _need_lib()
    pos = np.ascontiguousarray(pos, np.float32)
    a_top = np.ascontiguousarray(a_top, np.int32)
    b_top = np.ascontiguousarray(b_top, np.int32)
    cap = (n_a * 17 + n_b * 12 + 8) * 48
    buf = ctypes.create_string_buffer(cap)
    n = lib.kmcio_format_cpt(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_a, n_b,
        a_top.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_top.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        *[int(c) for c in counters], buf, cap)
    if n < 0:
        raise RuntimeError("kmcio buffer too small")
    return buf.raw[:n]


class AsyncWriter:
    """Background-thread append writer: frames handed to ``append`` are
    written in order by a C++ thread, so output never blocks the step
    loop; ``close`` flushes and joins it."""

    def __init__(self, path: str):
        lib = _need_lib()
        self._h = lib.kmcio_writer_open(path.encode())
        if not self._h:
            raise OSError(f"kmcio_writer_open failed for {path}")

    def append(self, data: bytes) -> None:
        _lib.kmcio_writer_append(self._h, data, len(data))

    def pending(self) -> int:
        return _lib.kmcio_writer_pending(self._h)

    def close(self) -> int:
        h, self._h = self._h, None
        return _lib.kmcio_writer_close(h) if h else 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
