"""Build and load the port's CUDA kernels: nvcc into one shared library
with a plain C interface, bound with ctypes.

The library is compiled at first use from the sources under
``kmc_tpu_torch/csrc/`` into ``kmc_tpu_torch/_build/<hash>/``, where the
hash covers the sources and the flags, so an edit rebuilds.  The build
includes no PyTorch header (which would cost minutes per build); it takes
seconds.  ``nvcc`` comes from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``
or the ``PATH``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
# -fmad=false: no multiply-add contraction, so the kernels round each
# operation as the plain PyTorch versions do and the two agree to the bit
# wherever their operation order agrees
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LIB_NAME = "libkmc_kernels.so"


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str           # the shared library
    seconds: float      # wall time of the nvcc run (0.0 when reused)
    reused: bool        # an identical build was already on disk
    ptxas: str          # nvcc's -Xptxas -v report (registers, shared memory)


_lock = threading.Lock()
_loaded: tuple[ctypes.CDLL, BuildInfo] | None = None


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the library unless this exact build is already on disk."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "ptxas.log")
    if os.path.isfile(lib) and os.path.isfile(log_path):
        with open(log_path) as f:
            return BuildInfo(lib, 0.0, True, f.read())
    os.makedirs(out_dir, exist_ok=True)
    units = [p for p in _sources() if p.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *units],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent build sees all or none
    with open(log_path, "w") as f:
        f.write(proc.stderr)
    return BuildInfo(lib, seconds, False, proc.stderr)


def ptxas_summary(report: str) -> list[str]:
    """The 'Used N registers, ... smem' lines of an -Xptxas -v report, one
    per kernel, with the kernel's name."""
    lines, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return lines


def load() -> tuple[ctypes.CDLL, BuildInfo]:
    """The loaded kernel library (built on first call) and its build info."""
    global _loaded
    with _lock:
        if _loaded is None:
            info = build()
            _loaded = (ctypes.CDLL(info.path), info)
        return _loaded
