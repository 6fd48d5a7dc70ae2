"""Build and load the port's CUDA kernels: one shared library per kernel
source, each with a plain C interface, bound with ctypes.

Every ``csrc/<name>.cu`` is compiled at first use into
``kmc_tpu_torch/_build/<hash>/libkmc_<name>.so``, where the hash covers all
sources (headers included) and the flags, so an edit rebuilds.  One
``nvcc`` runs per source, all started together, so the build takes as long
as its slowest source.  No source includes a PyTorch header (which would
cost minutes per build); a build takes seconds.  ``nvcc`` comes from
``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or the ``PATH``.
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


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    paths: dict         # kernel source name -> its shared library
    seconds: float      # wall time of the parallel nvcc runs (0.0 if reused)
    reused: bool        # an identical build was already on disk
    ptxas: str          # nvcc's -Xptxas -v reports (registers, shared memory)


_lock = threading.Lock()
_loaded: tuple[dict, BuildInfo] | None = None


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def kernel_names() -> list[str]:
    """The kernel sources, ``csrc/<name>.cu``, by name."""
    return [os.path.basename(p)[:-3] for p in _sources() if p.endswith(".cu")]


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
    """Compile every kernel library unless this exact build is on disk."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    names = kernel_names()
    paths = {n: os.path.join(out_dir, f"libkmc_{n}.so") for n in names}
    log_path = os.path.join(out_dir, "ptxas.log")
    if all(map(os.path.isfile, [*paths.values(), log_path])):
        with open(log_path) as f:
            return BuildInfo(paths, 0.0, True, f.read())
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _find_nvcc()
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp)
    reports, failed = [], []
    for name, (proc, tmp) in jobs.items():
        _, err = proc.communicate()
        reports.append(err)
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode}):\n{err}")
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[name])   # atomic: all of a library or none
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    report = "".join(reports)
    with open(log_path, "w") as f:
        f.write(report)
    return BuildInfo(paths, seconds, False, report)


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


def load() -> tuple[dict, BuildInfo]:
    """The loaded kernel libraries by source name (built on first call)
    and the build's info."""
    global _loaded
    with _lock:
        if _loaded is None:
            info = build()
            _loaded = ({n: ctypes.CDLL(p) for n, p in info.paths.items()},
                       info)
        return _loaded


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``."""
    return load()[0][name]
