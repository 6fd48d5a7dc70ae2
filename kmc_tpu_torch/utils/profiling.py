"""Profiling and throughput metering (port of
``kmc_tpu/utils/profiling.py``).

The reference has no timers at all (its only <chrono> use seeds the RNG,
main.cpp:2316).  Here the north-star counter -- KMC event attempts/s --
is a first-class meter, plus a thin wrapper over ``torch.profiler`` for
device traces and a timer that waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from kmc_tpu_torch.config import SimConfig


def events_per_step(cfg: SimConfig) -> int:
    """Event attempts per particle-engine timestep (BASELINE.md):
    molecule moves + trans pair tests + ordered cis pair tests."""
    return cfg.n + cfg.n_a * cfg.n_b * 3 + 2 * cfg.n_a * (cfg.n_a - 1)


@dataclass
class ThroughputMeter:
    """Accumulates (steps, replicas) work items and reports rates."""

    cfg: SimConfig
    t0: float = field(default_factory=time.perf_counter)
    steps: int = 0

    def add(self, n_steps: int, n_replicas: int = 1) -> None:
        self.steps += n_steps * n_replicas

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def steps_per_s(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def events_per_s(self) -> float:
        return self.steps_per_s * events_per_step(self.cfg)

    def report(self) -> dict:
        return {
            "steps": self.steps,
            "elapsed_s": self.elapsed,
            "steps_per_s": self.steps_per_s,
            "events_per_s": self.events_per_s,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` scope over the CPU and the card; on exit the
    Chrome trace is written to ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(device) -> None:
    """Wait until ``device`` has finished the work issued to it (nothing
    to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (tensors, tuples,
    NamedTuples, lists and dicts, nested)."""
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def timed_blocked(fn, *args):
    """(result, seconds): ``fn(*args)`` timed on the host clock up to the
    moment every card that holds a tensor of the result has finished."""
    t0 = time.perf_counter()
    out = fn(*args)
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
