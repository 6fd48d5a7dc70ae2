"""The port's profiling helpers (kmc_tpu_torch/utils/profiling.py) held
against kmc_tpu/utils/profiling.py on the CPU: the event-attempt count
per step, the throughput meter's arithmetic and report, the blocking
timer on nested results, and the torch.profiler trace scope."""

import json
import os
from typing import NamedTuple

import jax
import pytest
import torch

from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu.utils import profiling as jprof
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.utils import profiling as tprof


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache_small_torch():
    """Keep this module's JAX compiles out of the persistent cache (and so
    out of the tree), and keep torch to two threads per test worker."""
    from jax._src import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    threads = torch.get_num_threads()
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


@pytest.mark.parametrize("size", ["reference", "small"])
def test_events_per_step_matches(small_cfg, size):
    jcfg = JConfig() if size == "reference" else small_cfg
    tcfg = SimConfig(**jcfg.to_dict())
    assert tprof.events_per_step(tcfg) == jprof.events_per_step(jcfg)
    if size == "reference":
        assert tprof.events_per_step(tcfg) == 67_400


def test_throughput_meter_matches(small_cfg, monkeypatch):
    """Both meters on one fixed clock: the same fields and report."""
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: 13.0)
    tcfg = SimConfig(**small_cfg.to_dict())
    jm = jprof.ThroughputMeter(small_cfg, t0=0.0)
    tm = tprof.ThroughputMeter(tcfg, t0=0.0)
    for m in (jm, tm):
        m.add(3, n_replicas=8)
        m.add(2)
    assert tm.steps == jm.steps == 26
    want, got = jm.report(), tm.report()
    assert list(got) == list(want)
    assert got == want
    assert got["elapsed_s"] == 13.0 and got["steps_per_s"] == 2.0
    assert got["events_per_s"] == 2.0 * tprof.events_per_step(tcfg)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: tuple


def test_timed_blocked_nested(monkeypatch):
    """The result of fn comes back as it is, with a non-negative time; on
    the CPU no card is synchronised."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    out, sec = tprof.timed_blocked(
        lambda x: _Pair(x + 1, (x * 2, {"c": [x]})), torch.ones(3))
    assert isinstance(out, _Pair) and sec >= 0.0
    assert torch.equal(out.a, torch.full((3,), 2.0))
    assert calls == []
    assert tprof._cuda_devices(out, set()) == set()


def test_device_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.device_trace(str(log_dir)) as prof:
        torch.arange(1000.0).sum()
    assert prof is not None
    path = log_dir / "trace.json"
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "traceEvents" in json.load(f)
