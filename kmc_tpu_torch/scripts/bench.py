#!/usr/bin/env python
"""Benchmark: ensemble KMC event-attempt throughput on one card (port of
the JAX package's ``bench.py``).

    python -m kmc_tpu_torch.scripts.bench [--device {cuda,cpu}]

Reads ``KMC_BENCH_REPLICAS`` (512), ``KMC_BENCH_CHUNK`` (50),
``KMC_BENCH_REPEATS`` (3) and ``KMC_BENCH_MODE`` (``lazy``, or ``eager``)
and prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline", "device", "seconds"}; ``device`` is the card's
``nvidia-smi`` name and power limit (or "cpu"), ``seconds`` the whole
run's.  Its ``#`` notes go to stderr.

Definition of an event attempt (BASELINE.md "event attempts per step",
from the reference workload main.cpp:577, 1877-2058): per replica per
timestep, n molecule-move attempts + n_a * n_b * 3 trans-association pair
tests + 2 * n_a * (n_a - 1) cis-association pair tests
(``utils/profiling.events_per_step``, 67,400 at ``SimConfig()``).  The
reference performs exactly these attempts serially on one CPU core;
``vs_baseline`` is the measured attempts/s divided by the single-core
attempts/s of the compiled reference in the repository's
``BASELINE_MEASURED.json``.

The run: ``init_ensemble(SimConfig(), REPLICAS, seed=0)``, one warm-up
chunk of CHUNK steps (where the kernels build at first use), then REPEATS
chunks timed on the host clock between two ``torch.cuda.synchronize()``
calls, with no host sync of the bench's own inside the window.  The lazy
chunk aligns the max(REPLICAS // 8, 32) dirtiest replicas a step (K1 on
the card); the eager chunk aligns all of them.  With the default
``--device cuda`` and no card it raises before it measures or prints
anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.utils.profiling import sync

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASELINE = os.path.join(ROOT, "BASELINE_MEASURED.json")


def settings() -> dict:
    """The bench's sizes from its environment variables."""
    return {
        "replicas": int(os.environ.get("KMC_BENCH_REPLICAS", "512")),
        "chunk": int(os.environ.get("KMC_BENCH_CHUNK", "50")),
        "repeats": int(os.environ.get("KMC_BENCH_REPEATS", "3")),
        # "lazy" = event-driven alignment (align only the k = replicas/8
        # dirtiest replicas per step); "eager" aligns every replica
        "mode": os.environ.get("KMC_BENCH_MODE", "lazy"),
    }


def measure(replicas: int, chunk: int, repeats: int, mode: str, device,
            mark=lambda what: None):
    """(replica-steps timed, seconds, final state) of the bench's run on
    ``device``; ``mark(what)`` is called after each stage."""
    from kmc_tpu_torch.parallel.ensemble import (default_k_align,
                                                 init_ensemble,
                                                 make_ensemble_chunk,
                                                 make_lazy_ensemble_chunk)

    cfg = SimConfig()  # reference scale: 150 receptors + 50 ligands
    state = init_ensemble(cfg, replicas, seed=0, device=device)
    sync(device)
    mark("init_ensemble done")
    # the JAX bench donates the state's buffers to each chunk; the port's
    # chunk is eager PyTorch and frees a step's inputs as it goes
    if mode == "lazy":
        run = make_lazy_ensemble_chunk(cfg, chunk,
                                       k_align=default_k_align(replicas),
                                       device=device)
    else:
        run = make_ensemble_chunk(cfg, chunk, device=device)

    state, _ = run(state)          # warm-up; the kernels build here
    sync(device)
    mark("warmup chunk done")

    t0 = time.perf_counter()
    for _ in range(repeats):
        state, _ = run(state)
    sync(device)
    dt = time.perf_counter() - t0
    return repeats * chunk * replicas, dt, state


def vs_baseline(events_per_s: float):
    """``events_per_s`` over the reference's measured single-core rate, or
    None without ``BASELINE_MEASURED.json``."""
    if not os.path.exists(BASELINE):
        return None
    with open(BASELINE) as f:
        ref = json.load(f).get("reference_events_per_s")
    return events_per_s / ref if ref else None


def main(argv=None, **sizes) -> int:
    """The bench; ``sizes`` (replicas, chunk, repeats, mode) override the
    environment's values."""
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device
    from kmc_tpu_torch.utils.profiling import events_per_step

    ap = argparse.ArgumentParser(prog="kmc_tpu_torch.scripts.bench",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda raises without a card")
    args = ap.parse_args(argv)
    s = {**settings(), **sizes}
    t_start = time.perf_counter()
    dev = resolve_device(args.device)      # no card: raise here

    def mark(what):
        print(f"# t+{time.perf_counter() - t_start:7.1f}s  {what}",
              file=sys.stderr, flush=True)

    mark("imports done")
    label = device_label(dev)
    mark(f"backend up: {label}")

    steps, dt, _ = measure(s["replicas"], s["chunk"], s["repeats"],
                           s["mode"], dev, mark)
    events_per_s = steps * events_per_step(SimConfig()) / dt
    print(json.dumps({
        "metric": "kmc_event_attempts_per_s",
        "value": events_per_s,
        "unit": "events/s/chip",
        "vs_baseline": vs_baseline(events_per_s),
        "device": label,
        "seconds": time.perf_counter() - t_start,
    }), flush=True)
    print(
        f"# mode={s['mode']} {s['replicas']} replicas x "
        f"{s['repeats'] * s['chunk']} steps in {dt:.2f}s "
        f"({steps / dt:,.0f} replica-steps/s) on {label}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
