#!/usr/bin/env python
"""Replica-scaling curve of the lazy ensemble step on one card (port of
the JAX package's ``scripts/replica_scaling.py``).

    python -m kmc_tpu_torch.scripts.replica_scaling \\
        [--counts 64,512,4096,16384] [--chunk 50] [--out FILE] \\
        [--device {cuda,cpu}]

For each replica count: ``init_ensemble(SimConfig(), r, seed=0)``, the
lazy chunk of ``--chunk`` steps at k_align = max(r // 8, 32), one warm-up
chunk, then 3 timed chunks (2 above 4,096 replicas) between two syncs of
the card; then 20 calls of a one-step chunk, each followed by a sync.

* ``ms_per_step_inscan``: a step inside a chunk.  The JAX package runs
  the chunk as one compiled scan with no host round trip a step; the
  port's chunk is a Python loop that issues each step's kernels with no
  sync of its own, so the card's queue stays full and this is the step as
  the card runs it back to back.
* ``ms_per_dispatch_total``: one one-step chunk with its sync: a step
  issued and waited for on its own.
* ``ms_dispatch_overhead``: the difference (floored at 0), the host cost a
  step pays when every step ends in a sync: in the port, one drain of the
  card's queue and one chunk's set-up, not an XLA dispatch.

Each row, printed as a JSON line and written as a list with ``--out``,
has the JAX script's keys (``replicas``, ``ms_per_step_inscan``,
``replica_steps_per_s``, ``events_per_s``, ``ms_per_dispatch_total``,
``ms_dispatch_overhead``) plus ``device`` (the card's ``nvidia-smi``
name and power limit, or "cpu") and ``seconds`` (the count's wall time).
A ``#`` line on stderr gives each count's peak device memory
(``torch.cuda.max_memory_allocated()``).  A count that does not fit on
the card fails the run, as it does the JAX script.  With the default
``--device cuda`` and no card it raises before it measures or writes
anything.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.utils.profiling import events_per_step, sync

DISPATCH_CALLS = 20


def measure(cfg: SimConfig, r: int, chunk_steps: int, device,
            label: str) -> dict:
    """One row of the curve: ``r`` replicas on ``device``."""
    from kmc_tpu_torch.parallel.ensemble import (default_k_align,
                                                 init_ensemble,
                                                 make_lazy_ensemble_chunk)

    start = time.perf_counter()
    k = default_k_align(r)
    state = init_ensemble(cfg, r, seed=0, device=device)
    sync(device)
    chunk = make_lazy_ensemble_chunk(cfg, chunk_steps, k_align=k,
                                     device=device)
    state, _ = chunk(state)
    sync(device)                                   # build + warm
    reps = 3 if r <= 4096 else 2
    t0 = time.perf_counter()
    for _ in range(reps):
        state, _ = chunk(state)
    sync(device)
    dt = (time.perf_counter() - t0) / reps
    ms_step = dt / chunk_steps * 1000.0

    # per-dispatch overhead: a 1-step chunk with one full issue + sync;
    # subtract the in-chunk step time
    one = make_lazy_ensemble_chunk(cfg, 1, k_align=k, device=device)
    state, _ = one(state)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(DISPATCH_CALLS):
        state, _ = one(state)
        sync(device)
    d1 = (time.perf_counter() - t0) / DISPATCH_CALLS * 1000.0
    return {
        "replicas": r,
        "ms_per_step_inscan": round(ms_step, 3),
        "replica_steps_per_s": round(r * chunk_steps / dt),
        "events_per_s": r * chunk_steps * events_per_step(cfg) / dt,
        "ms_per_dispatch_total": round(d1, 3),
        "ms_dispatch_overhead": round(max(d1 - ms_step, 0.0), 3),
        "device": label,
        "seconds": time.perf_counter() - start,
    }


def main(argv=None) -> int:
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device

    ap = argparse.ArgumentParser(
        prog="kmc_tpu_torch.scripts.replica_scaling", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--counts", default="64,512,4096,16384")
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda raises without a card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)         # no card: raise here
    label = device_label(dev)
    print(f"# device: {label}", file=sys.stderr, flush=True)

    cfg = SimConfig()
    rows = []
    for r in [int(x) for x in args.counts.split(",")]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        row = measure(cfg, r, args.chunk, dev, label)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"# {r} replicas: peak device memory {peak} B "
                  f"({peak / 2**30:.2f} GiB) of "
                  f"{torch.cuda.get_device_properties(dev).total_memory} B",
                  file=sys.stderr, flush=True)
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
