#!/usr/bin/env python
"""Measure the residual-overlap rate of the UNROLLED collision cleanup
(port of the JAX package's ``scripts/measure_residual_overlap.py``): with
sweep_exact_cleanup=False, a revert chain deeper than 3 could commit a
step with a cross-cluster overlap.  diffuse(diag=True) flags exactly that
event (one extra fixpoint probe of the cleanup body); this script
accumulates the flag over a large replica-ensemble run at the reference
config and at a 4x-denser variant.

Each step is ``step_fn_diag(..., batched=True)`` on all replicas at once,
which on the card runs K1 on every replica every step.  The chunk's count
stays on the device; the host reads it once a chunk.  The run takes place
on the card unless ``--device cpu`` is given; without a card the default
raises before anything is written.  Beyond the JAX script's report:
``device`` (the card's ``nvidia-smi`` name and power limit, or "cpu") and
``seconds`` (this command's wall time).

  python -m kmc_tpu_torch.scripts.measure_residual_overlap [--replicas 256]
      [--chunks 20] [--chunk-steps 500] [--dense] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from kmc_tpu_torch.scripts.validate_vs_reference import device_label

DENSE_BOX = 2886.5      # half the reference box in x and y


def run_config(dense: bool = False):
    """The measured config: ``SimConfig(sweep_exact_cleanup=False)``, with
    ``dense`` half the box in x/y (4x area density)."""
    from kmc_tpu_torch.config import SimConfig

    kw = dict(cell_range_x=DENSE_BOX, cell_range_y=DENSE_BOX) if dense else {}
    return SimConfig(sweep_exact_cleanup=False, **kw)


def measure(cfg, replicas: int, chunks: int, chunk_steps: int,
            seed: int = 0, device=None, on_chunk=None):
    """Run ``chunks`` chunks of ``chunk_steps`` batched diagnostic steps
    from ``init_ensemble(cfg, replicas, seed)``; returns (per-chunk
    residual-overlap counts, final state).  ``on_chunk(k, total)`` fires
    after chunk k with the cumulative count."""
    from kmc_tpu_torch.engine.step import step_fn_diag
    from kmc_tpu_torch.parallel.ensemble import init_ensemble
    from kmc_tpu_torch.state import resolve_device

    dev = resolve_device(device)
    state = init_ensemble(cfg, replicas, seed=seed, device=dev)
    counts = []
    for k in range(chunks):
        res = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(chunk_steps):
            state, _, dg = step_fn_diag(state, cfg, dev, batched=True)
            res += dg["residual_overlap"].sum()
        counts.append(int(res))
        if on_chunk is not None:
            on_chunk(k, sum(counts))
    return counts, state


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replicas", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--chunk-steps", type=int, default=500)
    ap.add_argument("--dense", action="store_true",
                    help="half the box in x/y (4x area density)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ensemble runs; cuda raises without a "
                         "card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def progress(k, total):
        print(f"# chunk {k + 1}/{args.chunks}: cumulative residual "
              f"overlaps = {total}", file=sys.stderr, flush=True)

    counts, _ = measure(run_config(args.dense), args.replicas, args.chunks,
                        args.chunk_steps, args.seed, args.device, progress)
    total = sum(counts)
    steps = args.replicas * args.chunks * args.chunk_steps
    report = {
        "config": "dense(2886.5^2)" if args.dense else "reference",
        "replicas": args.replicas,
        "replica_steps": steps,
        "residual_overlap_steps": total,
        "rate": total / steps,
        "device": device_label(args.device),
        "seconds": time.perf_counter() - t0,
    }
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
