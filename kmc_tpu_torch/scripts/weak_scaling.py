#!/usr/bin/env python
"""Weak-scaling harness (port of the JAX package's
``scripts/weak_scaling.py``; BASELINE target: >= 85 % efficiency 1 -> N
workers).

    python -m kmc_tpu_torch.scripts.weak_scaling [--per-device 64] \\
        [--chunk 50] [--repeats 2] [--cpu] [--device {cuda,cpu}]

Holds replicas per device constant and measures ensemble throughput over
1, 2, 4, ... devices.  Trajectories are independent, so the only scaling
losses are the host's and the partitioning's.  The JAX script shards one
process's ensemble over a mesh; the port has no single-process
partitioner, so each size n runs n ranks (``parallel/launch.py``), one
card a rank joined by NCCL, up to the visible cards.  Rank p of n builds
the replicas p * m .. (p + 1) * m - 1 of ``init_ensemble(SimConfig(),
m * n, seed=0)`` (m = ``--per-device``), runs one warm-up chunk of the
eager ensemble step (where the kernels build), meets the other ranks at a
tiny all-reduce, and times ``--repeats`` chunks between two syncs of its
card.  The rate of a size is its replica-steps over the slowest rank's
window; nothing is gathered inside a window.

``--cpu`` runs gloo ranks on the CPU, sizes up to 8 (the JAX script's 8
virtual CPU devices), sharing the host's cores.  Prints {"weak_scaling":
[{"devices", "replicas", "replica_steps_per_s", "events_per_s",
"efficiency"}, ...], "device", "seconds"}: ``device`` is the card's
``nvidia-smi`` name and power limit, or "cpu".  Without ``--cpu`` or
``--device cpu`` and with no card it raises before it measures anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from kmc_tpu_torch.config import SimConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZES = (1, 2, 4, 8, 16, 32, 64)
CPU_DEVICES = 8
RANK_TIMEOUT = 1800.0


def rank_run(spec: str) -> None:
    """One rank of one size (started by ``run_size`` with the ``KMC_*``
    variables of ``parallel/launch.py``).  ``spec`` is the JSON of
    {"cfg", "per_device", "chunk", "repeats", "device", "out_dir",
    "save_state"}; the rank writes ``rank{p}.json`` with its timed
    seconds and, with ``save_state``, its final block as
    ``rank{p}.npz`` (the validation state file's leaves)."""
    import numpy as np

    from kmc_tpu_torch.parallel import distributed
    from kmc_tpu_torch.parallel.ensemble import (init_replicas,
                                                 make_ensemble_chunk)
    from kmc_tpu_torch.parallel.mesh import rank_device, world
    from kmc_tpu_torch.scripts.validate_vs_reference import state_arrays
    from kmc_tpu_torch.utils.profiling import sync

    s = json.loads(spec)
    n = int(os.environ["KMC_NUM_PROCESSES"])
    # the ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    distributed.initialize(device=s["device"])
    try:
        rank, size = world()
        dev = rank_device(s["device"])
        cfg = SimConfig.from_dict(s["cfg"])
        m = s["per_device"]
        state = init_replicas(cfg, range(rank * m, (rank + 1) * m), seed=0,
                              device=dev)
        chunk = make_ensemble_chunk(cfg, s["chunk"], device=dev)
        state, _ = chunk(state)                   # warm; kernels build
        # every rank starts its window after the others have warmed up
        distributed.all_hosts_mean(torch.ones(1, device=dev))
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(s["repeats"]):
            state, _ = chunk(state)
        sync(dev)
        dt = time.perf_counter() - t0
        with open(os.path.join(s["out_dir"], f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "size": size, "seconds": dt}, f)
        if s["save_state"]:
            np.savez(os.path.join(s["out_dir"], f"rank{rank}.npz"),
                     **state_arrays(state))
    finally:
        distributed.shutdown()


def run_size(n: int, cfg: SimConfig, per_device: int, chunk: int,
             repeats: int, device: str, out_dir: str,
             save_state: bool = False) -> float:
    """Run size ``n`` (n ranks); returns the slowest rank's timed
    seconds.  The ranks' files land in ``out_dir``."""
    from kmc_tpu_torch.parallel.launch import spawn

    os.makedirs(out_dir, exist_ok=True)
    spec = json.dumps({"cfg": cfg.to_dict(), "per_device": per_device,
                       "chunk": chunk, "repeats": repeats, "device": device,
                       "out_dir": out_dir, "save_state": save_state})
    code = ("from kmc_tpu_torch.scripts.weak_scaling import rank_run; "
            f"rank_run({spec!r})")
    spawn(n, ["-c", code], timeout=RANK_TIMEOUT, cwd=ROOT)
    secs = []
    for p in range(n):
        with open(os.path.join(out_dir, f"rank{p}.json")) as f:
            secs.append(json.load(f)["seconds"])
    return max(secs)


def run_sizes(sizes, per_device: int, chunk: int, repeats: int,
              device: str, cfg: SimConfig | None = None, work_dir=None,
              save_state: bool = False, log=None) -> list[dict]:
    """The rows of the JAX script, one a size of ``sizes``; each size's
    rank files in ``work_dir/n{size}`` (a temporary directory by
    default)."""
    from kmc_tpu_torch.utils.profiling import events_per_step

    cfg = cfg or SimConfig()
    log = log or sys.stderr
    results, base_rate = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for n in sizes:
            reps = per_device * n
            dt = run_size(n, cfg, per_device, chunk, repeats, device,
                          os.path.join(work_dir or tmp, f"n{n}"),
                          save_state)
            rate = repeats * chunk * reps / dt
            if base_rate is None:
                base_rate = rate
            eff = rate / (base_rate * n)
            results.append({
                "devices": n,
                "replicas": reps,
                "replica_steps_per_s": rate,
                "events_per_s": rate * events_per_step(cfg),
                "efficiency": eff,
            })
            print(f"# {n} devices: {rate:,.0f} replica-steps/s, "
                  f"eff {eff:.2%}", file=log, flush=True)
    return results


def main(argv=None) -> int:
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device

    ap = argparse.ArgumentParser(prog="kmc_tpu_torch.scripts.weak_scaling",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--per-device", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU, up to 8 (implies "
                         "--device cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one card a rank (raises without a card)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = "cpu" if args.cpu else args.device
    dev = resolve_device(device)                  # no card: raise here
    label = device_label(dev)
    print(f"# device: {label}", file=sys.stderr, flush=True)
    n_dev = CPU_DEVICES if dev.type == "cpu" else torch.cuda.device_count()
    sizes = [n for n in SIZES if n <= n_dev]
    results = run_sizes(sizes, args.per_device, args.chunk, args.repeats,
                        device)
    print(json.dumps({"weak_scaling": results, "device": label,
                      "seconds": time.perf_counter() - t0}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
