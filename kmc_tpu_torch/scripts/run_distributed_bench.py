#!/usr/bin/env python
"""Multi-process ensemble throughput, one rank against two (port of the
JAX package's ``scripts/run_distributed_bench.py``).

    python -m kmc_tpu_torch.scripts.run_distributed_bench \\
        [--replicas-per-host 16] [--steps 50] [--repeats 4] [--out FILE] \\
        [--device {cuda,cpu}]

Runs ``kmc_tpu_torch.scripts.distributed_worker --bench-repeats`` on one
rank, then on two (``parallel/launch.py``, a free localhost port each
time), with the same replicas a rank, and reports both ranks' ``bench``
statistics and the ratio of their total rates.  With the default
``--device cuda`` each rank owns a card (NCCL; two cards needed) and the
trajectories exchange nothing while timed, so the ratio is compute
scaling less the group's machinery.  With ``--device cpu`` the two gloo
ranks share this host's cores, so the ratio measures the machinery's
overhead, not compute scaling.  The report has the JAX script's keys
(``caveat``, ``one_process``, ``two_process``, ``two_vs_one_total_rate``,
``real_slice_recipe``) plus ``device`` (the card's ``nvidia-smi`` name and
power limit, or "cpu") and ``seconds``.  With ``--device cuda`` and no
card it raises before it runs or writes anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "kmc_tpu_torch.scripts.distributed_worker"
RANK_TIMEOUT = 1800.0


def run(nproc, reps_per_host, steps, repeats, device, workdir) -> dict:
    """``nproc`` ranks of the worker's default mode with ``--bench-
    repeats``; rank 0's statistics.  A rank that fails raises."""
    from kmc_tpu_torch.parallel.launch import spawn

    out = os.path.join(workdir, f"distbench_p{nproc}.json")

    def argv(rank, port):
        return ["-m", WORKER, "--pid", str(rank), "--nproc", str(nproc),
                "--port", str(port), "--out", out, "--replicas-per-host",
                str(reps_per_host), "--steps", str(steps),
                "--bench-repeats", str(repeats), "--device", device]

    spawn(nproc, argv, timeout=RANK_TIMEOUT, cwd=ROOT)
    with open(out) as f:
        return json.load(f)


def caveat(device: str, label: str) -> str:
    if device == "cpu":
        return ("localhost, 2 gloo processes sharing this host's CPU cores: "
                "measures distributed-machinery overhead, not compute "
                "scaling")
    return (f"one rank a card ({label}), joined by NCCL: each rank owns its "
            f"card and its host process, and the trajectories exchange "
            f"nothing while timed, so the ratio is compute scaling less the "
            f"group's machinery")


def main(argv=None) -> int:
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device

    ap = argparse.ArgumentParser(
        prog="kmc_tpu_torch.scripts.run_distributed_bench",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--replicas-per-host", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one card a rank, two cards (raises without "
                         "them); cpu: gloo processes")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev = resolve_device(args.device)             # no card: raise here
    if dev.type == "cuda" and torch.cuda.device_count() < 2:
        raise RuntimeError("two ranks on cuda need two cards, one a rank; "
                           f"{torch.cuda.device_count()} visible")
    label = device_label(dev)

    with tempfile.TemporaryDirectory() as tmp:
        one = run(1, args.replicas_per_host, args.steps, args.repeats,
                  args.device, tmp)
        two = run(2, args.replicas_per_host, args.steps, args.repeats,
                  args.device, tmp)
    r1 = one["bench"]["replica_steps_per_s"]
    r2 = two["bench"]["replica_steps_per_s"]
    report = {
        "caveat": caveat(args.device, label),
        "one_process": one["bench"],
        "two_process": two["bench"],
        "two_vs_one_total_rate": r2 / r1,
        "real_slice_recipe": (
            "per rank i of N, one card a rank on one host: python -m "
            "kmc_tpu_torch.scripts.distributed_worker --pid i --nproc N "
            "--port <free port> --out stats.json --replicas-per-host 512 "
            "--steps 5000 --bench-repeats 3 (NCCL; --device cpu runs gloo "
            "ranks instead)"),
        "device": label,
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
