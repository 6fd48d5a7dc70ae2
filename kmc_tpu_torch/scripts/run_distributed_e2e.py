#!/usr/bin/env python
"""The multi-process production loop end to end, killed and resumed (port
of the JAX package's ``scripts/run_distributed_e2e.py``).

    python -m kmc_tpu_torch.scripts.run_distributed_e2e [--nproc 4] \\
        [--replicas-per-host 16] [--outputs 4] [--out-every 200] \\
        [--device cpu] [--out FILE]

Starts ``--nproc`` ranks of ``kmc_tpu_torch.scripts.distributed_worker
--e2e-out-dir`` (``parallel/launch.py``: one card a rank joined by NCCL,
or gloo processes with ``--device cpu``), which run the production loop
for ``--outputs`` intervals; then starts them again with ``--resume``,
from the shard files alone, as after the loss of the group.  The time
axis of ``bond_ens.dat`` must go on without a gap: ``1 + 2 x outputs``
lines, the times strictly increasing at one pace.  The ranks' timing is
aggregated under the JAX script's keys, plus ``device`` (the card's
``nvidia-smi`` name and power limit, or "cpu") and ``seconds``.  A failed
check exits 1 with a message; with ``--device cuda`` and no card it
raises before anything is written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "kmc_tpu_torch.scripts.distributed_worker"
RANK_TIMEOUT = 900.0


class CheckFailed(Exception):
    pass


def spawn(nproc, workdir, extra, device):
    """``nproc`` ranks of the worker's production loop into ``workdir``;
    a rank that fails ends the phase, and 10 s later every rank."""
    from kmc_tpu_torch.parallel.launch import spawn as launch

    def argv(rank, port):
        return ["-m", WORKER, "--pid", str(rank), "--nproc", str(nproc),
                "--port", str(port), "--out",
                os.path.join(workdir, "unused"), "--e2e-out-dir", workdir,
                "--device", device, *extra]

    try:
        return launch(nproc, argv, timeout=RANK_TIMEOUT, cwd=ROOT)
    except RuntimeError as e:
        raise CheckFailed(str(e)) from None


def read_rows(workdir):
    with open(os.path.join(workdir, "bond_ens.dat")) as f:
        return f.readlines()


def run(args) -> dict:
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device

    t0 = time.perf_counter()
    label = device_label(resolve_device(args.device))
    os.makedirs(args.workdir, exist_ok=True)
    for f in os.listdir(args.workdir):
        os.remove(os.path.join(args.workdir, f))
    base = ["--replicas-per-host", str(args.replicas_per_host),
            "--outputs", str(args.outputs),
            "--out-every", str(args.out_every)]

    # ---- phase 1: a fresh run ----
    spawn(args.nproc, args.workdir, base, args.device)
    rows = read_rows(args.workdir)
    if len(rows) != 1 + args.outputs:
        raise CheckFailed(f"the fresh run wrote {len(rows)} lines of "
                          f"bond_ens.dat, not {1 + args.outputs}")

    # ---- phase 2: resume from the shard files, as after a lost group ----
    spawn(args.nproc, args.workdir, base + ["--resume"], args.device)
    rows = read_rows(args.workdir)
    if len(rows) != 1 + 2 * args.outputs:
        raise CheckFailed(f"after the resume bond_ens.dat has {len(rows)} "
                          f"lines, not {1 + 2 * args.outputs}")
    t = [float(r.split()[0]) for r in rows[1:]]
    dt = np.diff(t)
    if not (np.all(dt > 0) and np.allclose(dt, dt[0])):
        raise CheckFailed(f"the time axis does not go on without a gap "
                          f"across the resume: {t}")

    # ---- the ranks' timing ----
    timings = []
    for p in range(args.nproc):
        with open(os.path.join(args.workdir, f"timing.pid{p}.json")) as f:
            timings.append(json.load(f))
    how = ("CPU processes joined by gloo" if args.device == "cpu" else
           "one card a rank, joined by NCCL")
    return {
        "nproc": args.nproc,
        "replicas_global": timings[0]["replicas_global"],
        "outputs_per_phase": args.outputs,
        "out_every": args.out_every,
        "resume_time_axis_seamless": True,
        "per_process": timings,
        "machinery_s_per_interval": {
            "collect_mean": float(np.mean(
                [t["collect_s_per_interval"] for t in timings])),
            "checkpoint_mean": float(np.mean(
                [t["checkpoint_s_per_interval"] for t in timings])),
            "step_mean": float(np.mean(
                [t["step_s_per_interval"] for t in timings])),
        },
        "note": f"{args.nproc} ranks on {label} ({how}); the timing is the "
                f"resumed run's, each rank's clock read after its device "
                f"finished: the collect (gather to rank 0 and the row) and "
                f"shard-checkpoint seconds are the machinery an output "
                f"interval pays beside the step.",
        "device": label,
        "seconds": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kmc_tpu_torch.scripts.run_distributed_e2e", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--replicas-per-host", type=int, default=16)
    ap.add_argument("--outputs", type=int, default=4)
    ap.add_argument("--out-every", type=int, default=200)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "dist_e2e"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one card a rank (raises without a card); "
                         "cpu: gloo processes")
    args = ap.parse_args(argv)
    try:
        agg = run(args)
    except CheckFailed as e:
        print(f"run_distributed_e2e: {e}", file=sys.stderr)
        return 1
    txt = json.dumps(agg, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
