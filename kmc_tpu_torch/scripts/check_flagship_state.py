#!/usr/bin/env python
"""Run the race-detection invariants (utils/checks.py) over EVERY replica
of a persisted validation ensemble state (port of the JAX package's
``scripts/check_flagship_state.py``): topology mutual, no overlap across
clusters, counters consistent.  The state file is the validation driver's
(either package's; ``validate_vs_reference.py --state-file``), read with
the driver's ``run_config()``.  The checks run on ``--device`` (the card
unless ``cpu`` is given) in batches of ``BATCH`` replicas.

Usage: python -m kmc_tpu_torch.scripts.check_flagship_state \\
           --state validation_torch/state.npz [--out INVARIANTS.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kmc_tpu_torch.scripts import validate_vs_reference as vv

BATCH = 64      # replicas checked at once


def check_state(path: str, device=None, batch: int = BATCH) -> dict:
    """The report of the three checks over every replica of ``path``."""
    from kmc_tpu_torch.state import resolve_device, take_replicas
    from kmc_tpu_torch.utils.checks import (
        counters_consistent, no_cross_cluster_overlap, topology_mutual)

    dev = resolve_device(device)
    cfg = vv.run_config()
    with np.load(path) as z:
        k_done = int(z["k_done"])
        state = vv.load_state(z, "cpu")
    reps = state.step.shape[0]
    oks = []
    for i in range(0, reps, batch):
        idx = torch.arange(i, min(i + batch, reps))
        st = take_replicas(state, idx)
        st = type(st)(*(x.to(dev) for x in st))
        oks.append(torch.stack([topology_mutual(st, cfg),
                                no_cross_cluster_overlap(st, cfg),
                                counters_consistent(st, cfg)], 1).cpu())
    ok = torch.cat(oks).numpy()                      # [reps, 3] bools
    return {
        "state": path,
        "k_done_outputs": k_done,
        "steps_per_replica": int(state.step.max()) - 1,
        "replicas": int(reps),
        "topology_mutual_all": bool(ok[:, 0].all()),
        "no_cross_cluster_overlap_all": bool(ok[:, 1].all()),
        "counters_consistent_all": bool(ok[:, 2].all()),
        "failing_replicas": [int(i) for i in np.where(~ok.all(1))[0]],
        "ok": bool(ok.all()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--state", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the checks run; cuda raises without a card")
    args = ap.parse_args(argv)
    report = check_state(args.state, args.device)
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
