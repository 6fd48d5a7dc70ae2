#!/usr/bin/env python
"""Early-horizon cluster_size band test from SAVED histograms (port of the
JAX package's ``scripts/early_cluster_size_check.py``).

The validation driver's state file (``validate_vs_reference.py
--state-file``, either package's) persists per-replica ligand-seeded
cluster-size histograms h[row, replica, s] (s = 1..16, s >= 16 binned).
The reference's cluster_size column (main.cpp:976-977, :2200-2202) is

    cluster_size = sum_{clusters with size > 1} size / #such clusters

which is EXACTLY sum(s * h[s], s >= 2) / sum(h[s], s >= 2) whenever the
overflow bin h[16] is empty.  Rows where ANY replica has overflow mass are
excluded (reported), so every tested row is exact, not approximate.

The check is numpy on the host, whatever the machine.  Beyond the JAX
script's report: ``seconds`` (this command's wall time) and ``device``
(the ``nvidia-smi`` name and power limit of the machine's card, or "cpu"
where there is none).

Usage: python -m kmc_tpu_torch.scripts.early_cluster_size_check \\
    --state validation_torch/state.npz \\
    --ref-bond ref_data/refgolden_bond.dat ref_data/refgolden2_bond.dat \\
    --max-rows 22 --out EARLY_CLUSTER_SIZE.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kmc_tpu_torch.scripts.validate_vs_reference import (device_label,
                                                         read_bond_dat)


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--state", required=True)
    ap.add_argument("--ref-bond", nargs="+", required=True)
    ap.add_argument("--max-rows", type=int, default=440,
                    help="test only rows the live 7-column validation "
                         "does NOT already cover")
    ap.add_argument("--quantile", type=float, default=0.995)
    ap.add_argument("--min-coverage", type=float, default=0.9)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    with np.load(args.state) as z:
        h = z["hists"].astype(np.float64)          # [rows, reps, 17]
    n = min(len(h), args.max_rows)
    h = h[:n]
    s = np.arange(h.shape[2])
    big = h[:, :, 2:]                              # clusters of size > 1
    num = big.sum(axis=2)                          # [rows, reps]
    tot = (big * s[2:]).sum(axis=2)
    cs = np.where(num > 0, tot / np.maximum(num, 1), 0.0)

    # exactness: a row is testable iff NO replica has overflow mass
    overflow = h[:, :, -1].sum(axis=1) > 0         # [rows]
    exact = ~overflow
    q = args.quantile
    report = {"state": args.state, "rows_considered": int(n),
              "rows_exact": int(exact.sum()),
              "rows_excluded_overflow": int(overflow.sum()),
              "quantile": q, "runs": []}
    ok_all = True
    for path in args.ref_bond:
        ref = read_bond_dat(path)[:n]
        m = exact[: len(ref)]
        refv = ref[:, 5][m]
        samp = cs[: len(ref)][m]
        lo = np.quantile(samp, 1 - q, axis=1)
        hi = np.quantile(samp, q, axis=1)
        inside = (refv >= lo - 1e-9) & (refv <= hi + 1e-9)
        cov = float(np.mean(inside)) if len(inside) else None
        ok = cov is not None and cov >= args.min_coverage
        ok_all &= ok
        report["runs"].append({
            "ref": path, "n_tested": int(m.sum()), "coverage": cov,
            "mean_signed_err_ref_minus_ours": float(
                np.mean(refv - samp.mean(1))) if len(refv) else None,
            "ok": bool(ok),
        })
    report["ok"] = bool(ok_all)
    report["device"] = device_label(
        "cuda" if torch.cuda.is_available() else "cpu")
    report["seconds"] = time.perf_counter() - t0
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
