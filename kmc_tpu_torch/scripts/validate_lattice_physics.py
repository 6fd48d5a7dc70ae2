#!/usr/bin/env python
"""BASELINE config-2/3 validation of the lattice engine at REFERENCE-mapped
physics (port of the JAX package's ``scripts/validate_lattice_physics.py``;
the mapping is ``kmc_tpu_torch/lattice/mapping.py``).

Modes:
  msd   — 512x512 grid, 10k particles (config 2), hop probability mapped
          from the reference receptor D: measured lattice MSD slope (A^2/
          step) vs the analytic reference value 2*D*dt/9 and, if a
          diffusion-only reference run is given (--ref-gro from a rates=0
          build of main.cpp), vs the reference binary's measured receptor
          MSD slope.
  rates — early-time merge/split event rates at mapped mono-cis values vs
          the analytic per-pair-step probabilities (module docstring of
          mapping.py), fixed-dt AND rejection-free engines.

The runs take place on the card unless ``--device cpu`` is given; without
a card the default raises before anything is written.  The fixed-dt
chunks are K3 (``ops/lattice.py:make_pallas_lattice_chunk``) on the card
and the plain step (``lattice/step.py:make_lattice_chunk``) on the CPU,
bitwise equal; the rejection-free ``run_until`` is plain PyTorch on
either.  Beyond the JAX script's report: ``kernel`` ("K3" or "plain"),
``device`` (the card's ``nvidia-smi`` name and power limit, or "cpu") and
``seconds`` (this command's wall time).

Usage:
  python -m kmc_tpu_torch.scripts.validate_lattice_physics msd \\
      [--ref-gro test.gro] [--steps 2000] [--out LATTICE_VALIDATION.json]
  python -m kmc_tpu_torch.scripts.validate_lattice_physics rates [--out ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from kmc_tpu_torch.scripts.validate_vs_reference import (device_label,
                                                         read_gro_centers,
                                                         unwrap)


def receptor_msd_slope_from_gro(path, n_a, n_b, box_xy, dt):
    """Receptor-only MSD slope (A^2 per step) from a reference test.gro."""
    t, frames = read_gro_centers(path, n_a, n_b)
    a = frames[:, :n_a]                           # receptors only
    un = unwrap(a, box_xy)
    disp = un - un[0]
    m = np.mean(np.sum(disp**2, axis=-1), axis=1)
    tt = (t - t[0]) / dt                          # steps
    return float(np.polyfit(tt[1:], m[1:], 1)[0]), len(t)


def _fixed_dt_chunk(dev):
    """(make_chunk, kernel name) of the fixed-dt engine on ``dev``: K3 on
    the card, the plain step on the CPU (the lattice CLI's choice)."""
    if dev.type == "cuda":
        from kmc_tpu_torch.ops.lattice import make_pallas_lattice_chunk

        return make_pallas_lattice_chunk, "K3"
    from kmc_tpu_torch.lattice.step import make_lattice_chunk

    return make_lattice_chunk, "plain"


def cmd_msd(args):
    from kmc_tpu_torch.config import SimConfig
    from kmc_tpu_torch.lattice.grid import init_lattice, msd
    from kmc_tpu_torch.lattice.mapping import (msd_per_step_A2,
                                               reference_lattice_config)
    from kmc_tpu_torch.state import resolve_device

    dev = resolve_device(args.device)
    make_chunk, kernel = _fixed_dt_chunk(dev)
    cfg = SimConfig()
    spacing = args.spacing
    lcfg = reference_lattice_config(cfg, spacing=spacing, species="receptor",
                                    reaction="mono_cis", height=512,
                                    width=512)
    lcfg = lcfg.replace(ass_prob=0.0, diss_prob=0.0)   # diffusion only
    st = init_lattice(lcfg, seed=args.seed, n_particles=10_000, device=dev)
    st = make_chunk(lcfg, args.steps)(st)

    measured = float(msd(st)) * spacing**2 / args.steps
    analytic = msd_per_step_A2(cfg, "receptor")
    report = {
        "grid": [512, 512],
        "particles": 10_000,
        "steps": args.steps,
        "spacing_A": spacing,
        "hop_prob": lcfg.hop_prob,
        "lattice_msd_A2_per_step": measured,
        "analytic_ref_msd_A2_per_step": analytic,
        "lattice_vs_analytic": measured / analytic,
    }
    if args.ref_gro and os.path.exists(args.ref_gro):
        slope, n_frames = receptor_msd_slope_from_gro(
            args.ref_gro, cfg.n_a, cfg.n_b,
            (cfg.cell_range_x, cfg.cell_range_y), cfg.time_step,
        )
        report["ref_binary_msd_A2_per_step"] = slope
        report["ref_binary_frames"] = n_frames
        report["lattice_vs_ref_binary"] = measured / slope
    ok = abs(report["lattice_vs_analytic"] - 1.0) < 0.1
    if "lattice_vs_ref_binary" in report:
        ok &= abs(report["lattice_vs_ref_binary"] - 1.0) < 0.15
    report["ok"] = bool(ok)
    report["kernel"] = kernel
    return report


def cmd_rates(args):
    from kmc_tpu_torch.config import SimConfig
    from kmc_tpu_torch.lattice.grid import init_lattice, species_histogram
    from kmc_tpu_torch.lattice.mapping import reference_lattice_config
    from kmc_tpu_torch.lattice.rejection_free import run_until
    from kmc_tpu_torch.state import resolve_device

    dev = resolve_device(args.device)
    make_chunk, kernel = _fixed_dt_chunk(dev)
    cfg = SimConfig()
    # mapped mono-cis rates; dense grid so pair contacts are plentiful
    lcfg = reference_lattice_config(cfg, spacing=args.spacing,
                                    reaction="mono_cis", height=128,
                                    width=128, density=0.3)
    st0 = init_lattice(lcfg, seed=args.seed, device=dev)

    # expected merges per step ~ (# ordered adjacent occupied pairs) *
    # ass_prob/8; measure adjacency on the initial grid and compare the
    # short-horizon dimer production of both engines against it
    occ = st0.grid.cpu().numpy() > 0
    pairs = sum(
        int(np.sum(occ & np.roll(occ, s, axis=ax)))
        for ax in (0, 1) for s in (1, -1)
    )
    exp_merges_per_step = pairs * lcfg.ass_prob / 8.0

    steps = args.steps
    fd = make_chunk(lcfg, steps)(st0)
    hist_fd = species_histogram(fd).cpu().numpy()

    rf = run_until(st0, lcfg, float(steps), chunk=64)
    hist_rf = species_histogram(rf).cpu().numpy()

    # very-early-time check against the t0 analytic rate (adjacency barely
    # depleted over `early` steps)
    early = 50
    dimers_early = int(species_histogram(make_chunk(lcfg, early)(st0))[2])

    report = {
        "mapped_ass_prob": lcfg.ass_prob,
        "mapped_diss_prob": lcfg.diss_prob,
        "adjacent_pairs_t0": pairs,
        "expected_merges_per_step_t0": exp_merges_per_step,
        "steps": steps,
        "early_fd_per_step": dimers_early / early,
        "hist_fixed_dt": hist_fd[:6].tolist(),
        "hist_rf_matched_time": hist_rf[:6].tolist(),
        "rf_time": float(rf.time),
        "rf_events": int(rf.step),
    }
    # early production near the analytic t0 rate; full-horizon oligomer
    # histograms of the two engines agree at matched simulated time
    ok = 0.6 < report["early_fd_per_step"] / exp_merges_per_step < 1.15
    for s in (1, 2):
        ok &= abs(hist_fd[s] - hist_rf[s]) <= 0.15 * max(hist_fd[s], 20)
    report["ok"] = bool(ok)
    report["kernel"] = kernel
    return report


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    m = sub.add_parser("msd")
    m.add_argument("--ref-gro", default=None)
    m.add_argument("--steps", type=int, default=2000)
    m.add_argument("--spacing", type=float, default=20.0)
    m.add_argument("--seed", type=int, default=0)
    m.add_argument("--out", default=None)
    r = sub.add_parser("rates")
    r.add_argument("--steps", type=int, default=400)
    r.add_argument("--spacing", type=float, default=20.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out", default=None)
    for p in (m, r):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the lattice runs; cuda raises without a "
                            "card")
    args = ap.parse_args(argv)
    report = cmd_msd(args) if args.mode == "msd" else cmd_rates(args)
    report["device"] = device_label(args.device)
    report["seconds"] = time.perf_counter() - t0
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
