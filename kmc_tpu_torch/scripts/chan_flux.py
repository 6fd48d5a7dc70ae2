#!/usr/bin/env python
"""Per-channel reaction-flux comparison against an instrumented reference
build (port of the JAX package's ``scripts/chan_flux.py``, the ours side).

For each of the six channels it compares the cumulative number of
*eligible* candidates (pairs / triples passing the status and geometry
gates: encounter statistics of the diffusion and alignment engine) and of
*accepted* events (encounters x Bernoulli) between reference runs and a
replica ensemble at the mini configuration.  If eligibility differs the
bias lives in diffusion / alignment geometry; if eligibility matches and
acceptance does not, it lives in the reaction engine's matching.

The reference side compiles the C++ reference (main.cpp), which is not in
this repository.  Its outputs come from ``<workdir>/runN/chan.dat``
(``--reuse-refs``, the JAX script's report with its keys and values) or
from a committed report (``--ref-json CHAN_FLUX_*.json``: the runs'
finals, the reference-only fluxes and the quarter-point means).  With
``--ref-json`` the reference has ``steps // out_every`` outputs and the
quarter points are taken from that count; a run cut by ``--max-out``
reports ``ours_mean`` at the quarter points it reached and null at the
rest, and its finals only if it reached the reference's last output.

Beside the JAX keys the report has ``device`` (the card's ``nvidia-smi``
name and power limit, or "cpu"), ``seconds``, ``ours_outputs`` and
``ours_steps`` (what was run), ``ours_quarter_std`` (the replica std at
each quarter point reached) and ``ours_at_last_output`` (each channel's
mean / std / min / max at the last output run).  The ensemble runs on the
card unless ``--device cpu`` (or ``--cpu``) is given; without a card the
default raises before anything is written.

  python -m kmc_tpu_torch.scripts.chan_flux --boost 10 --replicas 32 \
      --preformed 8 --ref-json CHAN_FLUX_r03_postfix.json --max-out 26 \
      [--device cpu] --out CHAN_FLUX.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REF_COLS = ["step", "elig_trans", "elig_mono", "elig_cis", "acc_trans",
            "acc_mono", "acc_cis", "dis_trans", "dis_mono", "dis_cis",
            "re_up", "re_down"]
CHANNELS = ["elig_trans", "elig_mono", "elig_cis", "acc_trans", "acc_mono",
            "acc_cis", "dis_trans"]
REF_EXTRA = ["re_up", "re_down", "dis_mono", "dis_cis"]
QUARTER_CHANNELS = ["elig_cis", "acc_cis", "elig_mono", "acc_mono"]


# ---------------------------------------------------------------------------
# hand-built complexes (the JAX package's tests/helpers.py, on torch
# tensors of one replica)

def _place_receptor(st, i, xy, psi):
    a_xy, a_psi = st.a_xy.clone(), st.a_psi.clone()
    a_xy[0, i] = torch.as_tensor(np.asarray(xy, np.float32))
    a_psi[0, i] = float(np.float32(psi))
    return st._replace(a_xy=a_xy, a_psi=a_psi)


def _place_ligand_laid(st, b, center_xy, alpha, cfg):
    """Ligand b laid in the membrane plane with azimuth alpha."""
    from kmc_tpu_torch.geometry import quat_axis_z

    b_center, b_quat, b_laid = (st.b_center.clone(), st.b_quat.clone(),
                                st.b_laid.clone())
    b_center[0, b] = torch.as_tensor(np.asarray(
        [center_xy[0], center_xy[1], cfg.plane_z], np.float32))
    b_quat[0, b] = quat_axis_z(torch.tensor(alpha, dtype=torch.float32))
    b_laid[0, b] = True
    return st._replace(b_center=b_center, b_quat=b_quat, b_laid=b_laid)


def _ideal_trans_pair(st, a, b, site, cfg, center_xy=(0.0, 0.0), alpha=0.0,
                      bond=False):
    """Ligand b laid at center_xy / azimuth alpha; receptor a ideally
    seated behind bead ``site`` (1..3); with ``bond`` the topology links
    them.  The in-plane arithmetic is numpy's on the float32 template, as
    the JAX helper does it."""
    from kmc_tpu_torch.models.tnfr import ligand_template_np, trans_offsets

    st = _place_ligand_laid(st, b, center_xy, alpha, cfg)
    tmpl = ligand_template_np(cfg)
    ca, sa = np.cos(alpha), np.sin(alpha)

    def rot(v):
        return np.array([v[0] * ca - v[1] * sa, v[0] * sa + v[1] * ca])

    bead = rot(tmpl[site, 0, :2]) + np.asarray(center_xy)
    bsite = rot(tmpl[site, 1, :2]) + np.asarray(center_xy)
    u = (bsite - bead) / np.linalg.norm(bsite - bead)
    a_xy = bsite + trans_offsets(cfg)[0] * u
    st = _place_receptor(st, a, a_xy, float(np.arctan2(-u[1], -u[0])))
    if bond:
        a_trans, a_site, b_partner = (st.a_trans.clone(), st.a_site.clone(),
                                      st.b_partner.clone())
        a_trans[0, a] = cfg.n_a + b
        a_site[0, a] = site
        b_partner[0, b, site - 1] = a
        st = st._replace(a_trans=a_trans, a_site=a_site, b_partner=b_partner)
    return st


def build_preformed(cfg, n_complex=8):
    """A one-replica state (on the CPU) with ``n_complex`` preformed
    idealized 1-ligand complexes (1, 2, 3 bound receptors cycling), the
    remaining receptors free on a grid and the remaining ligands free high
    in the volume: the JAX script's start, which the reference runs also
    started from."""
    from kmc_tpu_torch import rng
    from kmc_tpu_torch.state import empty_state

    st = empty_state(cfg, rng.base_key(0, "cpu")[None])
    na, nb = cfg.n_a, cfg.n_b
    lx, ly, lz = cfg.cell_range_x, cfg.cell_range_y, cfg.cell_range_z

    spacing = lx / 4.0
    a_used = 0
    for k in range(n_complex):
        m = (k % 3) + 1                       # 1, 2, 3 receptors
        cx = -lx / 2 + spacing * (0.5 + (k % 4))
        cy = -ly / 2 + spacing * (0.5 + (k // 4))
        alpha = 2.399963 * k                  # golden-angle azimuths
        for s in range(1, m + 1):
            st = _ideal_trans_pair(st, a=a_used, b=k, site=s, cfg=cfg,
                                   center_xy=(cx, cy), alpha=alpha,
                                   bond=True)
            a_used += 1
    # free receptors on an offset grid (keeps everything far apart)
    cols = 8
    for i in range(na - a_used):
        x = -lx / 2 + (lx / cols) * (0.5 + (i % cols))
        y = -ly / 2 + (ly / cols) * (0.5 + (i // cols)) + spacing / 2
        st = _place_receptor(st, a_used + i, (x, y), 0.7 * i)
    # free ligands high in the volume
    b_center = st.b_center.clone()
    for b in range(n_complex, nb):
        j = b - n_complex
        b_center[0, b] = torch.as_tensor(np.asarray(
            [-lx / 2 + (lx / 4) * (0.5 + (j % 4)),
             -ly / 2 + (ly / 4) * (0.5 + (j // 4)),
             0.75 * lz], np.float32))
    return st._replace(b_center=b_center)


# ---------------------------------------------------------------------------
# the ensemble

def diag_series(state, cfg, n_out, out_every, device, on_output=None):
    """``n_out`` outputs of ``out_every`` batched diagnostic steps (on the
    card, K1 on every replica every step) from ``state``: (the cumulative
    per-replica counts after each output, a list of dict[channel] -> int64
    numpy array [replicas]; the final state).  The counts stay on the
    device (int64) and are copied to the host once an output;
    ``on_output(k, n_out)`` fires after output k."""
    from kmc_tpu_torch.engine.step import step_fn_diag

    acc = None
    series = []
    for k in range(n_out):
        for _ in range(out_every):
            state, _, dg = step_fn_diag(state, cfg, device, batched=True)
            dg = {k_: v.to(torch.int64) for k_, v in dg.items()}
            acc = dg if acc is None else {k_: acc[k_] + dg[k_] for k_ in acc}
        series.append({k_: v.cpu().numpy() for k_, v in acc.items()})
        if on_output is not None:
            on_output(k, n_out)
    return series, state


def start_state(cfg, replicas, seed, init_state=None, device=None):
    """``init_ensemble(cfg, replicas, seed)`` or, with ``init_state`` (one
    replica), that state broadcast to ``replicas`` replicas with
    independent streams, on ``device``."""
    from kmc_tpu_torch.parallel.ensemble import (broadcast_ensemble,
                                                 init_ensemble)
    from kmc_tpu_torch.state import SimState, resolve_device

    dev = resolve_device(device)
    if init_state is None:
        return init_ensemble(cfg, replicas, seed=seed, device=dev)
    return broadcast_ensemble(SimState(*(x.to(dev) for x in init_state)),
                              replicas, seed)


def run_ours(cfg, replicas, n_out, out_every, seed, init_state=None,
             device=None):
    """``diag_series`` from ``start_state``: the cumulative per-replica
    counts after each of ``n_out`` outputs."""
    from kmc_tpu_torch.state import resolve_device

    def progress(k, n):
        if (k + 1) % 10 == 0:
            print(f"# ours {k + 1}/{n}", file=sys.stderr, flush=True)

    dev = resolve_device(device)
    state = start_state(cfg, replicas, seed, init_state, dev)
    return diag_series(state, cfg, n_out, out_every, dev, progress)[0]


# ---------------------------------------------------------------------------
# the report

def _ref_chan_dat(args):
    """The reference runs' chan.dat rows, one [outputs, 12] array a run."""
    return [np.loadtxt(os.path.join(args.workdir, f"run{r}", "chan.dat")
                       ).reshape(-1, len(REF_COLS))
            for r in range(args.ref_runs)]


def _quarter_points(n):
    return [n // 4, n // 2, 3 * n // 4, n - 1]


def _ref_from_chan_dat(refs, n_out):
    """The reference side in the committed reports' layout, from the runs'
    chan.dat rows cut to ``n_out`` outputs."""
    col = REF_COLS.index
    qs = _quarter_points(n_out)
    channels = {c: {"ref_runs_final": [float(r[n_out - 1, col(c)])
                                       for r in refs]} for c in CHANNELS}
    # reference-only reclassification fluxes for context
    channels["ref_extra"] = {c: [float(r[n_out - 1, col(c)]) for r in refs]
                             for c in REF_EXTRA}
    return {"config": {"ref_runs": len(refs)}, "channels": channels,
            "quarters": {c: {"ref_mean": [
                float(np.mean([r[q, col(c)] for r in refs])) for q in qs]}
                for c in QUARTER_CHANNELS}}


def _report(args, ref, ours, n_ref):
    """The JAX script's report against ``ref`` (the reference side in the
    committed reports' layout) at the quarter points of its ``n_ref``
    outputs: the port's values where its run reached, null elsewhere; its
    finals only if the run reached output ``n_ref``."""
    n_run = len(ours)
    done = n_run == n_ref
    report = {"config": {"steps": args.steps, "boost": args.boost,
                         "replicas": args.replicas,
                         "ref_runs": ref["config"]["ref_runs"]},
              "channels": {}}
    for c in CHANNELS:
        ref_final = ref["channels"][c]["ref_runs_final"]
        our_final = ours[-1][c].astype(float)
        report["channels"][c] = {
            "ref_runs_final": ref_final,
            "ours_mean_final": float(our_final.mean()) if done else None,
            "ours_std_final": float(our_final.std()) if done else None,
            "ours_min": float(our_final.min()) if done else None,
            "ours_max": float(our_final.max()) if done else None,
            "ratio_mean_vs_refmean": (
                float(our_final.mean() / np.mean(ref_final))
                if done and np.mean(ref_final) else None),
        }
    report["channels"]["ref_extra"] = ref["channels"]["ref_extra"]
    # time series at quarter points for trend reading
    qs = _quarter_points(n_ref)
    report["quarters"] = {
        c: {"ref_mean": ref["quarters"][c]["ref_mean"],
            "ours_mean": [float(ours[q][c].mean()) if q < n_run else None
                          for q in qs]}
        for c in QUARTER_CHANNELS}
    return report, qs


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=100000)
    ap.add_argument("--out-every", type=int, default=1000)
    ap.add_argument("--replicas", type=int, default=24)
    ap.add_argument("--boost", type=float, default=10.0)
    ap.add_argument("--ref-runs", type=int, default=2)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "chanflux"))
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ensemble runs; cuda raises without a "
                         "card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preformed", type=int, default=0,
                    help="start from N preformed complexes")
    ap.add_argument("--max-out", type=int, default=0,
                    help="cap the compared output rows (ours-side runtime)")
    ap.add_argument("--reuse-refs", action="store_true",
                    help="parse existing runN/chan.dat instead of running "
                         "the reference")
    ap.add_argument("--ref-json", default=None,
                    help="take the reference side from this committed "
                         "report (CHAN_FLUX_*.json, run at the default "
                         "--out-every 1000)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from kmc_tpu_torch.scripts import mini_golden as mg
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device

    dev = resolve_device("cpu" if args.cpu else args.device)
    cfg = mg.our_config(args.boost).replace(out_every=args.out_every)
    pre = build_preformed(cfg, args.preformed) if args.preformed else None

    if args.ref_json:
        with open(args.ref_json) as f:
            ref = json.load(f)
        want = {"steps": args.steps, "boost": args.boost}
        have = {k: ref["config"][k] for k in want}
        if have != want:
            raise ValueError(f"{args.ref_json} was run at {have}, this "
                             f"command asks for {want}")
        n_ref = args.steps // args.out_every
        n_run = min(n_ref, args.max_out) if args.max_out else n_ref
        print(f"# reference: {ref['config']['ref_runs']} runs x {n_ref} "
              f"outputs ({os.path.basename(args.ref_json)}); ours to output "
              f"{n_run}", file=sys.stderr)
    elif args.reuse_refs:
        refs = _ref_chan_dat(args)
        n_ref = min(r.shape[0] for r in refs)
        if args.max_out:
            n_ref = min(n_ref, args.max_out)
        n_run, ref = n_ref, _ref_from_chan_dat(refs, n_ref)
        print(f"# reference: {len(refs)} runs x {n_ref} outputs",
              file=sys.stderr)
    else:
        raise FileNotFoundError(
            "running the reference compiles its C++ source (main.cpp), "
            "which is not in this repository; pass --reuse-refs with "
            "runN/chan.dat files or --ref-json with a committed report")

    ours = run_ours(cfg, args.replicas, n_run, args.out_every, args.seed,
                    init_state=pre, device=dev)
    report, qs = _report(args, ref, ours, n_ref)
    if args.ref_json:
        report["ref_json"] = os.path.basename(args.ref_json)
    last = ours[-1]
    report.update({
        "ours_outputs": n_run,
        "ours_steps": n_run * args.out_every,
        "ours_quarter_std": {c: [float(ours[q][c].std()) if q < n_run
                                 else None for q in qs]
                             for c in QUARTER_CHANNELS},
        "ours_at_last_output": {
            c: {"mean": float(last[c].mean()), "std": float(last[c].std()),
                "min": float(last[c].min()), "max": float(last[c].max())}
            for c in CHANNELS},
        "device": device_label(dev),
        "seconds": time.perf_counter() - t0,
    })
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
