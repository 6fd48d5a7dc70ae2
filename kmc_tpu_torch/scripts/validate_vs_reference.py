#!/usr/bin/env python
"""Statistical validation against the compiled C++ reference (port of the
JAX package's ``scripts/validate_vs_reference.py``; the reference is the
golden oracle, compared seeds-in-distribution -- never bitwise, since its
RNG is wall-clock-seeded per call).

Modes:
  kinetics  -- compare reference bond.dat files against the predictive band
              of a replica ensemble run at identical parameters: for each
              output time and EVERY one of the 7 bond.dat columns
              (main.cpp:2251 -- time, bond_rl, bond_mono_cis, bond_cis,
              bond_num, cluster_size, protein_num_in_Max_Complex), the
              reference value must fall inside the ensemble's [lo, hi]
              quantile band.  With --ref-cluster the same run compares the
              reference cluster.log frames (main.cpp:2291-2305): the
              ligand-seeded cluster-size histogram and the receptor count
              per seeded cluster, each against the ensemble's per-replica
              histogram band plus a total-variation check on the
              time-averaged tail.
  msd       -- mean-squared-displacement curves extracted from test.gro
              trajectories (ours vs reference), compared to each other and
              to the analytic per-step displacement second moment
              E[dr^2] = 2 D dt / 9 (main.cpp:585, 909).

The ensemble runs on the card unless ``--device cpu`` is given; without a
card the default raises before anything is written.  ``--state-file``
persists the ensemble and the series every output in the JAX script's
layout (``leaf{i}`` in SimState field order, the key as uint32 words), so
each package resumes and checks the other's file.

Usage:
  python -m kmc_tpu_torch.scripts.validate_vs_reference kinetics \\
      --ref-bond ref_data/refgolden_bond.dat ref_data/refgolden2_bond.dat \\
      --ref-cluster ref_data/refgolden_cluster.log \\
          ref_data/refgolden2_cluster.log \\
      --replicas 256 --align-mode lazy --max-rows 20 \\
      --state-file state.npz --resume-state --invariants --out report.json
  python -m kmc_tpu_torch.scripts.validate_vs_reference msd \\
      --ref-gro ref_data/refgolden_test.gro
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def run_config():
    """The single SimConfig used by BOTH the ensemble run and every derived
    quantity (anchor times, writer truncation geometry, the invariant
    check) -- one construction site so they cannot silently diverge."""
    from kmc_tpu_torch.config import SimConfig

    return SimConfig()


def read_bond_dat(path):
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 7:
                rows.append([float(x) for x in parts])
    return np.asarray(rows)


def read_gro_centers(path, n_a, n_b):
    """Per-frame molecule reference positions from a test.gro file:
    receptors = first bead center; ligands = centroid of their 3 beads.
    Returns (times, pos[frames, n_a + n_b, 3]) in Angstrom."""
    times, frames = [], []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    natoms_expect = n_a * 4 + n_b * 3
    while i < len(lines):
        if not lines[i].startswith("Hello Gro!"):
            i += 1
            continue
        t = float(lines[i].split("t=")[1])
        natoms = int(lines[i + 1])
        if natoms != natoms_expect:
            raise ValueError(f"unexpected atom count {natoms}")
        block = lines[i + 2 : i + 2 + natoms]
        xyz = np.array(
            [[float(l[-24:-16]), float(l[-16:-8]), float(l[-8:])] for l in block]
        ) * 10.0                                   # nm -> Angstrom
        a = xyz[: n_a * 4].reshape(n_a, 4, 3)[:, 0]
        b = xyz[n_a * 4:].reshape(n_b, 3, 3).mean(axis=1)
        frames.append(np.concatenate([a, b]))
        times.append(t)
        i += 2 + natoms + 1
    return np.asarray(times), np.asarray(frames)


def read_cluster_log(path, max_size):
    """Parse a reference cluster.log into (times, hist[frames, max_size+1]):
    each frame is one 'Hello Cluster!, t=...' header followed by one line per
    ligand (empty line = ligand already visited by an earlier BFS row; token
    count = cluster size, sizes >= max_size binned into the last slot), the
    exact layout of main.cpp:2291-2305."""
    times, hists = [], []
    cur = None
    with open(path) as f:
        for line in f:
            if line.startswith("Hello Cluster!"):
                if cur is not None:
                    hists.append(cur)
                times.append(float(line.split("t=")[1]))
                cur = np.zeros(max_size + 1, dtype=np.int64)
                continue
            if cur is None:
                continue
            n = len(line.split())
            if n:
                cur[min(n, max_size)] += 1
    if cur is not None:
        hists.append(cur)
    return np.asarray(times), np.asarray(hists)


def read_cluster_log_receptors(path, n_a, max_size):
    """Parse a reference cluster.log into per-frame histograms of RECEPTOR
    counts per ligand-seeded cluster: tokens are 1-based member protein ids
    (main.cpp:2291-2305), so a row's receptor count = #tokens <= n_a.
    Returns (times, hist[frames, max_size+1]); slot r = clusters with r
    receptors (r >= max_size binned; slot 0 = pure-ligand clusters) -- the
    exact statistic of observables.seeded_receptor_histogram."""
    times, hists = [], []
    cur = None
    with open(path) as f:
        for line in f:
            if line.startswith("Hello Cluster!"):
                if cur is not None:
                    hists.append(cur)
                times.append(float(line.split("t=")[1]))
                cur = np.zeros(max_size + 1, dtype=np.int64)
                continue
            if cur is None:
                continue
            toks = line.split()
            if toks:
                n_rec = sum(1 for t in toks if int(t) <= n_a)
                cur[min(n_rec, max_size)] += 1
    if cur is not None:
        hists.append(cur)
    return np.asarray(times), np.asarray(hists)


def unwrap(traj, box_xy):
    """Undo periodic jumps frame-to-frame (valid when per-frame motion << box)."""
    d = np.diff(traj, axis=0)
    for ax, box in enumerate(box_xy):
        d[..., ax] -= box * np.round(d[..., ax] / box)
    return np.concatenate([traj[:1], traj[:1] + np.cumsum(d, axis=0)], axis=0)


def msd_curve(times, frames, box_xy):
    un = unwrap(frames, box_xy)
    disp = un - un[0]
    return times - times[0], np.mean(np.sum(disp**2, axis=-1), axis=1)


# All 7 bond.dat columns (main.cpp:2251).  max_complex is the running max
# over ligand-seeded cluster sizes (main.cpp:896-898) -- far more
# autocorrelated than the counters, hence its longer decorrelation lag in
# the binomial-tail acceptance below.
KIN_COLS = ["bond_rl", "bond_mono_cis", "bond_cis", "bond_num",
            "cluster_size", "max_complex"]
KIN_LAGS = {"bond_rl": 5, "bond_mono_cis": 5, "bond_cis": 5, "bond_num": 5,
            "cluster_size": 5, "max_complex": 20}
# In-band tolerance per column.  The integer counters need only a float
# epsilon, but cluster_size is a REAL mean printed by the reference at
# %.3f (main.cpp:2251) -- i.e. quantized to 5e-4 -- while the ensemble
# statistic is computed in f32 (~4e-7 off at 9.4).  When the conditional
# band's edge sits exactly on a shared plateau value, a 1e-9 tolerance
# turns that pure representation mismatch into a systematic false miss;
# 1e-3 covers print quantum + f32 rounding and is far below the ~5e-3
# spacing of distinct achievable means at reference scale.
KIN_ATOL = {c: 1e-9 for c in KIN_COLS}
KIN_ATOL["cluster_size"] = 1e-3


def truncate_outputs(out_dir, cfg, rows):
    """Trim a (possibly over-written) output directory to exactly ``rows``
    output intervals -- closes the resume race where the writer appends
    output k+1 before the state file persists k: on resume we truncate to
    the state file's row count and re-emit deterministically."""
    def keep_lines(path, n):
        if not os.path.exists(path):
            return
        with open(path) as f:
            lines = f.readlines()
        if len(lines) > n:
            with open(path, "w") as f:
                f.writelines(lines[:n])

    keep_lines(os.path.join(out_dir, "bond.dat"), rows)
    keep_lines(os.path.join(out_dir, "hist.dat"), rows)
    # bond_ens.dat: header + one row per output
    keep_lines(os.path.join(out_dir, "bond_ens.dat"), rows + 1)
    # test.gro frames: header, natom count, natoms lines, box line
    natoms = cfg.n_a * 4 + cfg.n_b * 3
    keep_lines(os.path.join(out_dir, "test.gro"), rows * (natoms + 3))
    # cluster.log frames: header + one line per ligand
    keep_lines(os.path.join(out_dir, "cluster.log"), rows * (cfg.n_b + 1))


# ---------------------------------------------------------------------------
# the state file: the JAX script's layout

def state_arrays(state) -> dict:
    """``leaf{i}`` in SimState field order (the key as its uint32 key words
    [R, 2], ``jax.random.key_data``'s layout) and ``n_leaf``."""
    from kmc_tpu_torch import convert
    from kmc_tpu_torch.state import SimState

    fields = convert.to_numpy(state)
    arrs = {f"leaf{i}": fields[name]
            for i, name in enumerate(SimState._fields)}
    arrs["n_leaf"] = np.asarray(len(SimState._fields))
    return arrs


def load_state(z, device):
    """The ensemble of a state file (either package's) on ``device``."""
    from kmc_tpu_torch import convert
    from kmc_tpu_torch.state import SimState

    n = int(z["n_leaf"])
    if n != len(SimState._fields):
        raise ValueError(f"state file holds {n} leaves, SimState has "
                         f"{len(SimState._fields)}")
    return convert.from_numpy(
        {name: z[f"leaf{i}"] for i, name in enumerate(SimState._fields)},
        batched=True, device=device)


def device_label(dev) -> str:
    """The card's ``nvidia-smi`` name and power limit, or "cpu".  The card
    is found by its UUID: nvidia-smi lists every card of the host, whatever
    ``CUDA_VISIBLE_DEVICES`` leaves to this process."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    norm = lambda u: u.strip().lower().removeprefix("gpu-")
    uuid = norm(str(getattr(torch.cuda.get_device_properties(dev), "uuid",
                            "")))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    for line in out:
        smi_uuid, _, label = line.partition(",")
        if uuid and norm(smi_uuid) == uuid:
            return label.strip()
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _run_ensemble(args, n_out, with_hist, on_progress=None):
    """Advance an ensemble n_out output intervals; returns
    (kin[col] -> [n_done, replicas], hist[n_done, reps, S+1] or None,
    ahist[n_done, reps, S+1] or None).  n_done is n_out unless
    ``args.time_limit`` stopped the run first (it stops before an output
    that would not end inside the limit at the mean pace so far).
    ``on_progress(k, kin_partial, hists_partial, ahists_partial)`` fires
    every 10 outputs -- used to write partial reports so a timeout still
    leaves evidence.

    With ``args.init_cpt`` the ensemble starts from a REFERENCE
    position.cpt broadcast to all replicas (anchor continuation); with
    ``args.write_outputs`` replica 0's full reference-compatible output
    file set (bond.dat / test.gro / cluster.log / position.cpt + ensemble
    series) is written as the run progresses.

    The chunks run on ``args.device`` with no host sync of their own; the
    observables are read once an output.  Resume migration: state files
    whose series predate a column or the receptor histograms are padded
    with NaN on load and masked out of the band tests (reported as
    n_valid)."""
    from kmc_tpu_torch.parallel.ensemble import (
        broadcast_ensemble, init_ensemble, make_ensemble_chunk,
        make_ensemble_chunk_hist, make_lazy_ensemble_chunk,
        make_lazy_ensemble_chunk_hist)
    from kmc_tpu_torch.state import resolve_device

    cfg = run_config()
    dev = resolve_device(getattr(args, "device", "cuda"))
    if getattr(args, "align_mode", "eager") == "lazy":
        maker = (make_lazy_ensemble_chunk_hist if with_hist
                 else make_lazy_ensemble_chunk)
    else:
        maker = make_ensemble_chunk_hist if with_hist else make_ensemble_chunk
    # one output interval = several chunks, so progress and a stop by
    # --time-limit come at a fine grain
    sub = max(int(getattr(args, "sub_chunks", 10)), 1)
    if cfg.out_every % sub:
        raise ValueError(f"--sub-chunks {sub} does not divide out_every "
                         f"{cfg.out_every}")
    chunk = maker(cfg, cfg.out_every // sub, device=dev)

    # persist (state, series) every output, so a stopped run resumes at
    # the last completed output
    sf = getattr(args, "state_file", None)
    k0 = 0
    kin = {c: [] for c in KIN_COLS}
    hists = []
    ahists = []
    reps = args.replicas
    S = None
    wall0 = 0.0
    if sf and os.path.exists(sf) and getattr(args, "resume_state", False):
        with np.load(sf) as z:
            k0 = int(z["k_done"])
            state = load_state(z, dev)
            zk = z["kin"]                          # [k0, n_saved_cols, reps]
            n_saved = zk.shape[1] if zk.ndim == 3 else 0
            for ci, c in enumerate(KIN_COLS):
                if ci < n_saved:
                    kin[c] = list(zk[:, ci].astype(np.float64))
                else:                              # pre-r5 file: 4 columns
                    kin[c] = [np.full((reps,), np.nan)] * k0
            if z["hists"].ndim == 3:
                hists = list(z["hists"].astype(np.float64))
                S = z["hists"].shape[2]
            elif with_hist and k0 > 0:
                # resuming a kinetics-only state into a with-hist run: pad
                # the already-run rows so hist row i always means output i
                from kmc_tpu_torch.engine.observables import MAX_HIST_SIZE

                S = MAX_HIST_SIZE + 1
                hists = [np.full((reps, S), np.nan)] * k0
            if "ahists" in z and z["ahists"].ndim == 3:
                ahists = list(z["ahists"].astype(np.float64))
            elif S is not None:
                ahists = [np.full((reps, S), np.nan)] * k0
            wall0 = float(z["wall_s"]) if "wall_s" in z else 0.0
        print(f"# resumed at output {k0}/{n_out} from {sf} "
              f"({n_saved} saved kin cols)", file=sys.stderr, flush=True)
    elif getattr(args, "init_cpt", None):
        from kmc_tpu_torch.io.checkpoint import load_reference_cpt

        anchor = load_reference_cpt(args.init_cpt, cfg, device=dev)
        print(f"# anchor continuation from {args.init_cpt} at step "
              f"{int(anchor.step[0])}", file=sys.stderr, flush=True)
        state = broadcast_ensemble(anchor, args.replicas, seed=args.seed)
    else:
        state = init_ensemble(cfg, args.replicas, seed=args.seed, device=dev)

    t_wall0 = time.perf_counter()

    def save_state(k_done, st):
        if not sf:
            return
        arrs = state_arrays(st)
        arrs["k_done"] = np.asarray(k_done)
        arrs["kin"] = np.stack(
            [np.stack(kin[c], 0).astype(np.float64) for c in KIN_COLS], 1) \
            if kin[KIN_COLS[0]] else np.zeros((0, len(KIN_COLS), 0))
        arrs["hists"] = np.stack(hists) if hists else np.zeros((0,))
        arrs["ahists"] = np.stack(ahists) if ahists else np.zeros((0,))
        # seconds of the output loop over every run of this file (a key
        # the JAX script's readers ignore)
        arrs["wall_s"] = np.asarray(wall0 + time.perf_counter() - t_wall0)
        tmp = sf + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, sf)

    writer = None
    if getattr(args, "write_outputs", None):
        from kmc_tpu_torch.io.writers import EnsembleOutputSet

        if k0 > 0:
            # close the writer/save_state resume race: trim any output rows
            # past the persisted k_done before re-emitting them
            truncate_outputs(args.write_outputs, cfg, k0)
        writer = EnsembleOutputSet(args.write_outputs, cfg, fresh=(k0 == 0))

    def stack_kin():
        return {c: np.stack(v).astype(np.float64) for c, v in kin.items()}

    limit = float(getattr(args, "time_limit", 0) or 0)
    for k in range(k0, n_out):
        spent = time.perf_counter() - t_wall0
        if limit and k > k0 and spent + spent / (k - k0) > limit:
            print(f"# --time-limit {limit:g} s: stopping after output {k}"
                  f"/{n_out}", file=sys.stderr, flush=True)
            break
        for _ in range(sub):
            state, out = chunk(state)
        if with_hist:
            obs, hist, ahist = out
        else:
            obs, hist, ahist = out, None, None
        for c in KIN_COLS:
            kin[c].append(getattr(obs, c).cpu().numpy().astype(np.float64))
        if hist is not None:
            hists.append(hist.cpu().numpy().astype(np.float64))
            ahists.append(ahist.cpu().numpy().astype(np.float64))
        if writer is not None:
            writer(state, obs)
        save_state(k + 1, state)
        if (k + 1) % 10 == 0:
            rate = ((k + 1 - k0) * cfg.out_every
                    / (time.perf_counter() - t_wall0))
            print(f"# ensemble output {k + 1}/{n_out} "
                  f"({rate:,.0f} steps/s horizon rate)", file=sys.stderr,
                  flush=True)
            if on_progress is not None:
                on_progress(k + 1, stack_kin(),
                            np.stack(hists) if hists else None,
                            np.stack(ahists) if ahists else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if writer is not None:
        writer.close()
    return (stack_kin(), np.stack(hists) if hists else None,
            np.stack(ahists) if ahists else None)


def _kinetics_report(kin, ref, args):
    """Per-column quantile-band coverage of the single reference trajectory
    within the ensemble's predictive band, with a binomial-tail acceptance
    threshold instead of a flat cutoff: with nominal band mass (2q-1), the
    observed inside-fraction over the valid rows (autocorrelated, so
    conservative effective n = n_valid/lag, lag per KIN_LAGS) must not be
    improbably low (p > 1e-3).  Rows padded with NaN (columns missing from
    a resumed state file) are excluded and reported as n_valid."""
    from math import comb

    q = args.quantile
    n_out = len(ref)
    report = {"n_out": n_out, "replicas": args.replicas, "quantile": q,
              "columns": {}}
    ok_all = True
    for ci, c in enumerate(KIN_COLS):
        samples = np.asarray(kin[c][:n_out], dtype=np.float64)
        refv = ref[:n_out, 1 + ci]                   # [n_out, replicas]
        valid = ~np.isnan(samples[:, 0])
        n_valid = int(valid.sum())
        if n_valid == 0:
            report["columns"][c] = {"n_valid": 0, "ok": None}
            continue
        s_v, r_v = samples[valid], refv[valid]
        lo = np.quantile(s_v, 1 - q, axis=1)
        hi = np.quantile(s_v, q, axis=1)
        atol = KIN_ATOL[c]
        inside = (r_v >= lo - atol) & (r_v <= hi + atol)
        frac = float(np.mean(inside))
        # binomial lower tail at effective sample size (lag decorrelation)
        n_eff = max(n_valid // KIN_LAGS[c], 1)
        k_eff = int(round(frac * n_eff))
        p_nom = 2 * q - 1
        p_tail = sum(comb(n_eff, k) * p_nom**k * (1 - p_nom) ** (n_eff - k)
                     for k in range(k_eff + 1))
        mean_err = float(np.mean(np.abs(r_v - s_v.mean(1))))
        signed_err = float(np.mean(r_v - s_v.mean(1)))
        ok = frac >= args.min_coverage and p_tail > 1e-3
        ok_all &= ok
        report["columns"][c] = {
            "n_valid": n_valid,
            "coverage": frac,
            "binomial_tail_p": float(p_tail),
            "mean_abs_err_vs_ensemble_mean": mean_err,
            "mean_signed_err_ref_minus_ours": signed_err,
            "ok": ok,
        }
    report["ok"] = bool(ok_all)
    return report


def _clusters_report(hist_ens, ref_hists, args):
    """Cluster-histogram comparison (used for BOTH the ligand-seeded
    cluster-size histogram and the receptor-count-per-cluster histogram):
    (a) per-(time, size-bin) quantile-band coverage of the reference
    histogram counts, and (b) a distribution-level check -- total-variation
    distance between the reference's tail-time-averaged size distribution
    and the ensemble mean distribution must not exceed the 99th percentile
    of the replicas' own TV distances from that mean (i.e. the reference
    must look like one more replica).  NaN ensemble frames (rows predating
    the statistic in a resumed state file) are masked."""
    n_out = min(len(ref_hists), len(hist_ens))
    ens = hist_ens[:n_out].astype(np.float64)        # [n_out, reps, S+1]
    ref = ref_hists[:n_out].astype(np.float64)
    valid = ~np.isnan(ens[:, 0, 0])
    n_valid = int(valid.sum())
    if n_valid == 0:
        return {"n_out": n_out, "n_valid": 0, "ok": None}
    ens, ref = ens[valid], ref[valid]

    q = args.quantile
    lo = np.quantile(ens, 1 - q, axis=1)
    hi = np.quantile(ens, q, axis=1)
    inside = (ref >= lo - 1e-9) & (ref <= hi + 1e-9)
    coverage = float(np.mean(inside))

    tail = slice(n_valid // 2, n_valid)              # steady-state half
    def tv(p, m):
        return 0.5 * np.sum(np.abs(p - m), axis=-1)

    def norm(h):
        s = h.sum(axis=-1, keepdims=True)
        return h / np.maximum(s, 1e-12)

    ref_dist = norm(ref[tail].mean(axis=0))          # [S+1]
    rep_dists = norm(ens[tail].mean(axis=0))         # [reps, S+1]
    mean_dist = rep_dists.mean(axis=0)
    ref_tv = float(tv(ref_dist, mean_dist))
    rep_tv = tv(rep_dists, mean_dist)
    tv_thresh = float(np.quantile(rep_tv, 0.99))

    ok = coverage >= args.min_coverage and ref_tv <= max(tv_thresh, 1e-6)
    return {
        "n_out": n_out,
        "n_valid": n_valid,
        "bin_coverage": coverage,
        "ref_tv_vs_ensemble_mean": ref_tv,
        "replica_tv_p99": tv_thresh,
        "ref_tail_dist": [round(float(x), 4) for x in ref_dist],
        "ens_tail_dist": [round(float(x), 4) for x in mean_dist],
        "ok": bool(ok),
    }


def cmd_kinetics(args):
    """Kinetics (+ optional clusters + receptor-oligomer) validation against
    one or MORE independent reference trajectories (each wall-clock-seeded
    run is its own realization; every one must sit inside the ensemble
    band).  Reference files are re-read at report time, and each oracle is
    compared over ITS OWN available depth.  Beyond the JAX script's report:
    ``device`` (the card's nvidia-smi name and power limit, or "cpu"),
    ``seconds`` (this command's wall time), ``rows_asked``, ``stopped``
    when --time-limit ended the run early, and ``invariants`` with
    --invariants."""
    from kmc_tpu_torch.engine.observables import MAX_HIST_SIZE
    from kmc_tpu_torch.state import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device(args.device)
    paths = args.ref_bond if isinstance(args.ref_bond, list) else \
        [args.ref_bond]
    refs = [read_bond_dat(p) for p in paths]
    for p, r in zip(paths, refs):
        if r.size == 0:
            sys.exit(f"reference bond.dat is empty: {p}")

    cfg = run_config()
    skip = 0
    anchor_t = None
    if getattr(args, "init_cpt", None):
        # anchor continuation: the cpt's final token is the saved step
        # (main.cpp:2243); the ensemble resumes there, so only oracle rows
        # AFTER the anchor time are comparable
        with open(args.init_cpt) as f:
            anchor_step = int(f.read().split()[-1])
        anchor_t = anchor_step * cfg.time_step
        skip = int(np.sum(refs[0][:, 0] <= anchor_t + 1e-6))
        for r in refs[1:]:
            if int(np.sum(r[:, 0] <= anchor_t + 1e-6)) != skip:
                raise ValueError("oracle runs disagree on anchor row "
                                 "(different cadences?)")
        print(f"# anchor t={anchor_t:.0f} ns -> skipping {skip} oracle rows",
              file=sys.stderr, flush=True)

    # size the run by the DEEPEST oracle (per-oracle comparisons below use
    # each oracle's own depth)
    n_out = max(len(r) - skip for r in refs)
    if args.max_rows:
        n_out = min(n_out, args.max_rows)

    cpaths = args.ref_cluster or []
    if isinstance(cpaths, str):
        cpaths = [cpaths]

    def build_report(kin, hist_ens, ahist_ens, k_avail):
        # re-read the oracles: they may have accumulated rows while the
        # ensemble was running
        refs_now = [read_bond_dat(p)[skip:] for p in paths]
        report = {"ref_runs": paths, "kinetics_runs": [], "n_out": k_avail}
        if anchor_t is not None:
            report["anchor"] = {"cpt": args.init_cpt, "t_ns": anchor_t,
                                "skipped_rows": skip}
        si = int(getattr(args, "skip_initial", 0) or 0)
        if si:
            # burn-in mask for continuations anchored at a SINGLE broadcast
            # state that is not the oracle's own: until the replicas
            # decorrelate, the ensemble band has ~zero width.  The masked
            # rows are reported, not hidden.
            report["skip_initial_burn_in_rows"] = si
            kin = {c: np.where(np.arange(len(v))[:, None] < si, np.nan,
                               np.asarray(v, dtype=np.float64))
                   for c, v in kin.items()}
            if hist_ens is not None:
                hist_ens = np.asarray(hist_ens, dtype=np.float64).copy()
                hist_ens[:si] = np.nan
            if ahist_ens is not None:
                ahist_ens = np.asarray(ahist_ens, dtype=np.float64).copy()
                ahist_ens[:si] = np.nan
        ok = True
        for r in refs_now:
            n_r = min(len(r), k_avail)
            rep = _kinetics_report(
                {c: v[:n_r] for c, v in kin.items()}, r[:n_r], args)
            report["kinetics_runs"].append(rep)
            ok &= rep["ok"]
        if cpaths and hist_ens is not None:
            report["clusters_runs"] = []
            report["receptor_oligomer_runs"] = []
            for p in cpaths:
                _, h = read_cluster_log(p, MAX_HIST_SIZE)
                rep = _clusters_report(hist_ens[:k_avail],
                                       h[skip: skip + k_avail], args)
                report["clusters_runs"].append(rep)
                ok &= rep["ok"] if rep["ok"] is not None else True
                if ahist_ens is not None:
                    _, ha = read_cluster_log_receptors(p, cfg.n_a,
                                                       MAX_HIST_SIZE)
                    rep = _clusters_report(ahist_ens[:k_avail],
                                           ha[skip: skip + k_avail], args)
                    report["receptor_oligomer_runs"].append(rep)
                    ok &= rep["ok"] if rep["ok"] is not None else True
        report["ok"] = bool(ok)
        return report

    if getattr(args, "report_only", False):
        # assemble the report purely from the persisted state file -- used to
        # mint a final report when the run is stopped before n_out
        with np.load(args.state_file) as z:
            k_done = int(z["k_done"])
            zk = z["kin"]
            reps = zk.shape[2]
            kin = {}
            for ci, c in enumerate(KIN_COLS):
                if ci < zk.shape[1]:
                    kin[c] = zk[:, ci].astype(np.float64)
                else:
                    kin[c] = np.full((k_done, reps), np.nan)
            hist_ens = z["hists"] if z["hists"].ndim == 3 else None
            if "ahists" in z and z["ahists"].ndim == 3:
                ahist_ens = z["ahists"]
                if len(ahist_ens) < k_done and hist_ens is not None:
                    pad = np.full((k_done - len(ahist_ens), reps,
                                   hist_ens.shape[2]), np.nan)
                    ahist_ens = np.concatenate([pad, ahist_ens])
            else:
                ahist_ens = None
        report = build_report(kin, hist_ens, ahist_ens, k_done)
        report["report_only_at_rows"] = k_done
    else:
        def on_progress(k, kin_p, hists_p, ahists_p):
            if not args.out:
                return
            rep = build_report(kin_p, hists_p, ahists_p, k)
            rep["partial"] = True
            tmp = args.out + ".partial.tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(rep, indent=1) + "\n")
            os.replace(tmp, args.out + ".partial")

        kin, hist_ens, ahist_ens = _run_ensemble(
            args, n_out, with_hist=bool(cpaths), on_progress=on_progress)
        k_done = min(len(kin[KIN_COLS[0]]), n_out)
        report = build_report(kin, hist_ens, ahist_ens, k_done)
    report["rows_asked"] = n_out
    if k_done < n_out:
        report["partial"] = True
        report["stopped"] = {
            "rows_done": k_done, "rows_asked": n_out,
            "why": (f"--time-limit of {args.time_limit:g} s reached"
                    if getattr(args, "time_limit", 0) and
                    not getattr(args, "report_only", False)
                    else "the state file holds fewer rows than asked")}
    if getattr(args, "invariants", False):
        from kmc_tpu_torch.scripts.check_flagship_state import check_state

        inv = check_state(args.state_file, dev)
        report["invariants"] = inv
        report["ok"] = bool(report["ok"] and inv["ok"])
    if args.state_file and os.path.exists(args.state_file):
        with np.load(args.state_file) as z:
            if "wall_s" in z:
                report["ensemble_seconds_all_runs"] = float(z["wall_s"])
    report["device"] = device_label(dev)
    report["seconds"] = time.perf_counter() - t_start
    ok = report["ok"]
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0 if ok else 1


def cmd_msd(args):
    cfg = run_config()
    box = (cfg.cell_range_x, cfg.cell_range_y)
    t_ref, ref_frames = read_gro_centers(args.ref_gro, cfg.n_a, cfg.n_b)
    if args.ref_t0 is not None or args.ref_t1 is not None:
        t0 = args.ref_t0 if args.ref_t0 is not None else -np.inf
        t1 = args.ref_t1 if args.ref_t1 is not None else np.inf
        m = (t_ref >= t0) & (t_ref <= t1)
        t_ref, ref_frames = t_ref[m], ref_frames[m]
    if args.tail_frac:
        # fit over the trailing window only (steady binding state), with
        # displacements re-zeroed at the window start -- so a reference
        # trajectory deep into binding saturation is compared like-for-like
        # against a continuation run that STARTS saturated.
        k = max(int(len(t_ref) * (1 - args.tail_frac)), 0)
        t_ref, ref_frames = t_ref[k:], ref_frames[k:]
    tt, mm = msd_curve(t_ref, ref_frames, box)

    if args.our_gro:
        t_o, our_frames = read_gro_centers(args.our_gro, cfg.n_a, cfg.n_b)
        to, mo = msd_curve(t_o, our_frames, box)
    else:
        to = mo = None

    # analytic per-step second moment (mixture of species; diffusion-
    # dominated early times): E[dr^2]/step = 2*D*dt/9 each species
    w_a, w_b = cfg.n_a / cfg.n, cfg.n_b / cfg.n
    slope = (w_a * 2 * cfg.rb_a_d + w_b * 2 * cfg.rb_b_d) * cfg.time_step / 9
    report = {"ref_points": len(tt)}
    if len(tt) > 1:
        ref_slope = float(np.polyfit(tt[1:] / cfg.time_step, mm[1:], 1)[0])
        report["ref_msd_per_step"] = ref_slope
        report["analytic_msd_per_step"] = slope
        report["ref_vs_analytic"] = ref_slope / slope
    ok = True
    if mo is not None and len(to) > 1:
        our_slope = float(np.polyfit(to[1:] / cfg.time_step, mo[1:], 1)[0])
        report["our_msd_per_step"] = our_slope
        report["our_vs_analytic"] = our_slope / slope
        if "ref_msd_per_step" in report:
            r = our_slope / report["ref_msd_per_step"]
            report["our_vs_ref"] = r
            ok = bool(abs(r - 1.0) <= args.rtol)
            report["rtol"] = args.rtol
            report["ok"] = ok
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kinetics")
    k.add_argument("--ref-bond", required=True, nargs="+",
                   help="one or more reference bond.dat trajectories")
    k.add_argument("--ref-cluster", default=None, nargs="*",
                   help="reference cluster.log(s); adds the cluster-size-"
                        "distribution and receptor-oligomer comparisons to "
                        "the same run")
    k.add_argument("--replicas", type=int, default=64)
    k.add_argument("--seed", type=int, default=0)
    k.add_argument("--quantile", type=float, default=0.995)
    k.add_argument("--min-coverage", type=float, default=0.9)
    k.add_argument("--max-rows", type=int, default=0,
                   help="compare only the first N reference outputs")
    k.add_argument("--sub-chunks", type=int, default=10,
                   help="chunks per output interval")
    k.add_argument("--align-mode", choices=("eager", "lazy"),
                   default="eager",
                   help="'lazy' runs the event-driven alignment ensemble "
                        "(the main path) -- validates the lazy "
                        "approximation at ship scale")
    k.add_argument("--init-cpt", default=None,
                   help="start every replica from this REFERENCE "
                        "position.cpt (anchor continuation) and compare "
                        "only oracle rows after the anchor time")
    k.add_argument("--write-outputs", default=None,
                   help="write replica 0's full reference-compatible "
                        "output file set + ensemble series to this dir "
                        "while validating")
    k.add_argument("--state-file", default=None,
                   help="persist (ensemble state, series) here every "
                        "output, in the JAX script's layout")
    k.add_argument("--resume-state", action="store_true",
                   help="resume from --state-file if it exists")
    k.add_argument("--skip-initial", type=int, default=0,
                   help="mask the first N ensemble outputs in the report "
                        "(decorrelation burn-in for continuations anchored "
                        "at a broadcast non-oracle state)")
    k.add_argument("--report-only", action="store_true",
                   help="build the report from --state-file without "
                        "running (mint a final report mid-horizon)")
    k.add_argument("--time-limit", type=float, default=0.0,
                   help="stop before an output that would end after this "
                        "many seconds of running; the report then says "
                        "how many rows were done (0: no limit)")
    k.add_argument("--invariants", action="store_true",
                   help="run check_flagship_state over every replica of "
                        "--state-file's final state and add its report")
    k.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the ensemble runs; cuda raises without a "
                        "card")
    k.add_argument("--out", default=None, help="also write the report here")
    m = sub.add_parser("msd")
    m.add_argument("--ref-gro", required=True)
    m.add_argument("--our-gro", default=None)
    m.add_argument("--ref-t0", type=float, default=None,
                   help="restrict reference frames to t >= this (ns)")
    m.add_argument("--ref-t1", type=float, default=None,
                   help="restrict reference frames to t <= this (ns)")
    m.add_argument("--tail-frac", type=float, default=0.0,
                   help="fit the reference slope over only the last FRAC of "
                        "frames (steady binding state, for comparing against "
                        "a checkpoint-continuation run)")
    m.add_argument("--rtol", type=float, default=0.25,
                   help="pass threshold on |our/ref - 1| when both given")
    m.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if args.mode == "kinetics":
        if (args.report_only or args.invariants) and not args.state_file:
            ap.error("--report-only and --invariants need --state-file")
        return cmd_kinetics(args)
    return cmd_msd(args)


if __name__ == "__main__":
    sys.exit(main())
