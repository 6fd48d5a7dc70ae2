#!/usr/bin/env python
"""Receptors-only encounter probe (port of the JAX package's
``scripts/receptors_probe.py``): the free-A pair encounter rate (the
mono-cis eligibility flux, main.cpp:1952-2003) in a pure receptor gas.

The design is the JAX script's: 40 receptors at the reference's area
density (the mini box), one ligand, and every association rate 0.  The
eligibility counter fires independently of the Bernoulli draw, so with
rate 0 the probe counts the raw geometric encounters of a stationary
diffusing gas, with no kinetic feedback.

Stages:
  refs   -- compiles and launches the instrumented C++ reference; its
            source (main.cpp) is not in this repository, so the stage
            raises and runs nothing.
  ours   -- runs ``--replicas`` replicas of ``probe_config()`` for
            ``--steps`` steps (``step_fn_diag(batched=True)``: K1 on every
            replica every step on the card) and writes the per-replica
            sums of every diag key to ``<workdir>/ours_elig.npz`` with the
            JAX script's keys (``steps`` and the diag keys), plus the
            port's ``device`` and ``seconds``; either package's ``report``
            reads either package's file.
  report -- per-step rates, their SEs across runs / replicas and the
            ratio's CI, as the JAX script computes them.  The reference's
            rates come from ``<workdir>/runN/chan.dat``, or with
            ``--ref-json`` from a committed report (e.g.
            RECEPTORS_PROBE_r05.json).  Beside the JAX keys: ``device``
            and ``seconds`` (the ours stage's card or "cpu" and wall time,
            null for a file without them) and, with ``--ref-json``, that
            report's own rate as ``jax_rate_per_step`` / ``jax_rate_se``
            and ``ratio_port_over_jax`` with its SE and CI.

``ours`` runs on the card unless ``--device cpu`` is given; without a card
the default raises before anything is written.

  python -m kmc_tpu_torch.scripts.receptors_probe ours [--replicas 256]
      [--steps 200000] [--seed 7] [--workdir DIR] [--device cpu]
  python -m kmc_tpu_torch.scripts.receptors_probe report [--workdir DIR]
      [--ref-json RECEPTORS_PROBE_r05.json] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

NB = 1          # see the module docstring
OUR_STEPS = 200_000
OUT_EVERY = 5_000
NPZ = "ours_elig.npz"


def probe_config():
    """``our_config(1.0)`` with one ligand, every association rate 0 and
    ``out_every`` OUT_EVERY."""
    from kmc_tpu_torch.scripts import mini_golden as mg

    return mg.our_config(1.0).replace(
        n_b=NB, ass_rate=0.0, mono_cis_ass_rate=0.0, cis_ass_rate=0.0,
        out_every=OUT_EVERY)


def run_probe(cfg, replicas: int, steps: int, seed: int, device,
              chunk: int, on_chunk=None):
    """``steps`` batched diagnostic steps of ``init_ensemble(cfg, replicas,
    seed)`` in chunks of ``chunk``: (the per-replica sum of every diag key,
    int64 numpy arrays; the final state).  ``on_chunk(k, n)`` fires after
    chunk k of n."""
    from kmc_tpu_torch.scripts.chan_flux import diag_series, start_state

    if steps <= 0 or steps % chunk:
        raise ValueError(f"--steps {steps} is not a positive multiple of "
                         f"the chunk of {chunk} steps")
    state = start_state(cfg, replicas, seed, device=device)
    series, state = diag_series(state, cfg, steps // chunk, chunk, device,
                                on_chunk)
    return series[-1], state


def cmd_refs(args):
    raise FileNotFoundError(
        "the refs stage compiles the C++ reference source (main.cpp), "
        "which is not in this repository; nothing was run")


def cmd_ours(args):
    from kmc_tpu_torch.scripts.validate_vs_reference import device_label
    from kmc_tpu_torch.state import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    cfg = probe_config()

    def progress(k, n_out):
        rate = (k + 1) * OUT_EVERY / (time.perf_counter() - t0)
        print(f"# ours {k + 1}/{n_out} ({rate:,.0f} steps/s)",
              file=sys.stderr, flush=True)

    acc, _ = run_probe(cfg, args.replicas, args.steps, args.seed, dev,
                       OUT_EVERY, progress)
    os.makedirs(args.workdir, exist_ok=True)
    np.savez(os.path.join(args.workdir, NPZ), steps=np.asarray(args.steps),
             device=np.asarray(device_label(dev)),
             seconds=np.asarray(time.perf_counter() - t0), **acc)
    print(f"ours done: elig_mono mean/replica = "
          f"{acc['elig_mono'].mean():.1f} over {args.steps} steps")


def reference_rates(args):
    """(rates per run, steps per run, tail-75 % rate or None, the committed
    report or None): from ``--ref-json`` or the runs' chan.dat files."""
    if args.ref_json:
        with open(args.ref_json) as f:
            ref = json.load(f)
        return (np.asarray(ref["ref_rates"], dtype=float),
                [int(s) for s in ref["ref_steps"]],
                ref["ref_tail75_rate_per_step"], ref)
    ref_rates, ref_steps, ref_tail_rates = [], [], []
    for r in range(args.ref_runs):
        path = os.path.join(args.workdir, f"run{r}", "chan.dat")
        rows = np.loadtxt(path).reshape(-1, 12)
        # cumulative counters at the last completed output
        ref_rates.append(rows[-1, 2] / rows[-1, 0])          # elig_mono/step
        ref_steps.append(int(rows[-1, 0]))
        q = len(rows) // 4
        if q >= 1:                      # last 75 % only (init transient)
            ref_tail_rates.append((rows[-1, 2] - rows[q - 1, 2])
                                  / (rows[-1, 0] - rows[q - 1, 0]))
    tail = float(np.mean(ref_tail_rates)) if ref_tail_rates else None
    return np.asarray(ref_rates), ref_steps, tail, None


def ratio_with_se(num, num_se, den, den_se):
    """num / den with its delta-method SE and 95 % CI."""
    ratio = num / den
    se = ratio * np.sqrt((den_se / den) ** 2 + (num_se / num) ** 2)
    return ratio, se, [float(ratio - 1.96 * se), float(ratio + 1.96 * se)]


def cmd_report(args):
    ref_rates, ref_steps, ref_tail, committed = reference_rates(args)
    with np.load(os.path.join(args.workdir, NPZ)) as z:
        steps = int(z["steps"])
        ours = z["elig_mono"].astype(float) / steps          # per replica
        device = str(z["device"]) if "device" in z.files else None
        seconds = float(z["seconds"]) if "seconds" in z.files else None
    ref_mean, ref_se = ref_rates.mean(), ref_rates.std(ddof=1) / np.sqrt(
        len(ref_rates))
    our_mean, our_se = ours.mean(), ours.std(ddof=1) / np.sqrt(len(ours))
    ratio, rse, ci = ratio_with_se(our_mean, our_se, ref_mean, ref_se)
    report = {
        "design": "receptors-only stationary gas, all Ass rates 0, NA=40 "
                  "NB=1, mini box (reference area density); elig_mono "
                  "counts ordered free-A pairs passing the cis gates "
                  "(main.cpp:1952-2003) per step",
        "ref_runs": len(ref_rates),
        "ref_steps": ref_steps,
        "ref_rate_per_step": float(ref_mean),
        "ref_rate_se": float(ref_se),
        "ref_rates": [float(x) for x in ref_rates],
        "ref_tail75_rate_per_step": ref_tail,
        "our_replicas": len(ours),
        "our_steps": steps,
        "our_rate_per_step": float(our_mean),
        "our_rate_se": float(our_se),
        "ratio_ours_over_ref": float(ratio),
        "ratio_se": float(rse),
        "ratio_ci95": ci,
        "verdict_ok": bool(abs(ratio - 1.0) <= 1.96 * rse + 0.05),
        "device": device,
        "seconds": seconds,
    }
    if committed is not None:
        jax_mean, jax_se = (committed["our_rate_per_step"],
                            committed["our_rate_se"])
        pj, pj_se, pj_ci = ratio_with_se(our_mean, our_se, jax_mean, jax_se)
        report.update({
            "ref_json": os.path.basename(args.ref_json),
            "jax_rate_per_step": jax_mean,
            "jax_rate_se": jax_se,
            "ratio_port_over_jax": float(pj),
            "ratio_port_over_jax_se": float(pj_se),
            "ratio_port_over_jax_ci95": pj_ci,
        })
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("stage", choices=("refs", "ours", "report"))
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "rprobe"))
    ap.add_argument("--ref-runs", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=OUR_STEPS,
                    help="steps of the ours stage, a multiple of OUT_EVERY")
    ap.add_argument("--ref-json", default=None,
                    help="report: take the reference's rates from this "
                         "committed report instead of runN/chan.dat")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ours stage runs; cuda raises without "
                         "a card")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    {"refs": cmd_refs, "ours": cmd_ours, "report": cmd_report}[
        args.stage](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
