"""Command-line driver of the port (port of ``kmc_tpu/cli.py``).

Configuration from JSON plus ``--set key=value`` overrides, an output
directory, and resume: from ``checkpoint.npz`` (native, bitwise) or
``position.cpt`` (the reference's text format, as the reference's startup
probe reads it, main.cpp:226-270) in the output directory, or for an
ensemble from ``ensemble_checkpoint.npz``.  The run is on the card unless
``--device cpu`` is given; without a card it raises.

Example::

    python -m kmc_tpu_torch.cli --steps 100000 --out runs/ref --seed 1
    python -m kmc_tpu_torch.cli --steps 2000 --replicas 512 --out runs/ens
    python -m kmc_tpu_torch.cli --engine lattice --steps 2000 --out runs/lat

``--engine lattice`` runs the lattice engine (``LatticeConfig`` keys in
``--set``): on the card through the kernel K3 (``csrc/lattice.cu``), with
or without ``--lattice-pallas``, since the JAX package's XLA step and its
kernel give the same bits; with ``--device cpu`` through the plain
version.  ``--lattice-rf`` runs its rejection-free mode instead
(``lattice/rejection_free.py``, plain PyTorch on the chosen device), one
event a step, so ``--steps`` counts events.

An ensemble shards over ranks: start one process a card with
``KMC_COORDINATOR=host:port KMC_NUM_PROCESSES=N KMC_PROCESS_ID=i``
(``parallel/distributed.py``; gloo ranks with ``--device cpu``).  When N > 1
divides ``--replicas``, rank p steps the replicas [p R / N, (p + 1) R / N)
of the same ensemble and rank 0 writes every file, so the files equal a
single process's.  Otherwise, and for every other run, rank 0 runs alone
and the other ranks write nothing.  A process started alone runs on one
card, however many are visible.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from kmc_tpu_torch.config import SimConfig


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        out[k] = v
    return out


def coerce(cfg_dict, overrides):
    for k, v in overrides.items():
        if k not in cfg_dict:
            raise SystemExit(f"unknown config key: {k}")
        cur = cfg_dict[k]
        try:
            if isinstance(cur, bool):
                cfg_dict[k] = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                cfg_dict[k] = int(v)
            elif isinstance(cur, float):
                cfg_dict[k] = float(v)
            else:
                cfg_dict[k] = v
        except ValueError:
            raise SystemExit(f"invalid value for {k}: {v!r} (expected "
                             f"{type(cur).__name__})")
    return cfg_dict


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmc_tpu_torch", description=__doc__)
    ap.add_argument("--config", help="JSON config file", default=None)
    ap.add_argument("--set", dest="sets", action="append",
                    help="override: key=value", default=[])
    ap.add_argument("--steps", type=int, default=None,
                    help="number of MC steps (default: cfg.simu_step)")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="trajectory-ensemble size (>1 also writes "
                         "bond_ens.dat with mean/std kinetics)")
    ap.add_argument("--engine", choices=["particle", "lattice"],
                    default="particle",
                    help="particle: the reference-parity rigid-body engine; "
                         "lattice: the occupancy-grid engine (LatticeConfig "
                         "keys in --set)")
    ap.add_argument("--lattice-pallas", action="store_true",
                    help="lattice engine: the fused kernel, which the card "
                         "runs with or without this flag")
    ap.add_argument("--lattice-rf", action="store_true",
                    help="lattice engine rejection-free mode (one event a "
                         "step; takes precedence over --lattice-pallas)")
    ap.add_argument("--out-every", type=int, default=None,
                    help="lattice engine output cadence (default 1000)")
    ap.add_argument("--resume", default="auto",
                    choices=["auto", "native", "reference", "none"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the card (default) or on the CPU")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from kmc_tpu_torch.parallel import distributed

    joined = distributed.initialize(device=args.device)
    try:
        return _run(args)
    finally:
        if joined:
            distributed.shutdown()


def _run(args) -> int:
    from kmc_tpu_torch.parallel.mesh import world
    from kmc_tpu_torch.state import resolve_device

    if args.engine == "lattice" or args.replicas <= 1:
        if world()[0] != 0:
            return 0                   # rank 0 alone runs an unsharded run
    if args.engine == "lattice":
        return run_lattice(args, resolve_device(args.device))

    cfg = SimConfig.from_json(args.config) if args.config else SimConfig()
    cfg = SimConfig.from_dict(coerce(cfg.to_dict(),
                                     parse_overrides(args.sets)))
    device = resolve_device(args.device)

    if args.replicas > 1:
        return run_ensemble(cfg, args, device)

    from kmc_tpu_torch.engine.step import run
    from kmc_tpu_torch.io.checkpoint import (load_native, load_reference_cpt,
                                             save_native)
    from kmc_tpu_torch.io.writers import OutputSet
    from kmc_tpu_torch.state import init_state

    native = os.path.join(args.out, "checkpoint.npz")
    ref_cpt = os.path.join(args.out, "position.cpt")
    state = None
    if args.resume in ("auto", "native") and os.path.exists(native):
        state = load_native(native, device)
        print(f"resuming from {native} at step {int(state.step[0])}")
    elif args.resume in ("auto", "reference") and os.path.exists(ref_cpt):
        state = load_reference_cpt(ref_cpt, cfg, args.seed, device)
        print(f"resuming from {ref_cpt} at step {int(state.step[0])}")
    fresh = state is None
    if fresh:
        state = init_state(cfg, args.seed, device)

    outputs = OutputSet(args.out, cfg, fresh=fresh)
    n_steps = args.steps if args.steps is not None else cfg.simu_step
    t0 = time.perf_counter()
    done = [0]

    def on_output(st, obs):
        outputs(st, obs)
        save_native(native, st)
        done[0] += cfg.out_every
        if not args.quiet:
            rate = done[0] / max(time.perf_counter() - t0, 1e-9)
            print(f"step {int(st.step[0]) - 1}  t={float(obs.time_ns[0]):.0f}"
                  f"ns  bonds={int(obs.bond_num[0])}  rate={rate:,.0f} "
                  "steps/s", file=sys.stderr)

    try:
        state = run(state, cfg, n_steps=n_steps, on_output=on_output,
                    device=device)
    finally:
        outputs.close()
    if not args.quiet:
        print(f"done at step {int(state.step[0]) - 1}")
    return 0


def run_lattice(args, device) -> int:
    """Lattice-engine run (BASELINE configs 2/3): occupancy-grid diffusion-
    reaction with species histogram + MSD time series, in whole chunks of
    --out-every steps.  The card runs K3, the CPU the plain version;
    --lattice-rf runs the rejection-free mode on either, an event a step."""
    from kmc_tpu_torch.config import LatticeConfig
    from kmc_tpu_torch.lattice.grid import init_lattice
    from kmc_tpu_torch.lattice.io import LatticeOutputSet, load_lattice
    from kmc_tpu_torch.lattice.rejection_free import make_rf_chunk
    from kmc_tpu_torch.lattice.step import make_lattice_chunk
    from kmc_tpu_torch.ops.lattice import make_pallas_lattice_chunk

    lcfg = LatticeConfig.from_dict(
        coerce(LatticeConfig().to_dict(), parse_overrides(args.sets)))
    out_every = args.out_every or 1000
    ckpt = os.path.join(args.out, "lattice_checkpoint.npz")
    state = None
    if args.resume in ("auto", "native") and os.path.exists(ckpt):
        state = load_lattice(ckpt, device)
        print(f"resuming lattice from {ckpt} at step {int(state.step)}")
    fresh = state is None
    if fresh:
        state = init_lattice(lcfg, seed=args.seed, device=device)

    if args.lattice_rf:
        make_chunk = make_rf_chunk
    elif device.type == "cuda":
        make_chunk = make_pallas_lattice_chunk
    else:
        make_chunk = make_lattice_chunk
    chunk = make_chunk(lcfg, out_every)
    outputs = LatticeOutputSet(args.out, lcfg, fresh=fresh)
    n_steps = args.steps if args.steps is not None else 100_000
    t0 = time.perf_counter()
    done = 0
    while done < n_steps:
        state = chunk(state)
        done += out_every
        outputs(state)
        if not args.quiet:
            rate = done / max(time.perf_counter() - t0, 1e-9)
            print(f"lattice step {int(state.step)}  rate={rate:,.0f} "
                  "steps/s", file=sys.stderr)
    if not args.quiet:
        print(f"done at lattice step {int(state.step)}")
    return 0


def run_ensemble(cfg: SimConfig, args, device) -> int:
    """Replica-ensemble run: the eager ensemble chunk (K1 on all of a
    rank's replicas every step), merged kinetics with error bars to
    bond_ens.dat and replica 0's reference-format files.  Sharded over the
    ranks when there are several and they divide the replicas; rank 0
    gathers the observables and the state at every output and writes the
    files, the checkpoint being the one a single process writes."""
    from kmc_tpu_torch.io.checkpoint import load_native, save_native
    from kmc_tpu_torch.io.writers import EnsembleOutputSet
    from kmc_tpu_torch.parallel.distributed import gather_replicas
    from kmc_tpu_torch.parallel.ensemble import (init_replicas,
                                                 make_ensemble_chunk)
    from kmc_tpu_torch.parallel.mesh import (replica_mesh, replica_sharding,
                                             shard_replicated_state)

    mesh = replica_mesh(device)
    native = os.path.join(args.out, "ensemble_checkpoint.npz")
    state = None
    if args.resume in ("auto", "native") and os.path.exists(native):
        state = load_native(native, mesh.device)
    n_rep = args.replicas if state is None else state.step.shape[0]
    sharded = mesh.size > 1 and n_rep % mesh.size == 0
    if mesh.rank != 0 and not sharded:
        return 0                       # rank 0 runs the whole ensemble
    lead = mesh.rank == 0
    if state is not None:
        if lead:
            print(f"resuming ensemble from {native} at step "
                  f"{int(state.step[0])}")
        if sharded:
            state = shard_replicated_state(state, mesh)
    fresh = state is None
    if fresh:
        block = (replica_sharding(mesh, n_rep) if sharded
                 else slice(0, n_rep))
        state = init_replicas(cfg, range(block.start, block.stop),
                              seed=args.seed, device=mesh.device)

    outputs = EnsembleOutputSet(args.out, cfg, fresh=fresh) if lead else None
    chunk = make_ensemble_chunk(cfg, cfg.out_every, mesh.device)
    n_steps = args.steps if args.steps is not None else cfg.simu_step
    t0 = time.perf_counter()
    done = 0
    try:
        while done < n_steps:
            state, obs = chunk(state)
            done += cfg.out_every
            everyone = gather_replicas(obs) if sharded else obs
            whole = gather_replicas(state) if sharded else state
            if not lead:
                continue
            outputs(state, everyone)
            save_native(native, whole, batched=True)
            if not args.quiet:
                rate = done * n_rep / max(time.perf_counter() - t0, 1e-9)
                print(f"step {int(state.step[0]) - 1} x{n_rep}  "
                      f"rate={rate:,.0f} replica-steps/s", file=sys.stderr)
    finally:
        if outputs is not None:
            outputs.close()
    if lead and not args.quiet:
        print(f"done at step {int(state.step[0]) - 1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
