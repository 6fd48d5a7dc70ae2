#!/usr/bin/env python
"""One rank of a multi-process ensemble run (port of the JAX package's
``scripts/distributed_worker.py``).

    python -m kmc_tpu_torch.scripts.distributed_worker --pid P --nproc N \\
        --port PORT --out stats.json [--device cpu] [--steps 30] ...

Each rank owns ``--replicas-per-host`` replicas (rank p of N starts the
block ``init_ensemble(cfg, replicas_per_host, seed=seed * N + p)``, as
``parallel/distributed.py:host_local_ensemble`` defines it) and joins the
group at ``127.0.0.1:PORT``: NCCL between cards, one card a rank, or gloo
between CPU processes with ``--device cpu``.  There is no fallback: with
the default ``--device cuda`` and no card the rank raises before it
writes anything.

The configuration is the JAX script's (``run_config``: 24 receptors + 8
ligands, ``fused_align=False``, so the align runs as the unfused tensor
code, as it did in the JAX script); at a configuration with the fused
align, such as ``SimConfig()``, the card runs K1 on the rank's whole
block once a step.

Default mode: ``--steps`` eager steps; rank 0 writes the JAX script's statistics to
``--out``: ``bond_sum`` (the last step's bonds over every replica),
``xy_checksum`` (the float64 sum of every replica's ``a_xy``), ``step``,
``replicas_global`` and, with ``--bench-repeats``, ``bench`` (replica-
steps/s over that many more chunks), plus ``device`` and ``seconds``.

With ``--e2e-out-dir`` the rank runs the production loop instead
(``run_e2e``): per output interval, ``--out-every`` eager steps; the
global ``bond_ens.dat`` row (``t`` the latest ``time_ns``, each column's
mean, std, min and max over every replica, made on rank 0 from the
gathered columns); and a per-rank shard file
``checkpoint.shard{rank}.npz`` (``leaf{i}`` in SimState order with the
key as uint32 words, the layout of the JAX package's shard and of the
validation state file, and ``k_done``).  ``--resume`` continues from the
shard files; the time axis goes on without a gap.  Each rank writes
``timing.pid{rank}.json`` with the JAX script's keys.  Its
``first_interval_s_incl_compile`` keeps its name: in the port it holds
the first build and load of the kernels (nvcc of ``csrc/*.cu``, reused
from ``_build/`` when present), not an XLA compile.  The card is
synchronised before every clock read, so no step time leaks into the
collect or checkpoint seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.parallel import distributed
from kmc_tpu_torch.parallel.mesh import rank_device, world
from kmc_tpu_torch.scripts.validate_vs_reference import (device_label,
                                                         load_state,
                                                         state_arrays)

COLS = ("bond_rl", "bond_mono_cis", "bond_cis", "bond_num",
        "cluster_size", "max_complex")
HEADER = "# t_ns " + " ".join(
    f"{c}_mean {c}_std {c}_min {c}_max" for c in COLS) + "\n"
# the JAX script's configuration: 24 receptors + 8 ligands in a 2000 x
# 2000 x 600 A box, the unfused align
DIST_CFG = dict(n_a=24, n_b=8, cell_range_x=2000.0, cell_range_y=2000.0,
                cell_range_z=600.0, fused_align=False)


def run_config() -> SimConfig:
    return SimConfig(**DIST_CFG)


def _clock(dev) -> float:
    """The host clock after the card has finished what was issued."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def shard_path(out_dir, rank: int) -> str:
    return os.path.join(out_dir, f"checkpoint.shard{rank}.npz")


def save_sharded_checkpoint(out_dir, state, k_done) -> float:
    """This rank writes its own replica block, through ``.tmp{rank}`` and
    an atomic rename; no data moves between ranks.  Returns the seconds
    spent (the device-to-host copy included)."""
    t0 = time.perf_counter()
    rank = world()[0]
    arrs = state_arrays(state)
    arrs["k_done"] = np.asarray(k_done)
    path = shard_path(out_dir, rank)
    tmp = path + f".tmp{rank}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)
    return time.perf_counter() - t0


def load_sharded_checkpoint(out_dir, device=None):
    """(state, k_done) of this rank's shard file, the block on
    ``device``."""
    with np.load(shard_path(out_dir, world()[0])) as z:
        return load_state(z, device), int(z["k_done"])


def ensemble_row(obs):
    """The global ``bond_ens.dat`` row of the ranks' observables, on rank
    0 (None on the others): ``t`` the maximum of ``time_ns``, and each
    column's mean, std (ddof 0), min and max in float32, the JAX script's
    formula over the gathered replicas, so the row does not depend on the
    number of ranks."""
    parts = distributed.gather_to_rank0(
        [obs.time_ns] + [getattr(obs, c) for c in COLS])
    if parts is None:
        return None
    t, *vals = (p.cpu().numpy() for p in parts)
    row = {"t": np.max(t)}
    for c, v in zip(COLS, vals):
        v = v.astype(np.float32)
        row[c] = np.stack([np.mean(v), np.std(v), np.min(v), np.max(v)])
    return row


def format_row(row) -> str:
    return f"{float(row['t']):.3f} " + " ".join(
        " ".join(f"{x:.4f}" for x in row[c]) for c in COLS) + "\n"


def run_e2e(args, cfg: SimConfig) -> dict:
    """The multi-process production loop of ``cfg`` on this rank: per
    output interval, ``args.out_every`` eager steps, the global row
    appended to ``bond_ens.dat`` by rank 0, and this rank's shard file;
    with ``args.resume``, from the shard files.  Reads ``args.out_dir``,
    ``replicas_per_host``, ``seed``, ``outputs``, ``out_every``,
    ``resume`` and ``device``; returns the timing it writes to
    ``timing.pid{rank}.json``."""
    from kmc_tpu_torch.parallel.ensemble import make_ensemble_chunk

    start = time.perf_counter()
    rank, size = world()
    dev = rank_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    # one tiny collective before the first chunk, so the pairs of the
    # group are connected before the ranks part for the kernels' build
    distributed.all_hosts_mean(torch.ones(1, device=dev))
    if args.resume:
        # the block comes from the file alone: nothing is seeded anew
        state, k0 = load_sharded_checkpoint(args.out_dir, dev)
    else:
        state = distributed.host_local_ensemble(
            cfg, args.replicas_per_host, seed=args.seed, device=dev)
        k0 = 0
    chunk = make_ensemble_chunk(cfg, args.out_every, device=dev)

    ens_path = os.path.join(args.out_dir, "bond_ens.dat")
    if k0 == 0 and rank == 0:
        with open(ens_path, "w") as f:
            f.write(HEADER)

    t_step, t_collect, t_ckpt = [], [], []
    for k in range(k0, k0 + args.outputs):
        t0 = _clock(dev)
        state, obs = chunk(state)
        t1 = _clock(dev)
        row = ensemble_row(obs)
        t2 = _clock(dev)
        if rank == 0:
            with open(ens_path, "a") as f:
                f.write(format_row(row))
        t_ckpt.append(save_sharded_checkpoint(args.out_dir, state, k + 1))
        t_step.append(t1 - t0)
        t_collect.append(t2 - t1)

    # interval 0 holds the kernels' build and load; steady-state means
    ss = slice(1, None) if len(t_step) > 1 else slice(None)
    step_s, collect_s, ckpt_s = (float(np.mean(t[ss]))
                                 for t in (t_step, t_collect, t_ckpt))
    stats = {
        "nproc": size,
        "pid": rank,
        "replicas_global": args.replicas_per_host * size,
        "outputs": args.outputs,
        "out_every": args.out_every,
        "resumed_at": k0,
        "final_step": int(state.step.max()),
        "first_interval_s_incl_compile": float(t_step[0] + t_collect[0]
                                               + t_ckpt[0]),
        "step_s_per_interval": step_s,
        "collect_s_per_interval": collect_s,
        "checkpoint_s_per_interval": ckpt_s,
        "machinery_fraction": (collect_s + ckpt_s)
        / max(step_s + collect_s + ckpt_s, 1e-12),
        "device": device_label(dev),
        "seconds": time.perf_counter() - start,
    }
    with open(os.path.join(args.out_dir, f"timing.pid{rank}.json"),
              "w") as f:
        json.dump(stats, f)
    return stats


def advance_blocks(cfg: SimConfig, replicas_per_host: int, steps: int,
                   seed: int, device):
    """This rank's ``host_local_ensemble`` block after ``steps`` eager
    steps: (state, the last step's observables, the chunk)."""
    from kmc_tpu_torch.parallel.ensemble import make_ensemble_chunk

    state = distributed.host_local_ensemble(cfg, replicas_per_host,
                                            seed=seed, device=device)
    chunk = make_ensemble_chunk(cfg, steps, state.step.device)
    state, obs = chunk(state)
    return state, obs, chunk


def run_stats(args, cfg: SimConfig) -> dict | None:
    """The default mode: the JAX script's statistics, on rank 0 (None on
    the others)."""
    start = time.perf_counter()
    rank, size = world()
    dev = rank_device(args.device)
    state, obs, chunk = advance_blocks(cfg, args.replicas_per_host,
                                       args.steps, args.seed, dev)
    bench = None
    if args.bench_repeats:
        t0 = _clock(dev)
        for _ in range(args.bench_repeats):
            state, obs = chunk(state)
        dt = _clock(dev) - t0
        glob = args.replicas_per_host * size
        bench = {
            "nproc": size,
            "replicas_global": glob,
            "steps_timed": args.bench_repeats * args.steps,
            "replica_steps_per_s": glob * args.bench_repeats * args.steps
            / dt,
        }
    parts = distributed.gather_to_rank0([obs.bond_num, state.a_xy,
                                         state.step])
    if parts is None:
        return None
    bonds, xy, step = (p.cpu().numpy() for p in parts)
    stats = {
        "bond_sum": float(np.sum(bonds)),
        "xy_checksum": float(np.sum(xy.astype(np.float64))),
        "step": float(np.max(step)),
        "replicas_global": args.replicas_per_host * size,
    }
    if bench is not None:
        stats["bench"] = bench
    stats["device"] = device_label(dev)
    stats["seconds"] = time.perf_counter() - start
    return stats


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="kmc_tpu_torch.scripts."
                                 "distributed_worker", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--replicas-per-host", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench-repeats", type=int, default=0,
                    help="after the first chunk, time this many more "
                         "chunks and report global replica-steps/s")
    ap.add_argument("--e2e-out-dir", dest="out_dir", default=None,
                    help="run the production loop (collective "
                         "bond_ens.dat, per-rank shard files, per-phase "
                         "timing) into this directory instead")
    ap.add_argument("--outputs", type=int, default=4,
                    help="e2e: output intervals to run")
    ap.add_argument("--out-every", type=int, default=200,
                    help="e2e: steps per output interval")
    ap.add_argument("--resume", action="store_true",
                    help="e2e: resume from the shard files")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, one card a rank (raises without a "
                         "card); cpu: gloo")
    return ap


def main(argv=None) -> int:
    from kmc_tpu_torch.state import resolve_device

    args = parser().parse_args(argv)
    resolve_device(args.device)        # no card: raise before anything
    # the ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // args.nproc))
    distributed.initialize(coordinator=f"127.0.0.1:{args.port}",
                           num_processes=args.nproc, process_id=args.pid,
                           device=args.device)
    try:
        if world() != (args.pid, args.nproc):
            raise RuntimeError(f"joined as rank {world()[0]} of "
                               f"{world()[1]}, asked for {args.pid} of "
                               f"{args.nproc}")
        cfg = run_config()
        if args.out_dir:
            stats = run_e2e(args, cfg)
        else:
            stats = run_stats(args, cfg)
            if stats is not None:
                with open(args.out, "w") as f:
                    json.dump(stats, f)
    finally:
        distributed.shutdown()
    print(json.dumps({"pid": args.pid, **(stats or {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
