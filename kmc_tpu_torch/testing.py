"""Inputs for checking the port's kernels against their plain versions:
replica states with random bonded topologies, made from a seed, and the
inputs of K1 and K2 formed from them exactly as the main paths form
them; the ulp-tie rule under which two rejection-free trajectories may
part; the halo-padded blocks of a grid cut over a rank grid, as K3 takes
them on a shard; and one rank of the multi-process checks
(``python -m kmc_tpu_torch.testing {cli,ensemble,halo,worker}``, started
by ``parallel/launch.py``)."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import LatticeConfig, SimConfig
from kmc_tpu_torch.engine.align import _choose_roots
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.lattice.grid import LatticeState
from kmc_tpu_torch.lattice.rejection_free import _scores, event_rates
from kmc_tpu_torch.models.tnfr import ligand_template
from kmc_tpu_torch.parallel.ensemble import init_ensemble
# the multi-process ensemble's configuration, the worker's
from kmc_tpu_torch.scripts.distributed_worker import DIST_CFG
from kmc_tpu_torch.state import SimState


def bonded_state(cfg: SimConfig, n_rep: int, seed: int, device) -> SimState:
    """Cold-start poses with a random mutual topology: each ligand binds up
    to three receptors (while free receptors last) and random receptor
    pairs are cis-bonded, so complexes span several ligands and some chains
    run deeper than align_depth.  Half the ligands are marked laid."""
    st = init_ensemble(cfg, n_rep, seed=seed, device=device)
    g = np.random.default_rng(seed)
    na, nb = cfg.n_a, cfg.n_b
    a_trans = np.full((n_rep, na), -1, np.int32)
    a_site = np.full((n_rep, na), -1, np.int32)
    a_cis = np.full((n_rep, na), -1, np.int32)
    b_partner = np.full((n_rep, nb, 3), -1, np.int32)
    for r in range(n_rep):
        free = list(g.permutation(na))
        for b in range(nb):
            for s in range(int(g.integers(0, 4))):
                if not free:
                    break
                a = free.pop()
                a_trans[r, a], a_site[r, a] = na + b, s + 1
                b_partner[r, b, s] = a
        pairs = g.permutation(na)[: 2 * int(g.integers(1, na // 2 + 1))]
        for a1, a2 in pairs.reshape(-1, 2):
            a_cis[r, a1], a_cis[r, a2] = a2, a1

    def dev(x):
        return torch.from_numpy(x).to(device)

    return st._replace(a_trans=dev(a_trans), a_site=dev(a_site),
                       a_cis=dev(a_cis), b_partner=dev(b_partner),
                       b_laid=dev(g.random((n_rep, nb)) < 0.5))


def align_core_inputs(st: SimState, cfg: SimConfig) -> list[torch.Tensor]:
    """K1's eleven inputs for every replica of ``st``: roots from the align
    stream of each replica's current step, act = cluster size > 1
    (engine/align.idealize_fused, ops/align_batched.align_core)."""
    i32 = torch.int32
    info = cluster_labels(st, cfg)
    skey = rng.stream_key(rng.step_key(st.key, st.step), rng.STREAM_ALIGN)
    root = _choose_roots(st, info, skey, cfg)
    a_dir = torch.stack([torch.cos(st.a_psi), torch.sin(st.a_psi)], -1)
    return [st.a_xy.contiguous(), a_dir, st.b_center.contiguous(),
            st.b_quat.contiguous(), st.a_trans.contiguous(),
            st.a_site.contiguous(), st.a_cis.contiguous(),
            st.b_partner.contiguous(), st.b_laid.to(i32),
            root.to(i32), (info.size > 1).to(i32)]


def align_core_single_inputs(st: SimState,
                             cfg: SimConfig) -> list[torch.Tensor]:
    """K2's twelve inputs for the one replica of ``st``: K1's inputs as
    [n, 1] columns and the ligand template (ops/align.align_core)."""
    if st.step.shape[0] != 1:
        raise ValueError(f"K2 takes one replica, got {st.step.shape[0]}")
    (a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis, b_partner,
     b_laid, root, act) = (x[0] for x in align_core_inputs(st, cfg))
    a_trans, a_site, a_cis, b_laid, root, act = (
        x[:, None].contiguous() for x in (a_trans, a_site, a_cis, b_laid,
                                          root, act))
    return [a_xy.contiguous(), a_dir.contiguous(), b_center.contiguous(),
            b_quat.contiguous(), a_trans, a_site, a_cis,
            b_partner.contiguous(), b_laid, root, act,
            ligand_template(cfg, st.a_xy.device).contiguous()]


def rf_tie(state: LatticeState, cfg: LatticeConfig,
           k_events: int | None = None, ulps: int = 2) -> bool:
    """Whether the rejection-free selection from ``state`` sits on an ulp
    tie: two scores adjacent in the descending order of the best
    ``k_events`` + 1 (the best two for the serial step) lie within
    ``ulps`` ulps of each other.  float32 ``log`` differs by an ulp
    between libraries, so two correct trajectories may part only from
    such a state."""
    scores = _scores(state, event_rates(state.grid, cfg)).reshape(-1)
    top = torch.sort(scores, descending=True).values[:(k_events or 1) + 1]
    top = top[torch.isfinite(top)]
    a = top[:-1].abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    gap = top[:-1].double() - top[1:].double()
    return bool((gap <= ulps * ulp.double()).any())


def rf_against_cpu(step, state: LatticeState, cfg: LatticeConfig, n: int,
                   k_events: int | None = None, time_rtol: float = 1e-5):
    """Advance ``state`` (on the card) and a CPU copy ``n`` times with
    ``step`` (``rf_step`` or a batch step), comparing after every call:
    grid, disp and step equal, time within ``time_rtol`` relative.

    Returns (calls compared, the call at which the two parted on an ulp
    tie or None, the worst relative time difference).  At a parting both
    sides' scores are recomputed from the common state; it is admitted
    only at an ulp tie of the CPU's (``rf_tie``), and the comparison stops
    there.  Any other difference raises AssertionError."""
    from kmc_tpu_torch import convert

    cpu = convert.lattice_from_numpy(convert.lattice_to_numpy(state))
    worst = 0.0
    for i in range(n):
        common, common_dev = cpu, state
        state, cpu = step(state), step(cpu)
        if not all(torch.equal(getattr(state, f).cpu(), getattr(cpu, f))
                   for f in ("grid", "disp", "step")):
            ties = (rf_tie(common, cfg, k_events),
                    rf_tie(common_dev, cfg, k_events))
            if ties[0]:
                return i, i, worst
            raise AssertionError(f"rejection-free call {i}: the card and "
                                 "the CPU parted without an ulp tie (tie "
                                 f"in the CPU's, the card's scores: {ties})")
        t_dev, t_cpu = float(state.time), float(cpu.time)
        rel = abs(t_dev - t_cpu) / max(abs(t_cpu), 1e-30)
        worst = max(worst, rel)
        if rel > time_rtol:
            raise AssertionError(f"rejection-free call {i}: time {t_dev} "
                                 f"on the card, {t_cpu} on the CPU")
    return n, None, worst


def halo_blocks(x, shape, width: int = 4):
    """The halo-padded blocks of a whole grid ``x`` [H, W(, c)] cut over an
    (nx, ny) rank grid, by periodic indexing, as ``parallel/halo.py`` would
    give each rank: [(row0, col0, block)] in rank order, ``block``
    [H / nx + 2 width, W / ny + 2 width(, c)] holding the global cells from
    (row0 - width, col0 - width)."""
    nx, ny = shape
    h, w = x.shape[0] // nx, x.shape[1] // ny
    out = []
    for ix in range(nx):
        rows = torch.arange(ix * h - width, (ix + 1) * h + width,
                            device=x.device) % x.shape[0]
        for iy in range(ny):
            cols = torch.arange(iy * w - width, (iy + 1) * w + width,
                                device=x.device) % x.shape[1]
            out.append((ix * h, iy * w, x[rows][:, cols].contiguous()))
    return out


def step_halo_blocks(state: LatticeState, cfg: LatticeConfig, shape,
                     step_arrays, width: int = 4):
    """One step of a whole-grid state done block by block: each padded
    block of ``halo_blocks`` stepped by ``step_arrays`` (K3's wrapper or
    its plain version) at its global origin, cropped and put back.
    Returns (grid, disp, the padded outputs)."""
    grid, disp = torch.empty_like(state.grid), torch.empty_like(state.disp)
    outs = []
    for (r0, c0, g), (_, _, d) in zip(halo_blocks(state.grid, shape, width),
                                      halo_blocks(state.disp, shape, width)):
        og, od = step_arrays(g, d, state.step, state.seed, cfg, r0 - width,
                             c0 - width)
        outs.append((og, od))
        h, w = og.shape[0] - 2 * width, og.shape[1] - 2 * width
        grid[r0:r0 + h, c0:c0 + w] = og[width:-width, width:-width]
        disp[r0:r0 + h, c0:c0 + w] = od[width:-width, width:-width]
    return grid, disp, outs


# ---------------------------------------------------------------------------
# One rank of a multi-process check, started N times by
# ``parallel/launch.py``:
#
#     python -m kmc_tpu_torch.testing cli -- <cli arguments>
#     python -m kmc_tpu_torch.testing ensemble --out DIR ...
#     python -m kmc_tpu_torch.testing halo --shape 2 2 ...
#     python -m kmc_tpu_torch.testing worker -- <worker arguments>
#
# Each prints one JSON line of its results last.


def _launch_counts() -> dict:
    from kmc_tpu_torch.ops import align, align_batched, lattice

    k1 = align_batched.align_core_batched
    return {"k1": k1.launches, "k1_replicas": k1.replicas,
            "k2": align.align_core_single.launches,
            "k3": lattice.lattice_block_call.launches}


def _rank_cli(args) -> dict:
    """The command line as this rank, on a group formed and warmed (one
    all-reduce) before it starts; its kernel launch counts, the seconds
    cli.main took, the seconds the group took to form, and the seconds
    and steps of the chunks after the first (each ensemble chunk's start
    is read on the host clock; the first chunk and its outputs hold the
    warm-up)."""
    import time

    from kmc_tpu_torch import cli
    from kmc_tpu_torch.parallel import distributed, ensemble

    rest = args.rest
    dev = rest[rest.index("--device") + 1] if "--device" in rest else "cuda"
    make_chunk, starts = ensemble.make_ensemble_chunk, []

    def clocked(cfg, n_steps, *a, **k):
        chunk = make_chunk(cfg, n_steps, *a, **k)

        def f(state):
            starts.append((time.perf_counter(), n_steps))
            return chunk(state)

        return f

    t = time.perf_counter()
    joined = distributed.initialize(device=dev)
    ensemble.make_ensemble_chunk = clocked
    try:
        distributed.all_hosts_mean(torch.ones(1))
        join = time.perf_counter() - t
        t = time.perf_counter()
        rc = cli.main(rest)                  # on the group formed above
        end = time.perf_counter()
    finally:
        ensemble.make_ensemble_chunk = make_chunk
        if joined:
            distributed.shutdown()
    if rc != 0:
        raise SystemExit(rc)
    out = {**_launch_counts(), "seconds": end - t, "join_seconds": join}
    if len(starts) > 1:
        out.update(steady_seconds=end - starts[1][0],
                   steady_steps=sum(n for _, n in starts[1:]))
    return out


def _rank_ensemble(args) -> dict:
    """host_local_ensemble + the eager chunk (the worker's default mode);
    each rank writes its block and last observables to rank<p>.npz, rank 0
    the gathered observables to merged.npz."""
    from kmc_tpu_torch import convert
    from kmc_tpu_torch.parallel.distributed import (all_hosts_mean,
                                                    gather_replicas)
    from kmc_tpu_torch.parallel.mesh import world
    from kmc_tpu_torch.scripts.distributed_worker import advance_blocks

    st, obs, _ = advance_blocks(SimConfig(**DIST_CFG), args.replicas_per_host,
                                args.steps, args.seed, args.device)
    rank = world()[0]
    arrays = convert.to_numpy(st)
    arrays.update({f"obs_{k}": v.cpu().numpy()
                   for k, v in obs._asdict().items()})
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **arrays)
    merged = gather_replicas(obs)
    mean = all_hosts_mean(obs.bond_num.to(torch.float32).mean())
    if merged is not None:
        np.savez(os.path.join(args.out, "merged.npz"),
                 **{k: v.cpu().numpy() for k, v in merged._asdict().items()})
    return {"bond_num_mean": float(mean)}


def _rank_worker(args) -> dict:
    """scripts/distributed_worker.py as this rank, in this process (it
    forms and leaves the group itself), at SimConfig() rather than the
    worker's small configuration; its kernel launch counts."""
    from kmc_tpu_torch.scripts import distributed_worker

    saved = distributed_worker.run_config
    distributed_worker.run_config = SimConfig
    try:
        rc = distributed_worker.main(args.rest)
    finally:
        distributed_worker.run_config = saved
    if rc != 0:
        raise SystemExit(rc)
    return _launch_counts()


def _rank_halo(args) -> dict:
    """A grid cut over an (nx, ny) rank grid, stepped by one of the halo
    forms; rank 0 gathers the grid and, with --check, holds it to the
    whole grid stepped on its own device (K3 on the card, the plain
    version on the CPU), and with --save writes it."""
    from kmc_tpu_torch import convert
    from kmc_tpu_torch.config import LatticeConfig
    from kmc_tpu_torch.lattice.grid import init_lattice
    from kmc_tpu_torch.lattice.step import (make_lattice_chunk,
                                            make_sharded_lattice_step)
    from kmc_tpu_torch.ops import lattice as k3
    from kmc_tpu_torch.parallel import halo
    from kmc_tpu_torch.parallel.mesh import grid_mesh

    cfg = LatticeConfig(height=args.height, width=args.width,
                        density=args.density, ass_prob=args.ass,
                        diss_prob=args.diss)
    mesh = grid_mesh(args.shape, args.device)
    whole = init_lattice(cfg, seed=args.seed, device=mesh.device)
    st = halo.shard_lattice(whole, cfg, mesh)
    if args.form == "sharded":
        calls = [make_sharded_lattice_step(cfg, mesh, args.chunk)] * (
            args.steps // args.chunk)
    else:
        make = (halo.make_halo_lattice_step if args.form == "plain"
                else halo.make_halo_pallas_step)
        calls = [make(cfg, mesh)] * args.steps
    k3.lattice_block_call.launches = 0
    for call in calls:
        st = call(st)
    _sync(mesh.device)
    out = {"k3": k3.lattice_block_call.launches}
    got = halo.gather_lattice(st, cfg, mesh)
    if args.time:          # after the gather, which brings the ranks level
        out["split_ms"] = _halo_split(cfg, mesh, st, args.time)
    if got is not None and args.check:
        chunk = (k3.make_pallas_lattice_chunk if mesh.device.type == "cuda"
                 else make_lattice_chunk)(cfg, args.steps)
        want = chunk(whole)
        out["equal"] = all(torch.equal(getattr(got, f), getattr(want, f))
                           for f in got._fields)
        out["particles"] = int(got.grid.sum())
    if got is not None and args.save:
        np.savez(os.path.join(args.save, "halo.npz"),
                 **convert.lattice_to_numpy(got))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _halo_split(cfg, mesh, st, steps: int) -> dict:
    """Milliseconds a step of the real halo calls over ``steps`` steps:
    the wall time of one ``make_sharded_lattice_step(cfg, mesh, steps)``
    call and of ``steps`` calls of ``make_halo_pallas_step`` (CUDA events
    around the calls on the card, the host clock on the CPU; no sync
    between steps), after one warm-up call of each; then one profiler
    trace of the same sharded call, its device time (host time on the
    CPU) split by the halo module's ranges (``halo.pad``, ``halo.refresh``,
    ``halo.crop``) and, among its kernels, K3's and the exchange's
    (NCCL)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from kmc_tpu_torch.lattice.step import make_sharded_lattice_step
    from kmc_tpu_torch.parallel import halo
    from kmc_tpu_torch.parallel.distributed import all_hosts_mean

    dev = mesh.device
    cuda = dev.type == "cuda"
    sharded = make_sharded_lattice_step(cfg, mesh, steps)
    single = halo.make_halo_pallas_step(cfg, mesh)

    def pallas_steps(s):
        for _ in range(steps):
            s = single(s)
        return s

    def level():
        """Bring the ranks level before a measurement."""
        all_hosts_mean(torch.ones(1, device=dev))
        _sync(dev)

    def wall_ms(fn):
        fn(st)                                   # warm-up
        level()
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(st)
            b.record()
            _sync(dev)
            return a.elapsed_time(b) / steps
        t = time.perf_counter()
        fn(st)
        return 1e3 * (time.perf_counter() - t) / steps

    split = {"sharded_step_wall": wall_ms(sharded),
             "halo_step_wall": wall_ms(pallas_steps)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    level()
    with profile(activities=acts) as prof:
        sharded(st)
        _sync(dev)
    rows = prof.key_averages()
    for e in rows:      # the ranges on the host; their kernels' device time
        if e.key.startswith("halo.") and str(e.device_type).endswith("CPU"):
            us = e.device_time_total if cuda else e.cpu_time_total
            if us > 0:                  # 0: the trace did not attribute it
                split[e.key.replace(".", "_")] = us / 1e3 / steps
    if cuda:            # the kernels (a range's span on the card is not one)
        kernels = [e for e in rows if str(e.device_type).endswith("CUDA")
                   and not e.key.startswith("halo.")]
        split["trace_k3"] = sum(e.self_device_time_total for e in kernels
                                if "lattice_step_kernel" in e.key) / 1e3 / steps
        split["trace_nccl"] = sum(e.self_device_time_total for e in kernels
                                  if "nccl" in e.key.lower()) / 1e3 / steps
        split["trace_all"] = sum(e.self_device_time_total
                                 for e in kernels) / 1e3 / steps
    return split


def rank_main(argv=None) -> int:
    import argparse
    import json

    from kmc_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser(prog="kmc_tpu_torch.testing")
    ap.add_argument("task", choices=["cli", "ensemble", "halo", "worker"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--replicas-per-host", type=int, default=4)
    ap.add_argument("--shape", type=int, nargs=2, default=(1, 1))
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.12)
    ap.add_argument("--ass", type=float, default=0.25)
    ap.add_argument("--diss", type=float, default=0.08)
    ap.add_argument("--form", choices=["plain", "pallas", "sharded"],
                    default="sharded")
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--time", type=int, default=0)
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args = ap.parse_args(argv[:cut])
    args.rest = argv[cut + 1:]      # the CLI's or the worker's arguments
    torch.set_num_threads(1)             # the ranks share the host's cores
    if args.task in ("cli", "worker"):
        out = (_rank_cli if args.task == "cli" else _rank_worker)(args)
    else:
        joined = distributed.initialize(device=args.device, timeout=120)
        try:
            out = (_rank_ensemble if args.task == "ensemble"
                   else _rank_halo)(args)
        finally:
            if joined:
                distributed.shutdown()
    print(json.dumps({"rank": int(os.environ.get("KMC_PROCESS_ID", 0)),
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
