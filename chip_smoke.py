#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmc_tpu_torch) on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device (phases 19 and 21 start a rank on each visible
card), the CUDA toolkit (nvcc) and the repository around this file;
without a card it exits nonzero and prints no result.  It finishes in a
few minutes, the kernel build included, and prints one line per phase
with the seconds since start:

1. device: the card's name, count and power limit; TF32 off;
2. build: nvcc builds the kernels, one process per source, all at once
   (seconds, registers, shared memory);
3. kernel vs plain: K1 (csrc/align_batched.cu) against its plain PyTorch
   version at the reference size (150 + 50 molecules) on bonded replicas
   (B = 64 and 512), on a mature state of the C++ reference
   (tests/data/ref_position.cpt) broadcast to B = 64 and 512 with
   distinct keys, and on a trans-only and a bond-free replica; K2
   (csrc/align.cu) on bonded single replicas of several seeds, on the
   mature state, trans-only and bond-free; all to the bit, each with the
   passes its level loop runs;
4. main path: init_ensemble(SimConfig(), 512, seed=0) on the card, then
   the lazy ensemble chunk with k_align = 64: 2 warm-up + 20 timed steps;
   K1 launches must equal the step count, K2 none; state finite and bonds
   mutual;
5. single trajectory: the port's CLI in-process at SimConfig(), 100 steps
   at out_every = 50, then a resume to 150 more; the reference-format
   files must be there with the right rows and frames, and K2 must launch
   once per step, K1 never;
6. ensemble CLI: --replicas 512 --steps 20 at out_every = 10; K1 must
   launch once per step at B = 512, K2 never;
7. reference checks: on a small dense system, one card step from each of
   10 states of a trajectory against the plain CPU path from the same
   state, for the lazy ensemble step and for the single-trajectory
   step_fn (topology, flags, keys bitwise; poses within 1e-4 A);
8. K1 and K2 timing: each kernel's device time (torch.profiler) and a
   wrapper call (CUDA events), beside the plain version, the bound (bytes
   over 3.35 TB/s, operations over 67 TFLOP/s) and the previous design's
   time: K1 at B = 64 and 512, K2, each on the bonded and the mature-state
   inputs; K2's device time by the passes its level loop runs; and the
   device time of a one-element add_, the floor of a one-block launch on
   this card;
9. where the time goes: each stage of the step timed alone by CUDA
   events, and torch.profiler over one main-path step (device busy share,
   top kernels);
10. K3 vs plain: the lattice kernel (csrc/lattice.cu) against its plain
    version lattice_step on the card, to the bit, every step: 64 steps at
    LatticeConfig() (512^2, density 0.04) and at a dense setting, 4 steps
    at 8192^2, 64 steps at 64 x 96; all 8 (hop axis, reaction direction)
    variants must occur;
11. lattice card vs CPU: 10 K3 steps at 512^2 against the plain version
    on the CPU from the same state, to the bit;
12. lattice CLI: --engine lattice --steps 2000 --out-every 500 at
    LatticeConfig(), then a resume to 1,000 more with --lattice-pallas;
    lattice.dat rows and the checkpoint must be there, and K3 must launch
    once per step, K1 and K2 never;
13. lattice physics: BASELINE config 2 (the mapped receptor lattice at
    512^2, 10,000 particles, no reactions), 1,500 K3 steps; the MSD per
    step within 10 % of the reference's 2 D dt / 9;
14. K3 timing: device time (torch.profiler) at 512^2 and 8192^2
    beside the first design's, a wrapper call (CUDA events), the plain
    version, and the bound (bytes over 3.35 TB/s, integer operations over
    16.7e12 a second);
15. rejection-free card vs CPU: 400 rf_step events at 64^2 (300
    particles) and 40 rf_batch_step batches at 128^2 (k = 64) under each
    thinning rule, compared after every call: grid, disp and step equal,
    time within 1e-5 relative; a parting is admitted only at an ulp tie
    (the CPU's two best scores within 2 ulp), whose index is printed;
16. rejection-free CLI: --engine lattice --lattice-rf --steps 2000
    --out-every 500 at LatticeConfig(), then a resume of 1,000 events;
    lattice.dat rows, time strictly increasing, particles conserved, and
    K1, K2 and K3 launch 0 times;
17. rejection-free throughput at 512^2: the serial make_rf_chunk(1000)
    (events/s, and the device-busy share from torch.profiler over one
    chunk), one event's launches, device time and call time by stage,
    make_rf_batch_chunk(100, k_events=64) under each thinning rule
    (events applied/s, kept events a batch), the stable sort's share of
    a batch;
18. parameter sweep: init_ensemble(SimConfig(), 512) with 8 values of
    p_trans_ass (0 to twice the default) and rb_a_d (0 and the default),
    64 replicas each; 5 step_fn and 5 step_fn_diag batched steps, K1 once
    a step, K2 never, free receptors still where rb_a_d = 0; step time
    with and without rp; the reference check of phase 7 with a
    per-replica rp for step_fn and step_fn_diag (diag counts exact); a
    single-trajectory step with rp=from_config(cfg), K2 once, bits equal
    to rp=None;
19. sharded ensemble CLI: one rank a visible card (W of them, started by
    kmc_tpu_torch/parallel/launch.py with the KMC_* variables), --replicas
    512 W --steps 20 at out_every = 10; its files equal, byte for byte
    (the checkpoint array for array), those of one process on one card:
    at W = 1 phase 6's, else one rank of 512 W replicas started alone on
    cuda:0; K1 once a step at B = 512 on every rank, K2 and K3 never; then
    a resume of 20 steps at the other launch (one process after W ranks;
    at W = 1 a launched rank) must equal 40 uninterrupted steps;
20. K3 on shards, on one card: the halo-padded blocks of a 1 x 1 (one
    card's shard, a block 8 cells larger than the grid), a 2 x 2 and a
    4 x 1 cut, taken from the whole grid by periodic indexing, at 8192^2
    (4 steps) and at 64 x 64 (64 steps, all 8 direction variants): K3 on
    each block at its negative origin (row0 - 4, col0 - 4) with the full
    grid's size equals the plain version on the same block, and the
    cropped blocks put together equal whole-grid K3, every step;
21. halo step through torch.distributed: on the squarest grid of W ranks
    (1 x 1 on one card, 2 x 2 on four), make_sharded_lattice_step at
    8192^2 (16 steps in chunks of 8) and at 64^2 (64 steps), and
    make_halo_pallas_step at 64^2 (64 steps); rank 0 gathers the grid and
    holds it bitwise to the whole-grid K3 chunk on its card; K3 once a
    step on every rank;
22. halo timing: K3's device time on the whole 8192^2 grid and on the
    padded shards of 8192^2 and 4096^2 (torch.profiler) beside the plain
    version and the bound; on each rank at 8192^2, the wall time a step of
    make_sharded_lattice_step(chunk 10) and of 10 make_halo_pallas_step
    calls (CUDA events around the calls), and one profiler trace of the
    sharded call split by the halo module's ranges (pad, ghost refresh,
    crop) and by kernel (K3, NCCL); the sharded ensemble CLI's
    replica-steps/s after its first output against one rank on one card;
23. validation driver: kmc_tpu_torch.scripts.validate_vs_reference
    kinetics at SimConfig(out_every=50) (run_config replaced inside the
    phase), 256 replicas, lazy, with histograms, against the oracle files
    of ref_data/ (rows 1-2; 50 steps are not an oracle row, so the
    report's verdict is printed, not gated): 2 outputs uninterrupted, K1
    once a step and K2, K3 never; every K1 call of that run (B = 32)
    bitwise equal to the plain version on the inputs the run gave it; the
    report's device equal to nvidia-smi's line; a run cut after output 1
    and resumed
    from its state file equal to it bitwise (series, histograms, final
    state); --report-only equal to the in-run report; the ported
    check_flagship_state passing on every replica; and the lazy step at
    256 replicas timed with CUDA events over 20 steps after 2 warm-ups,
    with the minutes an oracle row (5,000 steps) it implies, and one step
    under the profiler (device time, launches, busy share).

Each phase of a path sets every launch count to 0 before it runs the path
and reads the counts just after.  The last three lines are one JSON
object with one entry per kernel, the card's ``nvidia-smi`` name and
power limit, and the result line ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# H100 SXM 32-bit integer rate: 64 results a clock per SM for 32-bit
# integer add, multiply, shift and logic (NVIDIA's arithmetic-instruction
# throughput table, compute capability 9.0), 132 SMs, 1.98 GHz: 16.7e12
# operations a second, a multiply counted as one, as LATTICE_OPS_PER_CELL
# counts it
INT32_OPS = 132 * 64 * 1.98e9
# integer operations any design of K3 must do a cell: the counter (2); the
# two hop draws, u_hop and u_sgn, 23 each (2 adds, two avalanche rounds
# of 8, the re-key xor, 3 to form the uniform, the compare); 3 more for
# the hop draw's scaling; 6 to form the flags; about 10 in each of the
# four sub-passes.  The merge and split draws are made only where a pair
# can react, on a small share of the cells, and are not counted
LATTICE_OPS_PER_CELL = 2 + 2 * 23 + 3 + 6 + 4 * 10
# K3's device time (us) at 512^2 and 8192^2 in its first design (a block
# of 512 threads, runtime modulos and four hashes on every frame cell), on
# an NVIDIA H100 80GB HBM3 at 700 W; logged beside this run's
K3_FIRST_DESIGN_US = {512: 12.01, 8192: 2166.98}
# K1's (B = 64) and K2's device time (us) in their first design (align
# depth rounds and snap sweeps in series, 42 barriers a call), on an
# NVIDIA H100 80GB HBM3 at 700 W; logged beside this run's
ALIGN_FIRST_DESIGN_US = {"K1": 6.90, "K2": 5.49}
REF_CPT = os.path.join(REPO, "tests", "data", "ref_position.cpt")
LATTICE_STEPS, LATTICE_BIG, LATTICE_BIG_STEPS = 64, 8192, 4
LAT_CLI_STEPS, LAT_CLI_RESUME, LAT_CLI_OUT_EVERY = 2000, 1000, 500
LAT_MSD_STEPS, LAT_MSD_PARTICLES, LAT_SPACING = 1500, 10_000, 20.0
POS_TOL, ANG_TOL = 1e-4, 1e-5
REPLICAS, K_ALIGN, WARMUP, TIMED = 512, 64, 2, 20
SINGLE_STEPS, SINGLE_RESUME, SINGLE_OUT_EVERY = 100, 150, 50
ENS_STEPS, ENS_OUT_EVERY = 20, 10
K2_SEEDS = (1, 2, 3, 4)
RF_SERIAL_SIZE, RF_SERIAL_PARTICLES, RF_SERIAL_EVENTS = 64, 300, 400
RF_BATCH_SIZE, RF_BATCH_PARTICLES, RF_BATCH_CALLS, RF_K = 128, 1200, 40, 64
RF_CHUNK, RF_BATCHES = 1000, 100
SWEEP_GROUPS, SWEEP_STEPS = 8, 5
HALO_BIG_STEPS, HALO_TIME_STEPS = 16, 10
VAL_REPLICAS, VAL_OUT_EVERY, VAL_SUB_CHUNKS = 256, 50, 5
ORACLE_ROW_STEPS = 5000           # out_every of SimConfig(): one oracle row
VAL_REF_BOND = [os.path.join("ref_data", f"refgolden{i}_bond.dat")
                for i in ("", "2")]
VAL_REF_CLUSTER = [os.path.join("ref_data", f"refgolden{i}_cluster.log")
                   for i in ("", "2")]
# keys of the validation report that differ between two runs of one state
VAL_RUN_KEYS = ("seconds", "report_only_at_rows")
RANK_TIMEOUT = 600     # seconds a spawn of ranks may take before it fails
WORK = ""              # this run's temporary directory, made by main
PASS_DEPTHS = (1, 2, 4, 8, 12)   # seed 1 runs align_depth passes at each
DEVICE = "cuda"
CARD = ""          # nvidia-smi's "name, power.limit", set by the device phase


def log(phase: str, msg: str) -> None:
    """One line per phase: seconds since start, the card, the message."""
    card = f" [{CARD}]" if CARD else ""
    print(f"[{time.perf_counter() - T0:7.2f} s]{card} {phase}: {msg}",
          flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------

def compare_core(got, want, kernel="K1", exact=False):
    """Max abs error of the float outputs; fails on a miss (on any
    difference with ``exact``)."""
    names = ("a_xy", "a_dir", "snap", "b_center", "b_quat", "b_laid")
    tols = (POS_TOL, ANG_TOL, None, POS_TOL, ANG_TOL, None)
    worst = 0.0
    for name, g, w, tol in zip(names, got, want, tols):
        if tol is None:
            if not bool((g == w).all()):
                fail(f"{kernel} {name} differs from the plain version in "
                     f"{int((g != w).sum())} entries")
        else:
            err = float((g - w).abs().max())
            if err > tol or (exact and err != 0.0):
                fail(f"{kernel} {name} max abs error {err} > "
                     f"{0.0 if exact else tol}")
            worst = max(worst, err)
    return worst


def core_work(cfg, args, outs, passes):
    """(bytes, flops) the align core (K1 or K2) needs for these inputs:
    every input read once and every output written once; flops counted
    for the molecules this data snaps (about 70 per receptor seat, 40 per
    ligand re-seat or lay-down) plus, in each of the passes each replica
    runs (``passes``, from core_passes), the depth round's compare-and-add
    per neighbour entry."""
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *outs))
    snapped_a = int((outs[2] == 1).sum())
    laid_new = int(((outs[5] & 1) != args[8]).sum())
    depth_ops = 2 * int(passes.sum()) * (2 * cfg.n_a + 3 * cfg.n_b)
    return nbytes, 70 * snapped_a + 40 * laid_new + depth_ops


def as_batched(args2):
    """K2's twelve inputs as K1's eleven at B = 1."""
    return [a[:, 0][None] if i in (4, 5, 6, 8, 9, 10) else a[None]
            for i, a in enumerate(args2[:-1])]


def core_passes(args, cfg):
    """The passes the align core's level loop runs on K1's inputs ``args``,
    one per replica: BFS depth by min-propagation from the roots; the block
    leaves after the first pass that reaches no molecule, or after
    align_depth passes (csrc/align_core.cuh)."""
    import torch

    na, nb, inf = cfg.n_a, cfg.n_b, 30000
    a_trans, a_cis, b_partner, is_root = args[4], args[6], args[7], args[9]
    i_ab = torch.clamp(a_trans - na, 0, nb - 1).long()
    i_ac = torch.clamp(a_cis, 0, na - 1).long()
    i_bp = torch.clamp(b_partner, 0, na - 1).long()
    depth = torch.where(is_root == 1, 0, inf)
    passes = torch.full((depth.shape[0],), cfg.align_depth,
                        device=depth.device)
    done = torch.zeros_like(passes, dtype=torch.bool)
    for d in range(1, cfg.align_depth + 1):
        da, db = depth[:, :na], depth[:, na:]
        nda = torch.minimum(da, torch.minimum(
            torch.where(a_trans >= 0, db.gather(1, i_ab) + 1, inf),
            torch.where(a_cis >= 0, da.gather(1, i_ac) + 1, inf)))
        ndb = db
        for c in range(3):
            ndb = torch.minimum(ndb, torch.where(
                b_partner[..., c] >= 0, da.gather(1, i_bp[..., c]) + 1, inf))
        nd = torch.cat([nda, ndb], 1)
        changed = (nd != depth).any(1)
        passes = torch.where(~done & ~changed, d, passes)
        done |= ~changed
        depth = nd
    return passes.cpu()


def pass_summary(passes) -> str:
    """'8' for one replica, else 'min-max (mean m)'."""
    if passes.numel() == 1:
        return str(int(passes[0]))
    return (f"{int(passes.min())}-{int(passes.max())} (mean "
            f"{float(passes.float().mean()):.2f})")


def strip_bonds(st, keep_trans):
    """``st`` without its cis bonds, and without every bond unless
    ``keep_trans``: the shallow topologies (2 passes and 1)."""
    import torch

    none = torch.full_like
    st = st._replace(a_cis=none(st.a_cis, -1))
    if keep_trans:
        return st
    return st._replace(a_trans=none(st.a_trans, -1),
                       a_site=none(st.a_site, -1),
                       b_partner=none(st.b_partner, -1))


def ptxas_frames(report: str) -> list[str]:
    """'name: N bytes stack frame, N bytes spill stores, N bytes spill
    loads' for each kernel of an -Xptxas -v report."""
    lines, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "bytes stack frame" in line and name is not None:
            lines.append(f"{name}: {line.strip()}")
            name = None
    return lines


def cuda_time_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_kernels(fn):
    """Device-time rows (name, total us, count) of the CUDA kernels ``fn``
    launches, largest first, and the wall seconds ``fn`` took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1]), wall


def mutual(st, cfg) -> bool:
    """a_trans/a_site <-> b_partner and a_cis symmetry on every replica."""
    import torch

    na, nb = cfg.n_a, cfg.n_b
    has = st.a_trans >= 0
    b = torch.clamp(st.a_trans - na, 0, nb - 1).long()
    s = torch.clamp(st.a_site - 1, 0, 2).long()
    back = st.b_partner.reshape(st.b_partner.shape[0], -1).gather(1, b * 3 + s)
    ai = torch.arange(na, device=st.a_trans.device)
    ok = torch.where(has, back == ai, True).all()
    bp = st.b_partner.reshape(st.b_partner.shape[0], -1)
    pa = torch.clamp(bp, 0, na - 1).long()
    slot = torch.arange(nb * 3, device=bp.device)
    fwd = (st.a_trans.gather(1, pa) == na + slot // 3) & \
          (st.a_site.gather(1, pa) == slot % 3 + 1)
    ok &= torch.where(bp >= 0, fwd, True).all()
    has_c = st.a_cis >= 0
    pc = torch.clamp(st.a_cis, 0, na - 1).long()
    ok &= torch.where(has_c, (st.a_cis.gather(1, pc) == ai) & (pc != ai),
                      True).all()
    return bool(ok)


def reset_counts(k1, k2) -> None:
    """Every kernel's launch count to 0 (K3's too)."""
    k1.launches = 0
    k1.replicas = 0
    k2.launches = 0
    k3_wrapper().launches = 0


def k3_wrapper():
    from kmc_tpu_torch.ops import lattice

    return lattice.lattice_block_call


def single_cli_phase(cfg, dev, k1, k2):
    """The port's CLI, single trajectory, at SimConfig(): 100 steps, then a
    resume to 150 more.  Returns the K2 launches."""
    from kmc_tpu_torch import cli

    n_atoms = cfg.n_a * 4 + cfg.n_b * 3
    with tempfile.TemporaryDirectory(prefix="kmc_single_") as out:
        base = ["--out", out, "--seed", "0", "--device", dev.type,
                "--set", f"out_every={SINGLE_OUT_EVERY}", "--quiet"]
        runs = []
        reset_counts(k1, k2)
        for steps in (SINGLE_STEPS, SINGLE_RESUME):
            said = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = cli.main(["--steps", str(steps), *base])
            torch_sync()
            runs.append((steps, time.perf_counter() - t, said.getvalue()))
            if rc != 0:
                fail(f"single-trajectory CLI returned {rc}")
            if steps == SINGLE_STEPS:
                rows = read_lines(out, "bond.dat")
                if len(rows) != 2 or any(len(r.split()) != 7 for r in rows):
                    fail(f"bond.dat after {steps} steps: {rows}")
                gro = read_lines(out, "test.gro")
                frames = [i for i, r in enumerate(gro)
                          if r.startswith("Hello Gro!")]
                if (len(frames) != 2 or len(gro) != 2 * (n_atoms + 3)
                        or int(gro[1]) != n_atoms):
                    fail(f"test.gro: {len(frames)} frames, {len(gro)} lines "
                         f"(want 2 frames of {n_atoms} atoms)")
                for f in ("cluster.log", "hist.dat", "position.cpt",
                          "checkpoint.npz", "parameter.log"):
                    if not os.path.isfile(os.path.join(out, f)):
                        fail(f"single-trajectory CLI wrote no {f}")
        k1_n, k2_n, k3_n = k1.launches, k2.launches, k3_wrapper().launches
        if "resuming from" not in runs[1][2]:
            fail(f"second CLI run did not resume: {runs[1][2]!r}")
        times = [float(r.split()[0]) for r in read_lines(out, "bond.dat")]
        step_ns = SINGLE_OUT_EVERY * cfg.time_step
        want = [step_ns * (i + 1) for i in range(
            (SINGLE_STEPS + SINGLE_RESUME) // SINGLE_OUT_EVERY)]
        if times != want:
            fail(f"bond.dat time axis {times}, want {want}")
        last = read_lines(out, "bond.dat")[-1]
        from kmc_tpu_torch.io import native
        fmt = "native kmcio" if native.available() else "Python"
    steps = SINGLE_STEPS + SINGLE_RESUME
    for n, sec, _ in runs:
        log("single trajectory", f"cli.main --steps {n}: {sec:.3f} s = "
            f"{1e3 * sec / n:.2f} ms/step, {n / sec:.2f} steps/s (I/O every "
            f"{SINGLE_OUT_EVERY} steps included; first run includes the "
            "cold start)")
    log("single trajectory", f"K2 launches {k2_n} for {steps} steps, K1 "
        f"launches {k1_n}; bond.dat {len(times)} rows, t = {times[0]:.0f}.."
        f"{times[-1]:.0f} ns without a gap; last row '{last.strip()}'; "
        f"test.gro by the {fmt} formatter; resumed: "
        f"{runs[1][2].strip().splitlines()[0]}")
    if k2_n != steps or k1_n != 0 or k3_n != 0:
        fail(f"single trajectory: K2 launched {k2_n} times in {steps} steps "
             f"and K1 {k1_n}, K3 {k3_n} times (want {steps}, 0 and 0)")
    return k2_n


def ensemble_argv(out, replicas, steps):
    """The ensemble CLI's arguments of phases 6 and 19."""
    return ["--out", out, "--seed", "0", "--device", DEVICE,
            "--replicas", str(replicas), "--steps", str(steps),
            "--set", f"out_every={ENS_OUT_EVERY}", "--quiet"]


def run_cli(argv):
    """cli.main in this process; the seconds it took (fails on rc != 0)."""
    from kmc_tpu_torch import cli

    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    torch_sync()
    if rc != 0:
        fail(f"CLI {' '.join(argv)} returned {rc}")
    return time.perf_counter() - t


def ensemble_cli_phase(cfg, out, k1, k2):
    """The port's CLI, --replicas 512, 20 steps at out_every = 10, into
    ``out`` (phase 19 compares its own run with these files); returns
    the seconds it took."""
    reset_counts(k1, k2)
    sec = run_cli(ensemble_argv(out, REPLICAS, ENS_STEPS))
    k1_n, k1_reps, k2_n = k1.launches, k1.replicas, k2.launches
    k2_n += k3_wrapper().launches      # neither K2 nor K3 may launch
    rows = [r for r in read_lines(out, "bond_ens.dat")
            if not r.startswith("#")]
    if len(rows) != ENS_STEPS // ENS_OUT_EVERY:
        fail(f"bond_ens.dat has {len(rows)} rows")
    if not os.path.isfile(os.path.join(out, "ensemble_checkpoint.npz")):
        fail("ensemble CLI wrote no ensemble_checkpoint.npz")
    last = rows[-1].split()
    log("ensemble CLI", f"--replicas {REPLICAS} --steps {ENS_STEPS}: "
        f"{sec:.3f} s = {1e3 * sec / ENS_STEPS:.2f} ms/step, "
        f"{REPLICAS * ENS_STEPS / sec:.1f} replica-steps/s (cold start and "
        f"I/O every {ENS_OUT_EVERY} steps included); K1 launches {k1_n} "
        f"aligning {k1_reps} replicas, K2 + K3 launches {k2_n}; bond_ens.dat "
        f"{len(rows)} rows, last t = {last[0]} ns, mean rl {last[1]}")
    if k1_n != ENS_STEPS or k1_reps != ENS_STEPS * REPLICAS or k2_n != 0:
        fail(f"ensemble CLI: K1 {k1_n} launches over {k1_reps} replicas, "
             f"K2 + K3 {k2_n} (want {ENS_STEPS} at B = {REPLICAS}, and 0)")
    return sec


def torch_sync():
    import torch

    torch.cuda.synchronize()


def read_lines(out, name):
    with open(os.path.join(out, name)) as f:
        return f.read().splitlines()


def check_against_cpu(step, ref, dev, what):
    """One card step from each of 10 trajectory states against the plain
    CPU path from the same state; returns the worst pose difference.  A
    step that returns (state, obs, diag) has its diag counts compared
    too, exactly."""
    import torch
    from kmc_tpu_torch import convert

    worst = 0.0
    for i in range(10):
        cpu_in = convert.from_numpy(convert.to_numpy(ref))
        out = step(ref, dev)
        cpu = step(cpu_in, "cpu")
        ref, cpu_out = out[0], cpu[0]
        for k, v in (cpu[2] if len(cpu) > 2 else {}).items():
            if not torch.equal(out[2][k].cpu(), v):
                fail(f"{what} reference check step {i}: diag {k} differs")
        for f in cpu_out._fields:
            a, b = getattr(ref, f).cpu(), getattr(cpu_out, f)
            if f in ("a_xy", "a_psi", "b_center", "b_quat"):
                err = float((a - b).abs().max())
                worst = max(worst, err)
                if err > POS_TOL:
                    fail(f"{what} reference check step {i}: {f} differs by "
                         f"{err}")
            elif not torch.equal(a, b):
                fail(f"{what} reference check step {i}: {f} differs")
    return worst


def device_ms(wrapper, args, kernel_symbol):
    """(device ms a launch, launches the profiler kept) of the kernel
    named ``kernel_symbol`` over 200 calls of ``wrapper``; (None, 0) if
    the profiler saw no such kernel."""
    def loop():
        for _ in range(200):
            wrapper(*args)

    rows, _ = profile_kernels(loop)
    mine = [r for r in rows if kernel_symbol in r[0]]
    if not mine:
        return None, 0
    return mine[0][1] / 1e3 / mine[0][2], mine[0][2]


def time_kernel(wrapper, plain, args, kernel_symbol, calls=500):
    """(kernel ms, wrapper-call ms, plain ms, how) for one kernel."""
    call_ms = cuda_time_ms(lambda: wrapper(*args), iters=calls)
    plain_ms = cuda_time_ms(lambda: plain(*args), iters=20)
    k_ms, n = device_ms(wrapper, args, kernel_symbol)
    if k_ms is not None:
        how = f"device time {k_ms * 1e3:.2f} us (profiler, {n} launches)"
    else:
        k_ms = call_ms
        how = "device time not measured (profiler saw no kernel); " \
              "reporting the call time"
    return k_ms, call_ms, plain_ms, how


def bound(nbytes, flops, ops_per_s=FP32_FLOPS):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / ops_per_s
    return max((t_bytes, "bytes"), (t_ops, "operations"))


# ---------------------------------------------------------------------------
# the lattice engine and K3

def lattice_work(h, w):
    """(bytes, integer operations) of one K3 step of an h x w grid: grid
    int32 and disp int32 x 2 read once and written once, step and seed
    read once: 24 bytes a cell; LATTICE_OPS_PER_CELL a cell."""
    return 24 * h * w + 8, LATTICE_OPS_PER_CELL * h * w


def k3_vs_plain(cfg, seed, steps, dev, seen):
    """K3 against lattice_step on the card, every step, to the bit; adds
    each step's (hop axis, reaction direction) to ``seen``.  Returns the
    final state and the largest absolute difference seen (0 or a
    failure)."""
    import torch
    from kmc_tpu_torch.lattice.grid import init_lattice, particle_count
    from kmc_tpu_torch.lattice.step import lattice_step, step_variant
    from kmc_tpu_torch.ops.lattice import pallas_lattice_step

    st = init_lattice(cfg, seed=seed, device=dev)
    n0 = int(particle_count(st))
    worst = 0.0
    for i in range(steps):
        seen.add(step_variant(st))
        got = pallas_lattice_step(st, cfg)
        want = lattice_step(st, cfg)
        torch.cuda.synchronize()
        for f in ("grid", "disp", "step", "time"):
            a, b = getattr(got, f), getattr(want, f)
            worst = max(worst, float((a.double() - b.double()).abs().max()))
            if not torch.equal(a, b):
                fail(f"K3 {cfg.height}x{cfg.width} step {i}: {f} differs "
                     f"from the plain version in {int((a != b).sum())} "
                     "entries")
        st = got
    if int(particle_count(st)) != n0:
        fail(f"K3 {cfg.height}x{cfg.width}: particle count {n0} -> "
             f"{int(particle_count(st))}")
    return st, worst


def lattice_phases(dev):
    """Phases 10-14; returns K3's entry of the kernels line."""
    import torch
    from kmc_tpu_torch import LatticeConfig, SimConfig, cli, convert
    from kmc_tpu_torch.lattice.grid import (init_lattice, msd,
                                            particle_count,
                                            species_histogram)
    from kmc_tpu_torch.lattice.mapping import (msd_per_step_A2,
                                               reference_lattice_config)
    from kmc_tpu_torch.lattice.step import lattice_step, lattice_step_arrays
    from kmc_tpu_torch.ops import lattice as k3_ops
    from kmc_tpu_torch.ops.align import align_core_single
    from kmc_tpu_torch.ops.align_batched import align_core_batched

    k3 = k3_ops.lattice_block_call
    base = LatticeConfig()
    dense = base.replace(density=0.15, ass_prob=0.3, diss_prob=0.1)

    # ---- 10. K3 against its plain version ----
    seen, k3_err = set(), 0.0
    for name, cfg, steps in (
            ("LatticeConfig()", base, LATTICE_STEPS),
            ("dense", dense, LATTICE_STEPS),
            (f"{LATTICE_BIG}^2", base.replace(height=LATTICE_BIG,
                                             width=LATTICE_BIG),
             LATTICE_BIG_STEPS),
            ("64x96", dense.replace(height=64, width=96), LATTICE_STEPS)):
        t = time.perf_counter()
        st, err = k3_vs_plain(cfg, 1, steps, dev, seen)
        k3_err = max(k3_err, err)
        hist = species_histogram(st).tolist()
        log("K3 vs plain", f"{name} ({cfg.height}x{cfg.width}, density "
            f"{cfg.density}, ass {cfg.ass_prob}, diss {cfg.diss_prob}): "
            f"{steps} steps bitwise equal (grid, disp, step, time); "
            f"{int(particle_count(st))} particles conserved, species "
            f"{hist}; {time.perf_counter() - t:.2f} s")
        del st
    log("K3 vs plain", f"(hop axis, reaction direction) variants seen: "
        f"{sorted(seen)}")
    if len(seen) != 8:
        fail(f"K3 comparison saw {len(seen)} of the 8 direction variants")

    # ---- 11. card vs CPU ----
    st = init_lattice(base, seed=2, device=dev)
    cpu = convert.lattice_from_numpy(convert.lattice_to_numpy(st))
    st = k3_ops.make_pallas_lattice_chunk(base, 10)(st)
    for _ in range(10):
        cpu = lattice_step(cpu, base)
    for f in cpu._fields:
        if not torch.equal(getattr(st, f).cpu(), getattr(cpu, f)):
            fail(f"lattice card vs CPU: {f} differs after 10 steps")
    log("lattice card vs CPU", "10 K3 steps at 512^2 on the card equal the "
        "plain version on the CPU, to the bit (grid, disp, step, seed, "
        "time)")

    # ---- 12. the lattice CLI ----
    k1, k2 = align_core_batched, align_core_single
    with tempfile.TemporaryDirectory(prefix="kmc_lat_") as out:
        base_argv = ["--engine", "lattice", "--out", out, "--seed", "0",
                     "--device", dev.type, "--out-every",
                     str(LAT_CLI_OUT_EVERY), "--quiet"]
        runs = []
        reset_counts(k1, k2)
        for steps, extra in ((LAT_CLI_STEPS, []),
                             (LAT_CLI_RESUME, ["--lattice-pallas"])):
            said = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = cli.main(["--steps", str(steps), *base_argv, *extra])
            torch.cuda.synchronize()
            runs.append((steps, time.perf_counter() - t, said.getvalue(),
                         extra))
            if rc != 0:
                fail(f"lattice CLI returned {rc}")
        k1_n, k2_n, k3_n = k1.launches, k2.launches, k3.launches
        rows = read_lines(out, "lattice.dat")
        if not os.path.isfile(os.path.join(out, "lattice_checkpoint.npz")):
            fail("lattice CLI wrote no lattice_checkpoint.npz")
    total = LAT_CLI_STEPS + LAT_CLI_RESUME
    want_steps = list(range(LAT_CLI_OUT_EVERY, total + 1, LAT_CLI_OUT_EVERY))
    if [int(r.split()[0]) for r in rows] != want_steps:
        fail(f"lattice.dat steps {[r.split()[0] for r in rows]}, want "
             f"{want_steps}")
    if len({r.split()[1] for r in rows}) != 1:
        fail(f"lattice CLI: particle count changed: {rows}")
    if "resuming lattice from" not in runs[1][2]:
        fail(f"second lattice CLI run did not resume: {runs[1][2]!r}")
    cells = base.height * base.width
    for n, sec, _, extra in runs:
        log("lattice CLI", f"--steps {n} {' '.join(extra)}: {sec:.3f} s = "
            f"{1e3 * sec / n:.4f} ms/step, {cells * n / sec:.4g} "
            f"site-updates/s ({base.height}x{base.width}; output every "
            f"{LAT_CLI_OUT_EVERY} steps included; first run includes the "
            "cold start)")
    log("lattice CLI", f"K3 launches {k3_n} for {total} steps, K1 {k1_n}, "
        f"K2 {k2_n}; lattice.dat {len(rows)} rows, last '{rows[-1]}'")
    if k3_n != total or k1_n != 0 or k2_n != 0:
        fail(f"lattice CLI: K3 launched {k3_n} times in {total} steps, K1 "
             f"{k1_n}, K2 {k2_n} (want {total}, 0, 0)")

    # ---- 13. BASELINE config 2 physics ----
    ref = SimConfig()
    lcfg = reference_lattice_config(ref, spacing=LAT_SPACING,
                                    species="receptor", height=512,
                                    width=512).replace(ass_prob=0.0,
                                                       diss_prob=0.0)
    st = init_lattice(lcfg, seed=1, n_particles=LAT_MSD_PARTICLES,
                      device=dev)
    t = time.perf_counter()
    st = k3_ops.make_pallas_lattice_chunk(lcfg, LAT_MSD_STEPS)(st)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    measured = float(msd(st)) * LAT_SPACING ** 2 / LAT_MSD_STEPS
    analytic = msd_per_step_A2(ref, "receptor")
    rel = measured / analytic - 1.0
    log("lattice physics", f"config 2 (512^2, {LAT_MSD_PARTICLES} "
        f"particles, hop {lcfg.hop_prob:.6g}, no reactions): "
        f"{LAT_MSD_STEPS} K3 steps in {sec:.3f} s; MSD per step "
        f"{measured:.5f} A^2 vs 2 D dt / 9 = {analytic:.5f} A^2 "
        f"({100 * rel:+.2f} %, bound 10 %); particles "
        f"{int(particle_count(st))}")
    if abs(rel) > 0.1 or int(particle_count(st)) != LAT_MSD_PARTICLES:
        fail("lattice physics: MSD per step off by more than 10 % or "
             "particles not conserved")

    # ---- 14. K3 timing ----
    timing = {}
    for size in (base.height, LATTICE_BIG):
        cfg = base.replace(height=size, width=size)
        s0 = init_lattice(cfg, seed=3, device=dev)
        args = (s0.grid, s0.disp, s0.step, s0.seed)
        k_ms, call_ms, plain_ms, how = time_kernel(
            lambda *a: k3(*a, cfg), lambda *a: lattice_step_arrays(*a, cfg),
            args, "lattice_step_kernel",
            calls=500 if size == base.height else 100)
        nbytes, ops = lattice_work(size, size)
        bound_ms, bound_by = bound(nbytes, ops, INT32_OPS)
        timing[size] = (k_ms, plain_ms, bound_ms, bound_by)
        log("K3 timing", f"{size}^2: kernel {how} (first design "
            f"{K3_FIRST_DESIGN_US[size]} us); wrapper call "
            f"{call_ms * 1e3:.2f} us (CUDA events); plain "
            f"{plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.3f} us by "
            f"{bound_by} ({nbytes} bytes, {ops} integer ops); kernel / "
            f"bound {k_ms / bound_ms:.2f}; "
            f"{size * size / (k_ms * 1e-3):.4g} site-updates/s of device "
            "time")
        del s0, args
    chunk = k3_ops.make_pallas_lattice_chunk(base, 100)
    holder = [init_lattice(base, seed=4, device=dev)]
    holder.append(chunk(holder[0]))
    rows, wall = profile_kernels(lambda: holder.append(chunk(holder[-1])))
    dev_ms = sum(r[1] for r in rows) / 1e3
    if dev_ms > 0:
        top = "; ".join(f"{k[:40]} {us:.1f} us x{n}" for k, us, n in rows[:3])
        log("profile", f"100 lattice steps (512^2) under the profiler: wall "
            f"{wall * 1e3:.2f} ms, kernels {dev_ms:.3f} ms in "
            f"{sum(r[2] for r in rows)} launches (device busy "
            f"{100 * dev_ms / (wall * 1e3):.1f} %); top: {top}")
    else:
        log("profile", "device time not measured (the profiler recorded "
            "no CUDA kernel)")
    k_ms, plain_ms, bound_ms, bound_by = timing[base.height]
    return {
        "name": "lattice",
        "route": "cuda",
        "source": "kmc_tpu_torch/csrc/lattice.cu",
        "replaces": "kmc_tpu/ops/pallas_lattice.py:78",
        "launches": k3_n,
        "max_abs_err": k3_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# the rejection-free lattice mode and the parameter sweep: no kernel of
# their own (phases 15-18)

def rf_phases(dev):
    """Phases 15-17: the rejection-free mode on the card against the CPU,
    through the CLI at LatticeConfig(), and its throughput at 512^2."""
    import torch
    from kmc_tpu_torch import LatticeConfig, cli
    from kmc_tpu_torch.lattice import rejection_free as rf
    from kmc_tpu_torch.lattice.grid import init_lattice
    from kmc_tpu_torch.ops.align import align_core_single
    from kmc_tpu_torch.ops.align_batched import align_core_batched
    from kmc_tpu_torch.testing import rf_against_cpu

    k1, k2 = align_core_batched, align_core_single
    rates = dict(hop_prob=0.3, ass_prob=0.4, diss_prob=0.2)

    # ---- 15. card against the CPU, after every event or batch ----
    def compare(what, step, st, cfg, n, k_events=None):
        t = time.perf_counter()
        try:
            done, tie, worst = rf_against_cpu(step, st, cfg, n, k_events)
        except AssertionError as e:
            fail(f"rejection-free card vs CPU, {what}: {e}")
        said = (f"parted at call {tie} on an ulp tie (the CPU's best "
                "scores within 2 ulp); comparison stopped there"
                if tie is not None else "no parting")
        log("rf card vs CPU", f"{what}: {done} of {n} calls equal (grid, "
            f"disp, step), time within {worst:.3g} relative (bound 1e-5); "
            f"{said}; {time.perf_counter() - t:.2f} s")

    cfg = LatticeConfig(height=RF_SERIAL_SIZE, width=RF_SERIAL_SIZE, **rates)
    compare(f"rf_step at {RF_SERIAL_SIZE}^2, {RF_SERIAL_PARTICLES} particles",
            lambda s: rf.rf_step(s, cfg),
            init_lattice(cfg, seed=1, n_particles=RF_SERIAL_PARTICLES,
                         device=dev), cfg, RF_SERIAL_EVENTS)
    cfg = LatticeConfig(height=RF_BATCH_SIZE, width=RF_BATCH_SIZE, **rates)
    for thinning in ("parallel", "greedy"):
        compare(f"rf_batch_step {thinning} at {RF_BATCH_SIZE}^2, k = "
                f"{RF_K}, {RF_BATCH_PARTICLES} particles",
                lambda s, th=thinning: rf.rf_batch_step(s, cfg, RF_K, 3, th),
                init_lattice(cfg, seed=2, n_particles=RF_BATCH_PARTICLES,
                             device=dev), cfg, RF_BATCH_CALLS, RF_K)

    # ---- 16. the --lattice-rf CLI at LatticeConfig() ----
    base = LatticeConfig()
    with tempfile.TemporaryDirectory(prefix="kmc_rf_") as out:
        argv = ["--engine", "lattice", "--lattice-rf", "--out", out,
                "--seed", "0", "--device", dev.type, "--out-every",
                str(LAT_CLI_OUT_EVERY), "--quiet"]
        runs = []
        reset_counts(k1, k2)
        for steps in (LAT_CLI_STEPS, LAT_CLI_RESUME):
            said = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = cli.main(["--steps", str(steps), *argv])
            torch.cuda.synchronize()
            runs.append((steps, time.perf_counter() - t, said.getvalue()))
            if rc != 0:
                fail(f"--lattice-rf CLI returned {rc}")
        counts = (k1.launches, k2.launches, k3_wrapper().launches)
        rows = [r.split() for r in read_lines(out, "lattice.dat")]
        if not os.path.isfile(os.path.join(out, "lattice_checkpoint.npz")):
            fail("--lattice-rf CLI wrote no lattice_checkpoint.npz")
    total = LAT_CLI_STEPS + LAT_CLI_RESUME
    want_steps = list(range(LAT_CLI_OUT_EVERY, total + 1, LAT_CLI_OUT_EVERY))
    times = [float(r[-1]) for r in rows]
    if [int(r[0]) for r in rows] != want_steps:
        fail(f"--lattice-rf lattice.dat events {[r[0] for r in rows]}, "
             f"want {want_steps}")
    if len({r[1] for r in rows}) != 1:
        fail(f"--lattice-rf CLI: particle count changed: {rows}")
    if not all(a < b for a, b in zip(times, times[1:])) or times[0] <= 0:
        fail(f"--lattice-rf CLI: time not strictly increasing: {times}")
    if "resuming lattice from" not in runs[1][2]:
        fail(f"second --lattice-rf run did not resume: {runs[1][2]!r}")
    for n, sec, _ in runs:
        log("rf CLI", f"--lattice-rf --steps {n} ({base.height}^2, density "
            f"{base.density}): {sec:.3f} s = {n / sec:.1f} events/s (output "
            f"every {LAT_CLI_OUT_EVERY} events included; first run includes "
            "the cold start)")
    log("rf CLI", f"K1, K2, K3 launches {counts}; lattice.dat {len(rows)} "
        f"rows, {rows[0][1]} particles, time {times[0]:.4f} .. "
        f"{times[-1]:.4f}; last row '{' '.join(rows[-1])}'")
    if counts != (0, 0, 0):
        fail(f"--lattice-rf CLI launched K1, K2, K3 {counts} times")

    # ---- 17. throughput at 512^2 ----
    st0 = init_lattice(base, seed=5, device=dev)
    chunk = rf.make_rf_chunk(base, RF_CHUNK)
    st = chunk(st0)                                         # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    st = chunk(st)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    rows, wall = profile_kernels(lambda: chunk(st))
    dev_ms = sum(r[1] for r in rows) / 1e3
    if dev_ms > 0:
        top = "; ".join(f"{k[:40]} {us / 1e3:.2f} ms x{n}"
                        for k, us, n in rows[:4])
        busy = (f"under the profiler: wall {wall * 1e3:.1f} ms, kernels "
                f"{dev_ms:.2f} ms in {sum(r[2] for r in rows)} launches "
                f"(device busy {100 * dev_ms / (wall * 1e3):.1f} %); top: "
                f"{top}")
    else:
        busy = "device busy share not measured (the profiler recorded no " \
               "CUDA kernel)"
    log("rf throughput", f"serial make_rf_chunk({RF_CHUNK}) at "
        f"{base.height}^2: {sec:.3f} s = {RF_CHUNK / sec:.1f} events/s "
        f"({1e3 * sec / RF_CHUNK:.3f} ms an event); {busy}")
    # one event by stage: launches and device time from the profiler over
    # 10 calls, the call's time by CUDA events over 20
    rates_t = rf.event_rates(st0.grid, base)
    scores = rf._scores(st0, rates_t)
    flat, keep = rf._select(scores)
    parts = []
    for name, fn in (
            ("event_rates", lambda: rf.event_rates(st0.grid, base)),
            ("Gumbel scores", lambda: rf._scores(st0, rates_t)),
            ("argmax select", lambda: rf._select(scores)),
            ("update + time draw",
             lambda: rf._apply(st0, flat, keep, rates_t.sum()))):
        rows, _ = profile_kernels(lambda fn=fn: [fn() for _ in range(10)])
        parts.append(f"{name} {sum(r[2] for r in rows) / 10:.0f} launches, "
                     f"{sum(r[1] for r in rows) / 10:.1f} us of device "
                     f"time, {cuda_time_ms(fn, iters=20):.3f} ms a call")
    log("rf throughput", f"one serial event at {base.height}^2 by stage "
        "(profiler over 10 calls, CUDA events over 20): " + "; ".join(parts))
    for thinning in ("parallel", "greedy"):
        bchunk = rf.make_rf_batch_chunk(base, RF_BATCHES, k_events=RF_K,
                                        thinning=thinning)
        bchunk(st0)                                         # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, _ = bchunk(st0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        # replay the same batches to count the kept events
        s, kept = st0, 0
        for _ in range(RF_BATCHES):
            rates_t = rf.event_rates(s.grid, base)
            flat, keep = rf._select(rf._scores(s, rates_t), RF_K, 3,
                                    thinning)
            kept += int(keep.sum())
            s = rf._apply(s, flat, keep, rates_t.sum())
        if not torch.equal(s.grid, got.grid):
            fail(f"rf batch chunk ({thinning}): the replay differs")
        log("rf throughput", f"make_rf_batch_chunk({RF_BATCHES}, k_events="
            f"{RF_K}, {thinning}) at {base.height}^2: {sec:.3f} s = "
            f"{1e3 * sec / RF_BATCHES:.3f} ms a batch, {kept / RF_BATCHES:.2f}"
            f" kept events a batch, {kept / sec:.1f} events applied/s")
    scores = rf._scores(st0, rf.event_rates(st0.grid, base))
    sort_ms = cuda_time_ms(lambda: rf._top_k(scores, RF_K), iters=20)
    batch_ms = cuda_time_ms(lambda: rf.rf_batch_step(st0, base, RF_K),
                            iters=20)
    log("rf throughput", f"stable sort of {scores.numel()} scores "
        f"{sort_ms:.3f} ms of a {batch_ms:.3f} ms parallel batch "
        f"({100 * sort_ms / batch_ms:.1f} %; CUDA events, 20 calls)")


def sweep_phase(dev, k1, k2):
    """Phase 18: a parameter sweep over the replicas of one batched step;
    returns the K1 launches of its path."""
    import torch
    import kmc_tpu_torch
    from kmc_tpu_torch import SimConfig
    from kmc_tpu_torch.engine.clusters import cluster_labels
    from kmc_tpu_torch.engine.params import from_config, sweep
    from kmc_tpu_torch.engine.step import step_fn, step_fn_diag
    from kmc_tpu_torch.testing import bonded_state

    cfg = SimConfig()
    per = REPLICAS // SWEEP_GROUPS
    p_vals = torch.linspace(0.0, 2.0 * cfg.p_trans_ass, SWEEP_GROUPS)
    d_vals = torch.tensor([0.0, cfg.rb_a_d] * (SWEEP_GROUPS // 2))
    rp = sweep(cfg, REPLICAS, device=dev,
               p_trans_ass=p_vals.repeat_interleave(per),
               rb_a_d=d_vals.repeat_interleave(per))
    frozen = rp.rb_a_d == 0
    state = kmc_tpu_torch.init_ensemble(cfg, REPLICAS, seed=0, device=dev)
    start = state
    na = cfg.n_a
    still = moved = 0
    reset_counts(k1, k2)
    t = time.perf_counter()
    for i in range(2 * SWEEP_STEPS):
        info = cluster_labels(state, cfg)
        free_a = ((info.size == 1) & (info.n_b == 0))[:, :na]
        before = state.a_xy
        if i < SWEEP_STEPS:
            state, obs = step_fn(state, cfg, dev, batched=True, rp=rp)
        else:
            state, obs, dg = step_fn_diag(state, cfg, dev, batched=True,
                                          rp=rp)
        shifted = (state.a_xy != before).any(-1) & free_a
        if bool((shifted & frozen[:, None]).any()):
            fail(f"sweep step {i}: a free receptor moved in a replica "
                 "with rb_a_d = 0")
        still += int((free_a & frozen[:, None]).sum())
        moved += int((shifted & ~frozen[:, None]).sum())
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    k1_n, k2_n = k1.launches, k2.launches + k3_wrapper().launches
    bonds = obs.bond_rl.reshape(SWEEP_GROUPS, per).float().mean(1)
    log("sweep", f"init_ensemble(SimConfig(), {REPLICAS}) with p_trans_ass "
        f"in {[round(float(p), 4) for p in p_vals]} and rb_a_d in "
        f"{sorted(set(d_vals.tolist()))}, {per} replicas each: "
        f"{SWEEP_STEPS} step_fn + {SWEEP_STEPS} step_fn_diag steps in "
        f"{sec:.3f} s; K1 launches {k1_n}, K2 + K3 {k2_n}; free receptors "
        f"held still {still} (rb_a_d = 0), moved {moved} (rb_a_d > 0); "
        f"mean trans bonds by group {[round(float(b), 2) for b in bonds]}; "
        f"diag totals { {k: int(v.sum()) for k, v in dg.items()} }")
    if k1_n != 2 * SWEEP_STEPS or k2_n != 0:
        fail(f"sweep: K1 launched {k1_n} times in {2 * SWEEP_STEPS} steps, "
             f"K2 + K3 {k2_n} (want {2 * SWEEP_STEPS} and 0)")
    if still == 0 or moved == 0:
        fail("sweep: no free receptor to check in one of the two classes")
    with_rp = cuda_time_ms(lambda: step_fn(start, cfg, dev, batched=True,
                                           rp=rp), iters=3, warmup=1)
    without = cuda_time_ms(lambda: step_fn(start, cfg, dev, batched=True),
                           iters=3, warmup=1)
    log("sweep", f"eager ensemble step at {REPLICAS} replicas (K1 on all): "
        f"{with_rp:.2f} ms with rp, {without:.2f} ms without, on the same "
        "state (CUDA events, 3 calls)")

    small = SimConfig(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
                      cell_range_z=200.0)
    over = dict(p_trans_ass=[0.0, 0.1, 0.4, 1.0] * 2,
                p_trans_diss=[0.0, 0.5] * 4,
                p_mono_cis_ass=[1.0, 0.0, 0.3, 0.01] * 2,
                rb_a_d=[0.0] * 4 + [small.rb_a_d] * 4)
    rps = {dev.type: sweep(small, 8, device=dev, **over),
           "cpu": sweep(small, 8, device="cpu", **over)}
    for name, fn in (("step_fn", step_fn), ("step_fn_diag", step_fn_diag)):
        worst = check_against_cpu(
            lambda s, d, fn=fn: fn(s, small, d, batched=True,
                                   rp=rps[torch.device(d).type]),
            bonded_state(small, 8, seed=5, device=dev), dev, name)
        log("sweep", f"10 card steps of {name}(batched=True, rp=sweep) "
            f"equal the CPU path (24+8 molecules, 8 replicas): topology/"
            f"flags/keys{' and diag counts' if 'diag' in name else ''} "
            f"bitwise, poses max abs diff {worst:.3g} A")

    st1 = kmc_tpu_torch.init_state(cfg, 0, device=dev)
    want, _ = step_fn(st1, cfg, dev)
    reset_counts(k1, k2)
    got, _ = step_fn(st1, cfg, dev, rp=from_config(cfg, dev))
    torch.cuda.synchronize()
    if (k2.launches, k1.launches) != (1, 0):
        fail(f"single step with rp: K2 {k2.launches}, K1 {k1.launches} "
             "launches (want 1 and 0)")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("single step with rp=from_config differs from rp=None")
    log("sweep", "single-trajectory step_fn(rp=from_config(cfg)) at "
        "SimConfig(): K2 once, K1 never; bits equal to rp=None")
    return k1_n


# ---------------------------------------------------------------------------
# the multi-device paths: the sharded ensemble CLI and the halo lattice
# (phases 19-22), one rank a visible card

def spawn_ranks(n, argv):
    """``python argv`` as n ranks (parallel/launch.py); each rank's last
    output line, a JSON object.  A rank that fails fails the phase."""
    from kmc_tpu_torch.parallel.launch import spawn

    try:
        logs = spawn(n, argv, timeout=RANK_TIMEOUT, cwd=REPO)
    except RuntimeError as e:
        fail(str(e))
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def same_files(a, b, what):
    """Every file of run ``a`` equals run ``b``'s: text byte for byte, the
    checkpoint's arrays bitwise (a zip's bytes hold a time stamp)."""
    import numpy as np

    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        fail(f"{what}: files {names} and {sorted(os.listdir(b))}")
    for f in names:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                if sorted(za.files) != sorted(zb.files) or not all(
                        np.array_equal(za[k], zb[k]) for k in za.files):
                    fail(f"{what}: {f} differs")
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    fail(f"{what}: {f} differs")
    return names


def rank_grid(n):
    """The squarest (nx, ny) grid of n ranks, nx <= ny."""
    nx = int(n ** 0.5)
    while n % nx:
        nx -= 1
    return nx, n // nx


def steady_rate(counts, reps):
    """Replica-steps/s of ranks over the chunks after the first output
    (each rank's clock from its second chunk's start to cli.main's end;
    the slowest rank)."""
    return reps * counts[0]["steady_steps"] / max(c["steady_seconds"]
                                                  for c in counts)


def sharded_cli_phase(ens_dir, ens_sec):
    """19: the ensemble CLI as one rank a card, --replicas 512 W; its files
    against one process on one card (at W = 1 phase 6's; else one rank
    started alone, run as the W ranks are run: a cold process on one
    thread); a resume at the other launch; K1 once a step on every rank.
    Returns the replica-steps/s it measured."""
    import torch

    w = torch.cuda.device_count()
    reps = REPLICAS * w
    sharded = os.path.join(WORK, "sharded")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    counts = spawn_ranks(w, ["-m", "kmc_tpu_torch.testing", "cli", "--",
                             *ensemble_argv(sharded, reps, ENS_STEPS)])
    sec = time.perf_counter() - t
    for c in counts:
        if (c["k1"], c["k1_replicas"], c["k2"], c["k3"]) != (
                ENS_STEPS, ENS_STEPS * REPLICAS, 0, 0):
            fail(f"sharded ensemble CLI rank {c['rank']}: K1 {c['k1']} "
                 f"launches over {c['k1_replicas']} replicas, K2 {c['k2']}, "
                 f"K3 {c['k3']} (want {ENS_STEPS} at B = {REPLICAS}, 0, 0)")
    rates = {f"{w} rank(s), after the first output":
             steady_rate(counts, reps),
             f"{w} rank(s), all of cli.main":
             reps * ENS_STEPS / max(c["seconds"] for c in counts)}
    if w == 1:
        single = ens_dir
    else:
        single = os.path.join(WORK, "single")
        one = spawn_ranks(1, ["-m", "kmc_tpu_torch.testing", "cli", "--",
                              *ensemble_argv(single, reps, ENS_STEPS)])
        rates["1 rank on one card, after the first output"] = steady_rate(
            one, reps)
        rates["1 rank on one card, all of cli.main"] = (
            reps * ENS_STEPS / one[0]["seconds"])
    rates[f"phase 6 (in this process, {REPLICAS} replicas), all of cli.main"] = (
        REPLICAS * ENS_STEPS / ens_sec)
    names = same_files(sharded, single, f"sharded ensemble CLI at W = {w}")
    log("sharded ensemble CLI", f"{w} rank(s), --replicas {reps} --steps "
        f"{ENS_STEPS}: the slowest rank {max(c['seconds'] for c in counts):.3f}"
        f" s in cli.main, {max(c['steady_seconds'] for c in counts):.3f} s "
        f"after its first output (the group formed before it in "
        f"{max(c['join_seconds'] for c in counts):.3f} s), {sec:.3f} s with "
        f"the ranks' start; files {', '.join(names)} equal to "
        + ("phase 6's" if w == 1 else f"one rank's of {reps} replicas on one "
           "card") + f"; per rank K1 {counts[0]['k1']} launches at B = "
        f"{REPLICAS}, K2 and K3 0")

    # resume at the other launch: one process resumes the W ranks' run (at
    # W = 1, a rank started by the launcher resumes), against 40 steps
    t = time.perf_counter()
    if w == 1:
        spawn_ranks(1, ["-m", "kmc_tpu_torch.testing", "cli", "--",
                        *ensemble_argv(sharded, reps, ENS_STEPS)])
        how = "a launched rank"
    else:
        run_cli(ensemble_argv(sharded, reps, ENS_STEPS))
        how = "one process"
    resume_sec = time.perf_counter() - t
    whole = os.path.join(WORK, "whole")
    whole_sec = run_cli(ensemble_argv(whole, reps, 2 * ENS_STEPS))
    same_files(sharded, whole, "resumed sharded ensemble CLI")
    log("sharded ensemble CLI", f"{how} resumed it for {ENS_STEPS} steps "
        f"({resume_sec:.3f} s): every file equals {2 * ENS_STEPS} "
        f"uninterrupted steps of one process ({whole_sec:.3f} s)")
    return rates


def shard_k3_phase(dev):
    """20: K3 on the halo-padded blocks of 1 x 1 (one card's shard: a block
    larger than the grid), 2 x 2 and 4 x 1 cuts, at their negative global
    origins, against the plain version on the same block
    and, cropped and put together, against whole-grid K3, every step."""
    import torch
    from kmc_tpu_torch import LatticeConfig
    from kmc_tpu_torch.lattice.grid import init_lattice
    from kmc_tpu_torch.lattice.step import lattice_step_arrays, step_variant
    from kmc_tpu_torch.ops.lattice import pallas_lattice_step
    from kmc_tpu_torch.testing import step_halo_blocks

    k3 = k3_wrapper()
    seen = set()
    for size, steps, cfg in (
            (LATTICE_BIG, LATTICE_BIG_STEPS, LatticeConfig()),
            (64, LATTICE_STEPS, LatticeConfig(density=0.15, ass_prob=0.3,
                                              diss_prob=0.1))):
        cfg = cfg.replace(height=size, width=size)
        for shape in ((1, 1), (2, 2), (4, 1)):
            t = time.perf_counter()
            st = init_lattice(cfg, seed=7, device=dev)
            for i in range(steps):
                if size == 64:
                    seen.add(step_variant(st))
                grid, disp, outs = step_halo_blocks(st, cfg, shape, k3)
                _, _, plain = step_halo_blocks(st, cfg, shape,
                                               lattice_step_arrays)
                st = pallas_lattice_step(st, cfg)
                torch.cuda.synchronize()
                for (g, d), (pg, pd) in zip(outs, plain):
                    if not (torch.equal(g, pg) and torch.equal(d, pd)):
                        fail(f"K3 on a {shape} block of {size}^2, step {i}: "
                             "differs from the plain version")
                if not (torch.equal(grid, st.grid)
                        and torch.equal(disp, st.disp)):
                    fail(f"K3 on {shape} blocks of {size}^2, step {i}: the "
                         "cropped blocks differ from whole-grid K3")
                del outs, plain, grid, disp
            h, w = size // shape[0] + 8, size // shape[1] + 8
            log("K3 on shards", f"{size}^2 cut {shape[0]} x {shape[1]}: "
                f"{steps} steps, K3 on each {h} x {w} padded block at its "
                f"origin (row0 - 4, col0 - 4) bitwise equal to the plain "
                f"version, cropped blocks bitwise equal to whole-grid K3; "
                f"{time.perf_counter() - t:.2f} s")
            del st
    if len(seen) != 8:
        fail(f"K3 on shards saw {len(seen)} of the 8 direction variants")
    log("K3 on shards", f"variants seen at 64^2: {sorted(seen)}")


def halo_phase():
    """21: make_sharded_lattice_step on the squarest grid of the visible
    cards' ranks, at 8192^2 (16 steps, with the timing split of phase 22)
    and at 64^2 (64 steps), and make_halo_pallas_step at 64^2, each held
    bitwise by rank 0 to the whole-grid K3 chunk on its card; K3 once a
    step on every rank.  Returns the 8192^2 run's rank reports."""
    import torch
    from kmc_tpu_torch import LatticeConfig

    w = torch.cuda.device_count()
    nx, ny = rank_grid(w)
    base, dense = LatticeConfig(), dict(density=0.15, ass=0.3, diss=0.1)
    big = None
    for size, steps, chunk, form, knobs in (
            (LATTICE_BIG, HALO_BIG_STEPS, HALO_BIG_STEPS // 2, "sharded",
             dict(density=base.density, ass=base.ass_prob,
                  diss=base.diss_prob)),
            (64, LATTICE_STEPS, LATTICE_STEPS // 2, "sharded", dense),
            (64, LATTICE_STEPS, 1, "pallas", dense)):
        torch.cuda.empty_cache()
        t = time.perf_counter()
        argv = ["-m", "kmc_tpu_torch.testing", "halo", "--device", DEVICE,
                "--shape", str(nx), str(ny), "--height", str(size),
                "--width", str(size), "--seed", "8", "--steps", str(steps),
                "--chunk", str(chunk), "--form", form, "--check",
                *(f"--{k}={v}" for k, v in knobs.items())]
        if size == LATTICE_BIG:
            argv += ["--time", str(HALO_TIME_STEPS)]
        reports = spawn_ranks(w, argv)
        if not reports[0].get("equal"):
            fail(f"halo {form} step at {size}^2 on {nx} x {ny} ranks: the "
                 "gathered grid differs from the whole-grid K3 chunk")
        bad = [r for r in reports if r["k3"] != steps]
        if bad:
            fail(f"halo {form} step at {size}^2: K3 launches "
                 f"{[r['k3'] for r in reports]} (want {steps} a rank)")
        log("halo step", f"{form} at {size}^2 on a {nx} x {ny} rank grid "
            f"({w} card(s)), {steps} steps (chunk {chunk}): the gathered "
            f"grid bitwise equal to the whole-grid K3 chunk, "
            f"{reports[0]['particles']} particles; K3 launches per rank "
            f"{[r['k3'] for r in reports]}; {time.perf_counter() - t:.2f} s "
            "with the ranks' start")
        if size == LATTICE_BIG:
            big = reports
    return big, (nx, ny)


def halo_timing_phase(dev, reports, shape, cli_rates):
    """22: K3's device time on the padded shard of 4096^2 and of 8192^2
    beside whole-grid K3 at 8192^2; the halo step's parts at 8192^2 on
    each rank (CUDA events); the sharded ensemble CLI's rate against one
    card.  Returns K3's shard-use numbers at this run's shard size."""
    from kmc_tpu_torch import LatticeConfig
    from kmc_tpu_torch.lattice.grid import init_lattice
    from kmc_tpu_torch.lattice.step import lattice_step_arrays

    k3 = k3_wrapper()
    base = LatticeConfig()
    out = {}
    full = LATTICE_BIG
    for block in (full, full + 8, full // 2 + 8):
        cfg = base.replace(height=full, width=full)
        st = init_lattice(base.replace(height=block, width=block), seed=3,
                          device=dev)
        origin = 0 if block == full else -4
        args = (st.grid, st.disp, st.step, st.seed)
        k_ms, call_ms, plain_ms, how = time_kernel(
            lambda *a: k3(*a, cfg, origin, origin),
            lambda *a: lattice_step_arrays(*a, cfg, origin, origin),
            args, "lattice_step_kernel", calls=100)
        nbytes, ops = lattice_work(block, block)
        bound_ms, bound_by = bound(nbytes, ops, INT32_OPS)
        out[block] = (k_ms, plain_ms, bound_ms, bound_by)
        what = ("whole grid" if block == full else
                f"padded shard of {block - 8}^2 at origin (-4, -4)")
        log("halo timing", f"K3 on a {block}^2 {what} of {full}^2: kernel "
            f"{how}; wrapper call {call_ms * 1e3:.2f} us; plain "
            f"{plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.3f} us by "
            f"{bound_by}; kernel / bound {k_ms / bound_ms:.2f}")
        del st, args
    for r in reports:
        sp = r["split_ms"]

        def part(k):
            return f"{sp[k]:.4f}" if k in sp else "not measured"

        log("halo timing", f"rank {r['rank']} of {shape[0]} x {shape[1]} "
            f"at {LATTICE_BIG}^2, ms a step over {HALO_TIME_STEPS} steps: "
            f"make_sharded_lattice_step(chunk {HALO_TIME_STEPS}) wall "
            f"{sp['sharded_step_wall']:.4f}, make_halo_pallas_step wall "
            f"{sp['halo_step_wall']:.4f} (CUDA events around the calls); "
            f"one traced sharded call, device time by range: halo.pad "
            f"{part('halo_pad')} (made once a chunk), halo.refresh "
            f"{part('halo_refresh')}, "
            f"halo.crop {part('halo_crop')} (made once a chunk); by kernel: K3 "
            f"{sp['trace_k3']:.4f}, NCCL (exchange) {sp['trace_nccl']:.4f}, "
            f"all {sp['trace_all']:.4f}")
    log("halo timing", "sharded ensemble CLI replica-steps/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in cli_rates.items()))
    return out


def multi_device_phases(dev, ens_dir, ens_sec):
    """Phases 19-22; K3's launches on rank 0 of the 8192^2 sharded run."""
    cli_rates = sharded_cli_phase(ens_dir, ens_sec)
    shard_k3_phase(dev)
    reports, shape = halo_phase()
    halo_timing_phase(dev, reports, shape, cli_rates)
    return {"launches": reports[0]["k3"]}


def validation_report(argv):
    """validate_vs_reference.main(argv) in this process: (rc, report)."""
    from kmc_tpu_torch.scripts import validate_vs_reference as vv

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = vv.main(argv)
    torch_sync()
    return rc, json.loads(buf.getvalue())


def same_state_files(a, b) -> list[str]:
    """Keys of two validation state files that differ (wall_s aside)."""
    import numpy as np

    with np.load(a) as za, np.load(b) as zb:
        keys = sorted((set(za.files) | set(zb.files)) - {"wall_s"})
        return [k for k in keys if (
            k not in za.files or k not in zb.files
            or not np.array_equal(za[k], zb[k]))]


def validation_phase(dev, k1, k2):
    """Phase 23: the oracle validation driver at SimConfig(out_every=50),
    256 lazy replicas with histograms; returns the K1 launches of its
    uninterrupted run and K1's max abs error on that run's own inputs
    against the plain version."""
    import numpy as np
    import torch
    from kmc_tpu_torch import SimConfig, make_lazy_ensemble_chunk
    from kmc_tpu_torch.ops import align_batched
    from kmc_tpu_torch.parallel.ensemble import default_k_align
    from kmc_tpu_torch.scripts import check_flagship_state as cf
    from kmc_tpu_torch.scripts import validate_vs_reference as vv

    cfg = SimConfig(out_every=VAL_OUT_EVERY)
    d = os.path.join(WORK, "validation")
    os.makedirs(d)
    whole, cut = os.path.join(d, "whole.npz"), os.path.join(d, "cut.npz")
    base = ["kinetics", "--ref-bond", *VAL_REF_BOND, "--ref-cluster",
            *VAL_REF_CLUSTER, "--replicas", str(VAL_REPLICAS), "--seed", "0",
            "--align-mode", "lazy", "--sub-chunks", str(VAL_SUB_CHUNKS),
            "--device", DEVICE]
    captured = []     # (inputs, outputs) of every K1 call of the run

    wrapper = align_batched.align_core_batched

    def recording(*a):
        args = tuple(x.clone() for x in a[:-1])
        outs = wrapper(*a)
        captured.append((args, tuple(o.clone() for o in outs)))
        return outs

    # the wrapper counts through its module-level name, so while the
    # recorder stands in under that name the counts land on the recorder
    recording.launches = recording.replicas = 0

    saved, vv.run_config = vv.run_config, lambda: cfg
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        reset_counts(k1, k2)
        align_batched.align_core_batched = recording
        t = time.perf_counter()
        try:
            _, rep = validation_report(base + [
                "--max-rows", "2", "--state-file", whole, "--invariants"])
        finally:
            align_batched.align_core_batched = wrapper
        sec = time.perf_counter() - t
        k1.launches, k1.replicas = recording.launches, recording.replicas
        k1_n, k1_reps = k1.launches, k1.replicas
        others = k2.launches + k3_wrapper().launches
        steps = 2 * VAL_OUT_EVERY
        cols = "; ".join(
            f"oracle {i + 1}: " + ", ".join(
                f"{c} {v.get('coverage', 'n/a')}"
                for c, v in run["columns"].items())
            for i, run in enumerate(rep["kinetics_runs"]))
        log("validation driver", f"2 outputs of {VAL_OUT_EVERY} steps at "
            f"{VAL_REPLICAS} lazy replicas with histograms: {sec:.2f} s; "
            f"K1 launches {k1_n} aligning {k1_reps} replicas in {steps} "
            f"steps, K2 + K3 launches {others}; report against oracle rows "
            f"1-2 ({VAL_OUT_EVERY} steps are not an oracle row, not gated): "
            f"ok={rep['ok']}; coverage {cols}; invariants ok="
            f"{rep['invariants']['ok']}; device {rep['device']}")
        if k1_n != steps or others != 0:
            fail(f"validation driver: K1 launched {k1_n} times in {steps} "
                 f"steps, K2 + K3 {others} times")
        if rep["n_out"] != 2 or not rep["invariants"]["ok"]:
            fail(f"validation driver: {rep['n_out']} rows, invariants "
                 f"{rep['invariants']}")
        if DEVICE == "cuda" and rep["device"] != CARD:
            fail(f"validation driver: the report names the device "
                 f"{rep['device']!r}, nvidia-smi {CARD!r}")

        # K1 against its plain version on the inputs this path gave it
        batch = min(default_k_align(VAL_REPLICAS), VAL_REPLICAS)
        sizes = sorted({a[0].shape[0] for a, _ in captured})
        if len(captured) != steps or sizes != [batch]:
            fail(f"validation driver: {len(captured)} K1 calls of batch "
                 f"sizes {sizes} captured, {steps} of {batch} expected")
        k1_err, passes = 0.0, []
        for i, (args, got) in enumerate(captured):
            want = align_batched.align_core_batched_plain(*args, cfg)
            k1_err = max(k1_err, compare_core(
                got, want, f"K1 validation call {i + 1} of {steps}",
                exact=True))
            passes.append(core_passes(args, cfg))
        log("validation driver", f"K1 on this path's own inputs: all "
            f"{len(captured)} calls of the run (B = {batch}) bitwise equal "
            f"to the plain version; passes "
            f"{pass_summary(torch.cat(passes))}")
        captured.clear()

        validation_report(base + ["--max-rows", "1", "--state-file", cut])
        validation_report(base + ["--max-rows", "2", "--state-file", cut,
                                  "--resume-state"])
        diff = same_state_files(whole, cut)
        with np.load(cut) as z:
            k_cut = int(z["k_done"])
        if diff or k_cut != 2:
            fail(f"validation driver: the run cut after output 1 and "
                 f"resumed differs from the uninterrupted run in {diff} "
                 f"(k_done {k_cut})")
        _, again = validation_report(base + [
            "--max-rows", "2", "--state-file", whole, "--report-only",
            "--invariants"])
        strip = lambda r: {k: v for k, v in r.items()
                           if k not in VAL_RUN_KEYS}
        if strip(again) != strip(rep):
            fail("validation driver: --report-only differs from the in-run "
                 "report")
        inv = cf.check_state(whole, dev)
        if not inv["ok"] or inv["replicas"] != VAL_REPLICAS:
            fail(f"check_flagship_state: {inv}")
        log("validation driver", f"cut after output 1 and resumed: state "
            f"file equal to the uninterrupted run's in every key (series, "
            f"histograms, all {VAL_REPLICAS} replicas' state); --report-only "
            f"equals the in-run report; check_flagship_state ok on "
            f"{inv['replicas']} replicas at step {inv['steps_per_replica']}")

        with np.load(whole) as z:
            state = vv.load_state(z, dev)
        one = make_lazy_ensemble_chunk(cfg, 1, device=dev)
        holder = [state]
        ms = cuda_time_ms(lambda: holder.append(one(holder.pop())[0]),
                          iters=TIMED, warmup=WARMUP)
        row_min = ms * ORACLE_ROW_STEPS / 60e3
        rows, wall = profile_kernels(
            lambda: holder.append(one(holder.pop())[0]))
        dev_ms = sum(r[1] for r in rows) / 1e3
        busy = (f"{dev_ms:.2f} ms of device time in {sum(r[2] for r in rows)}"
                f" launches, busy {100 * dev_ms / (wall * 1e3):.1f} % of "
                f"{wall * 1e3:.1f} ms" if dev_ms > 0 else
                "device time not measured (the profiler saw no kernel)")
        log("validation driver", f"lazy step at {VAL_REPLICAS} replicas "
            f"(k_align {default_k_align(VAL_REPLICAS)}): {ms:.3f} ms a step "
            f"(CUDA events, {TIMED} steps after {WARMUP} warm-ups) -> "
            f"{row_min:.3f} GPU-minutes an oracle row of "
            f"{ORACLE_ROW_STEPS} steps; one step under the profiler: {busy}")
    finally:
        vv.run_config = saved
        os.chdir(cwd)
    return k1_n, k1_err


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import kmc_tpu_torch
    from kmc_tpu_torch import SimConfig
    from kmc_tpu_torch.io.checkpoint import load_reference_cpt
    from kmc_tpu_torch.ops import align as k2_ops
    from kmc_tpu_torch.ops import align_batched, build
    from kmc_tpu_torch.parallel.ensemble import broadcast_ensemble
    from kmc_tpu_torch.testing import (align_core_inputs,
                                       align_core_single_inputs,
                                       bonded_state)

    k1 = align_batched.align_core_batched
    k2 = k2_ops.align_core_single
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    global CARD
    card = smi_name_power()
    log("device", f"{name} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    CARD = card
    dev = torch.device(DEVICE)

    global WORK
    WORK = tempfile.mkdtemp(prefix="kmc_smoke_")
    atexit.register(shutil.rmtree, WORK, True)

    # ---- 2. build ----
    info = build.build()
    build.load()
    log("build", f"nvcc {info.seconds:.2f} s for {len(info.paths)} sources "
        f"in parallel (reused={info.reused}) -> "
        + ", ".join(os.path.relpath(p, REPO) for p in info.paths.values())
        + "; " + "; ".join(build.ptxas_summary(info.ptxas)))
    log("build", "ptxas frames: " + "; ".join(ptxas_frames(info.ptxas)))
    cfg = SimConfig()
    smem = build.library("align_batched").kmc_align_batched_smem(cfg.n_a,
                                                                 cfg.n_b)
    smem2 = build.library("align").kmc_align_smem(cfg.n_a, cfg.n_b)
    log("build", f"align kernels' shared memory per block: K1 {smem}, K2 "
        f"{smem2} bytes (dynamic)")
    # ---- 3. K1 and K2 against their plain versions at the reference size
    mature = load_reference_cpt(REF_CPT, cfg, seed=0, device=dev)
    bonded3 = bonded_state(cfg, 1, seed=3, device=dev)
    k1_sets = {
        f"bonded B={K_ALIGN}": bonded_state(cfg, K_ALIGN, seed=K_ALIGN,
                                            device=dev),
        f"bonded B={REPLICAS}": bonded_state(cfg, REPLICAS, seed=REPLICAS,
                                             device=dev),
        f"mature B={K_ALIGN}": broadcast_ensemble(mature, K_ALIGN, seed=0),
        f"mature B={REPLICAS}": broadcast_ensemble(mature, REPLICAS, seed=0),
        "trans-only B=1": strip_bonds(bonded3, keep_trans=True),
        "bond-free B=1": strip_bonds(bonded3, keep_trans=False),
    }
    max_err, k1_inputs = 0.0, {}
    for what, st in k1_sets.items():
        args = align_core_inputs(st, cfg)
        got = k1(*args, cfg)
        torch.cuda.synchronize()
        want = align_batched.align_core_batched_plain(*args, cfg)
        max_err = max(max_err, compare_core(got, want, f"K1 {what}",
                                            exact=True))
        passes = core_passes(args, cfg)
        snapped = int((got[2] == 1).sum())
        unreached = int((got[2] == 2).sum()) + int((got[5] >= 2).sum())
        log("kernel vs plain", f"K1 {what}: bitwise equal; passes "
            f"{pass_summary(passes)}; receptors snapped {snapped}, "
            f"unreached markers {unreached}")
        k1_inputs[what] = (args, got, passes)
    k2_sets = {f"bonded seed {seed}": bonded_state(cfg, 1, seed=seed,
                                                   device=dev)
               for seed in K2_SEEDS}
    k2_sets.update({"mature": mature,
                    "trans-only": strip_bonds(bonded3, keep_trans=True),
                    "bond-free": strip_bonds(bonded3, keep_trans=False)})
    k2_err, k2_inputs = 0.0, {}
    for what, st in k2_sets.items():
        args = align_core_single_inputs(st, cfg)
        got = k2(*args, cfg)
        torch.cuda.synchronize()
        want = k2_ops.align_core_single_plain(*args, cfg)
        k2_err = max(k2_err, compare_core(got, want, f"K2 {what}",
                                          exact=True))
        passes = core_passes(as_batched(args), cfg)
        log("kernel vs plain", f"K2 {what}: bitwise equal; passes "
            f"{pass_summary(passes)}; receptors snapped "
            f"{int((got[2] == 1).sum())}, unreached markers "
            f"{int((got[2] == 2).sum()) + int((got[5] >= 2).sum())}")
        k2_inputs[what] = (args, got, passes)

    # ---- 4. the main path ----
    t = time.perf_counter()
    state = kmc_tpu_torch.init_ensemble(cfg, REPLICAS, seed=0, device=dev)
    torch.cuda.synchronize()
    log("main path", f"init_ensemble(SimConfig(), {REPLICAS}, seed=0): "
        f"{time.perf_counter() - t:.2f} s")
    warm = kmc_tpu_torch.make_lazy_ensemble_chunk(cfg, WARMUP,
                                                  k_align=K_ALIGN, device=dev)
    timed = kmc_tpu_torch.make_lazy_ensemble_chunk(cfg, TIMED,
                                                   k_align=K_ALIGN, device=dev)
    reset_counts(k1, k2)
    t = time.perf_counter()
    state, _ = warm(state)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t
    t = time.perf_counter()
    state, obs = timed(state)
    torch.cuda.synchronize()
    t_timed = time.perf_counter() - t
    launches, k2_lazy = k1.launches, k2.launches + k3_wrapper().launches
    steps = WARMUP + TIMED
    rs_per_s = REPLICAS * TIMED / t_timed
    events = cfg.n + cfg.n_a * cfg.n_b * 3 + 2 * cfg.n_a * (cfg.n_a - 1)
    finite = all(bool(torch.isfinite(x).all())
                 for x in (state.a_xy, state.a_psi, state.b_center,
                           state.b_quat))
    ok_mutual = mutual(state, cfg)
    log("main path", f"{WARMUP} warm-up steps {t_warm:.3f} s; "
        f"{TIMED} steps {t_timed:.3f} s = {1e3 * t_timed / TIMED:.2f} "
        f"ms/step; {rs_per_s:.1f} replica-steps/s; "
        f"{rs_per_s * events:.4g} event-attempts/s ({events} per "
        f"replica-step)")
    log("main path", f"K1 launches {launches} for {steps} steps, K2 + K3 "
        f"launches {k2_lazy}; dirty "
        f"replicas {int(state.dirty.sum())}/{REPLICAS}; mean bonds "
        f"rl {obs.bond_rl.float().mean():.3f} cis "
        f"{obs.bond_cis.float().mean():.3f} mono_cis "
        f"{obs.bond_mono_cis.float().mean():.3f}; finite={finite}; "
        f"mutual={ok_mutual}; step={int(state.step[0])}")
    if launches != steps or k2_lazy != 0:
        fail(f"K1 launched {launches} times and K2 + K3 {k2_lazy} times in "
             f"{steps} main-path steps")
    if not finite or not ok_mutual:
        fail("main-path state not finite or bonds not mutual")
    if not bool((state.step == steps + 1).all()):
        fail("step counter did not advance")

    # ---- 5. single trajectory through the CLI ----
    k2_launches = single_cli_phase(cfg, dev, k1, k2)

    # ---- 6. ensemble through the CLI ----
    ens_dir = os.path.join(WORK, "ensemble")
    ens_sec = ensemble_cli_phase(cfg, ens_dir, k1, k2)

    # ---- 7. small-input references: card steps vs the plain CPU path ----
    small = SimConfig(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
                      cell_range_z=200.0)
    worst = check_against_cpu(
        lambda s, d: kmc_tpu_torch.lazy_ensemble_step(s, small, 2, device=d),
        bonded_state(small, 8, seed=5, device=dev), dev, "lazy")
    log("reference check", f"10 lazy-ensemble card steps equal the CPU "
        f"plain path (24+8 molecules, 8 replicas): topology/flags/keys "
        f"bitwise, poses max abs diff {worst:.3g} A")
    worst = check_against_cpu(
        lambda s, d: kmc_tpu_torch.step_fn(s, small, device=d),
        bonded_state(small, 1, seed=5, device=dev), dev, "single")
    log("reference check", f"10 single-trajectory card steps (K2) equal "
        f"the CPU plain path (24+8 molecules): topology/flags/keys bitwise, "
        f"poses max abs diff {worst:.3g} A")

    # ---- 8. K1 and K2 timing ----
    x = torch.zeros(1, device=dev)
    rows, _ = profile_kernels(lambda: [x.add_(1.0) for _ in range(200)])
    if rows:
        log("align timing", f"floor of a one-block launch: a one-element "
            f"add_ takes {rows[0][1] / rows[0][2]:.2f} us of device time "
            f"(profiler, {rows[0][2]} launches)")
    else:
        log("align timing", "floor of a one-block launch not measured "
            "(the profiler recorded no CUDA kernel)")
    timings = {}
    for kernel, what, wrapper, plain, symbol, inputs in (
            *(("K1", w, k1, align_batched.align_core_batched_plain,
               "align_batched_kernel", k1_inputs[w])
              for w in (f"bonded B={K_ALIGN}", f"mature B={K_ALIGN}",
                        f"bonded B={REPLICAS}", f"mature B={REPLICAS}")),
            *(("K2", w, k2, k2_ops.align_core_single_plain,
               "align_single_kernel", k2_inputs[w])
              for w in (f"bonded seed {K2_SEEDS[0]}", "mature"))):
        args, outs, passes = inputs
        k_ms, call_ms, plain_ms, how = time_kernel(
            lambda *a, f=wrapper: f(*a, cfg),
            lambda *a, f=plain: f(*a, cfg), args, symbol)
        nbytes, flops = core_work(cfg, args, outs, passes)
        bound_ms, bound_by = bound(nbytes, flops)
        before = ""
        if what in (f"bonded B={K_ALIGN}", f"bonded seed {K2_SEEDS[0]}"):
            before = (f"; first design {ALIGN_FIRST_DESIGN_US[kernel]} us "
                      "(NVIDIA H100 80GB HBM3, 700 W)")
        log(f"{kernel} timing", f"{what} ({pass_summary(passes)} passes): "
            f"kernel {how}{before}; wrapper call {call_ms * 1e3:.2f} us "
            f"(CUDA events, 500 calls); plain {plain_ms * 1e3:.1f} us; "
            f"bound {bound_ms * 1e3:.4f} us by {bound_by} ({nbytes} bytes, "
            f"{flops} flops)")
        timings[what] = (k_ms, plain_ms, bound_ms, bound_by)
    # the cost of one pass: K2 on one bonded replica at several depths,
    # where the level loop runs align_depth passes, and on a bond-free one
    # (one pass that reaches nothing)
    by_passes = []
    for depth in PASS_DEPTHS:
        c = cfg.replace(align_depth=depth)
        args = align_core_single_inputs(
            bonded_state(c, 1, seed=K2_SEEDS[0], device=dev), c)
        k_ms, _ = device_ms(lambda *a, c=c: k2(*a, c), args,
                            "align_single_kernel")
        by_passes.append((int(core_passes(as_batched(args), c)[0]), k_ms))
    free_ms, _ = device_ms(lambda *a: k2(*a, cfg), k2_inputs["bond-free"][0],
                           "align_single_kernel")
    if free_ms is not None and all(t is not None for _, t in by_passes):
        (p0, t0), (p1, t1) = by_passes[0], by_passes[-1]
        log("K2 timing", f"device time by passes (bonded seed {K2_SEEDS[0]}"
            ", align_depth = passes): " + ", ".join(
                f"{p} passes {t * 1e3:.2f} us" for p, t in by_passes)
            + f", bond-free (1 pass) {free_ms * 1e3:.2f} us; "
            f"{(t1 - t0) * 1e3 / (p1 - p0):.3f} us a pass")
    else:
        log("K2 timing", "device time by passes not measured (the "
            "profiler saw no kernel)")
    k1_ms, plain_ms, bound_ms, bound_by = timings[f"bonded B={K_ALIGN}"]
    k2_ms, plain2_ms, bound2_ms, bound2_by = timings[
        f"bonded seed {K2_SEEDS[0]}"]

    # ---- 9. where the time goes ----
    from kmc_tpu_torch import rng
    from kmc_tpu_torch.engine.align import idealize_fused
    from kmc_tpu_torch.engine.clusters import cluster_labels, take_info
    from kmc_tpu_torch.engine.diffusion import diffuse
    from kmc_tpu_torch.engine.observables import observe
    from kmc_tpu_torch.engine.reactions import react
    from kmc_tpu_torch.state import take_replicas

    skey = rng.step_key(state.key, state.step)
    cl = cluster_labels(state, cfg)
    idx = torch.arange(K_ALIGN, device=dev)
    stages = {
        "cluster_labels": lambda: cluster_labels(state, cfg),
        "diffuse": lambda: diffuse(state, cl, rng.stream_key(
            skey, rng.STREAM_MOVE), cfg),
        f"align ({K_ALIGN} replicas)": lambda: idealize_fused(
            take_replicas(state, idx), take_info(cl, idx),
            rng.stream_key(skey[idx], rng.STREAM_ALIGN), cfg),
        "react": lambda: react(state, skey, cfg),
        "observe": lambda: observe(state, cl, cfg),
        f"one [{REPLICAS},{cfg.n_a},{cfg.n_b},3] uniform draw": lambda: rng.uniform(
            skey, (cfg.n_a, cfg.n_b, 3)),
    }
    parts = [f"{k} {cuda_time_ms(f, iters=3, warmup=1):.2f} ms"
             for k, f in stages.items()]
    log("stages", f"each stage alone at {REPLICAS} replicas "
        f"(CUDA events, 3 runs): " + "; ".join(parts))

    one = kmc_tpu_torch.make_lazy_ensemble_chunk(cfg, 1, k_align=K_ALIGN,
                                                 device=dev)
    holder = [state]
    rows, wall = profile_kernels(lambda: holder.append(one(holder[-1])[0]))
    state = holder[-1]
    dev_ms = sum(r[1] for r in rows) / 1e3
    if dev_ms > 0:
        top = "; ".join(f"{k[:40]} {us / 1e3:.2f} ms x{n}"
                        for k, us, n in rows[:6])
        log("profile", f"1 step under the profiler: wall "
            f"{wall * 1e3:.1f} ms, kernels {dev_ms:.1f} ms in "
            f"{sum(r[2] for r in rows)} launches; top: {top}")
    else:
        log("profile", "device time not measured (the profiler recorded "
            "no CUDA kernel)")

    single = kmc_tpu_torch.make_step_fn(cfg, device=dev)
    st1 = kmc_tpu_torch.init_state(cfg, 0, device=dev)
    st1, _ = single(st1)
    holder = [st1]
    rows, wall = profile_kernels(lambda: holder.append(single(holder[-1])[0]))
    dev_ms = sum(r[1] for r in rows) / 1e3
    if dev_ms > 0:
        top = "; ".join(f"{k[:40]} {us / 1e3:.3f} ms x{n}"
                        for k, us, n in rows[:4])
        log("profile", f"1 single-trajectory step under the profiler: wall "
            f"{wall * 1e3:.1f} ms, kernels {dev_ms:.2f} ms in "
            f"{sum(r[2] for r in rows)} launches; top: {top}")

    # ---- 10-14. the lattice engine and K3 ----
    k3_entry = lattice_phases(dev)

    # ---- 15-18. the rejection-free mode and the parameter sweep ----
    rf_phases(dev)
    sweep_phase(dev, k1, k2)

    # ---- 19-22. the multi-device paths ----
    k3_shard = multi_device_phases(dev, ens_dir, ens_sec)
    k3_entry.update(launches=k3_shard["launches"], launches_by_path={
        "lattice CLI": k3_entry["launches"],
        "make_sharded_lattice_step, rank 0": k3_shard["launches"]})

    # ---- 23. the oracle validation driver ----
    val_launches, val_err = validation_phase(dev, k1, k2)

    print(json.dumps({"kernels": [{
        "name": "align_batched",
        "route": "cuda",
        "source": "kmc_tpu_torch/csrc/align_batched.cu",
        "replaces": "kmc_tpu/ops/pallas_align_batched.py:106",
        "launches": launches,
        "launches_by_path": {"lazy main path": launches,
                             "validation driver": val_launches},
        "max_abs_err": max(max_err, val_err),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "align",
        "route": "cuda",
        "source": "kmc_tpu_torch/csrc/align.cu",
        "replaces": "kmc_tpu/ops/pallas_align.py:78",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": plain2_ms,
        "bound_ms": bound2_ms,
        "bound_by": bound2_by,
        "library_ms": None,
    }, k3_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
