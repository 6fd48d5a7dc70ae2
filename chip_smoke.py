#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and the repository around
this file; without a card it exits nonzero and prints no result.  It
finishes in well under 5 minutes, the kernel build included, and prints
one line per phase with the seconds since start:

1. device: the card's name, count and power limit; TF32 off;
2. build: nvcc builds the kernels (seconds, registers, shared memory);
3. kernel vs plain: K1 (csrc/align_batched.cu) against its plain PyTorch
   version on bonded replicas at the reference size (150 + 50 molecules),
   B = 64 and 512, positions within 1e-4 A, directions and quaternions
   within 1e-5, snap and b_laid codes exact;
4. main path: init_ensemble(SimConfig(), 512, seed=0) on the card, then
   the lazy ensemble chunk with k_align = 64: 2 warm-up + 20 timed steps;
   K1 launches must equal the step count; state finite and bonds mutual;
5. reference check: on a small dense system, one card step from each of
   10 states of a trajectory against the plain CPU path from the same
   state (topology bitwise, poses within 1e-4 A);
6. K1 timing at B = 64: the kernel's device time (torch.profiler) and a
   wrapper call (CUDA events), beside the plain version and the bound
   (bytes over 3.35 TB/s);
7. where the time goes: each stage of the step timed alone by CUDA
   events, and torch.profiler over one main-path step (device busy share,
   top kernels).

The last two lines are one JSON object per kernel measured, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
POS_TOL, ANG_TOL = 1e-4, 1e-5
REPLICAS, K_ALIGN, WARMUP, TIMED = 512, 64, 2, 20
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

def compare_core(got, want):
    """Max abs error of the float outputs; raises on a miss."""
    names = ("a_xy", "a_dir", "snap", "b_center", "b_quat", "b_laid")
    tols = (POS_TOL, ANG_TOL, None, POS_TOL, ANG_TOL, None)
    worst = 0.0
    for name, g, w, tol in zip(names, got, want, tols):
        if tol is None:
            if not bool((g == w).all()):
                fail(f"K1 {name} differs from the plain version in "
                     f"{int((g != w).sum())} entries")
        else:
            err = float((g - w).abs().max())
            if err > tol:
                fail(f"K1 {name} max abs error {err} > {tol}")
            worst = max(worst, err)
    return worst


def k1_work(cfg, args, outs):
    """(bytes, flops) K1 needs for these inputs: every input read once and
    every output written once; flops counted for the molecules this data
    snaps (about 70 per receptor seat, 40 per ligand re-seat or lay-down)
    plus the depth rounds' compare-and-add per neighbour entry."""
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *outs))
    snapped_a = int((outs[2] == 1).sum())
    laid_new = int(((outs[5] & 1) != args[8]).sum())
    b = args[0].shape[0]
    depth_ops = 2 * cfg.align_depth * b * (2 * cfg.n_a + 3 * cfg.n_b)
    return nbytes, 70 * snapped_a + 40 * laid_new + depth_ops


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


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import kmc_tpu_torch
    from kmc_tpu_torch import SimConfig, convert
    from kmc_tpu_torch.ops import align_batched, build
    from kmc_tpu_torch.testing import align_core_inputs, bonded_state

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

    # ---- 2. build ----
    info = build.build()
    build.load()
    log("build", f"nvcc {info.seconds:.2f} s (reused={info.reused}) -> "
        f"{os.path.relpath(info.path, REPO)}; "
        + "; ".join(build.ptxas_summary(info.ptxas)))
    cfg = SimConfig()
    smem = build.load()[0].kmc_align_batched_smem(cfg.n_a, cfg.n_b)
    log("build", f"align kernel shared memory per block: {smem} bytes "
        "(dynamic)")

    # ---- 3. K1 against its plain version at the reference size ----
    max_err = 0.0
    k1_inputs = None
    for batch in (K_ALIGN, REPLICAS):
        st = bonded_state(cfg, batch, seed=batch, device=dev)
        args = align_core_inputs(st, cfg)
        got = align_batched.align_core_batched(*args, cfg)
        torch.cuda.synchronize()
        want = align_batched.align_core_batched_plain(*args, cfg)
        err = compare_core(got, want)
        max_err = max(max_err, err)
        snapped = int((got[2] == 1).sum())
        unreached = int((got[2] == 2).sum()) + int((got[5] >= 2).sum())
        log("kernel vs plain", f"B={batch}: max abs err {err:.3g} "
            f"(tol {POS_TOL} A / {ANG_TOL}); receptors snapped {snapped}, "
            f"unreached markers {unreached}; snap/b_laid exact")
        if batch == K_ALIGN:
            k1_inputs = (args, got)

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
    align_batched.align_core_batched.launches = 0
    t = time.perf_counter()
    state, _ = warm(state)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t
    t = time.perf_counter()
    state, obs = timed(state)
    torch.cuda.synchronize()
    t_timed = time.perf_counter() - t
    launches = align_batched.align_core_batched.launches
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
    log("main path", f"K1 launches {launches} for {steps} steps; dirty "
        f"replicas {int(state.dirty.sum())}/{REPLICAS}; mean bonds "
        f"rl {obs.bond_rl.float().mean():.3f} cis "
        f"{obs.bond_cis.float().mean():.3f} mono_cis "
        f"{obs.bond_mono_cis.float().mean():.3f}; finite={finite}; "
        f"mutual={ok_mutual}; step={int(state.step[0])}")
    if launches != steps:
        fail(f"K1 launched {launches} times in {steps} main-path steps")
    if not finite or not ok_mutual:
        fail("main-path state not finite or bonds not mutual")
    if not bool((state.step == steps + 1).all()):
        fail("step counter did not advance")

    # ---- 5. small-input reference: card step vs the plain CPU path ----
    small = SimConfig(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
                      cell_range_z=200.0)
    ref = bonded_state(small, 8, seed=5, device=dev)
    worst, agree = 0.0, 0
    for i in range(10):
        cpu_in = convert.from_numpy(convert.to_numpy(ref))
        ref, _ = kmc_tpu_torch.lazy_ensemble_step(ref, small, 2, device=dev)
        cpu_out, _ = kmc_tpu_torch.lazy_ensemble_step(cpu_in, small, 2,
                                                      device="cpu")
        for f in cpu_out._fields:
            a, b = getattr(ref, f).cpu(), getattr(cpu_out, f)
            if f in ("a_xy", "a_psi", "b_center", "b_quat"):
                err = float((a - b).abs().max())
                worst = max(worst, err)
                if err > POS_TOL:
                    fail(f"reference check step {i}: {f} differs by {err}")
            elif not torch.equal(a, b):
                fail(f"reference check step {i}: {f} differs")
        agree += 1
    log("reference check", f"{agree} card steps equal the CPU plain path "
        f"(24+8 molecules, 8 replicas): topology/flags/keys bitwise, poses "
        f"max abs diff {worst:.3g} A")

    # ---- 6. K1 timing ----
    args, outs = k1_inputs
    call_ms = cuda_time_ms(
        lambda: align_batched.align_core_batched(*args, cfg), iters=500)
    plain_ms = cuda_time_ms(
        lambda: align_batched.align_core_batched_plain(*args, cfg), iters=20)

    def k1_loop():
        for _ in range(200):
            align_batched.align_core_batched(*args, cfg)

    rows, _ = profile_kernels(k1_loop)
    k1_rows = [r for r in rows if "align_batched_kernel" in r[0]]
    if k1_rows:
        k1_ms = k1_rows[0][1] / 1e3 / k1_rows[0][2]
        how = f"device time {k1_ms * 1e3:.2f} us (profiler, " \
              f"{k1_rows[0][2]} launches)"
    else:
        k1_ms = call_ms
        how = "device time not measured (profiler saw no kernel); " \
              "reporting the call time"
    nbytes, flops = k1_work(cfg, args, outs)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    log("K1 timing", f"B={K_ALIGN}: kernel {how}; wrapper call "
        f"{call_ms * 1e3:.2f} us (CUDA events, 500 calls); plain "
        f"{plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.3f} us by "
        f"{bound_by} ({nbytes} bytes, {flops} flops)")

    # ---- 7. where the time goes ----
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

    print(json.dumps({"kernels": [{
        "name": "align_batched",
        "route": "cuda",
        "source": "kmc_tpu_torch/csrc/align_batched.cu",
        "replaces": "kmc_tpu/ops/pallas_align_batched.py:106",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
