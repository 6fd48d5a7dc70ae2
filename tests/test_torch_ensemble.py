"""The port's ensembles as a whole: cold start, the lazy replica-ensemble
step, the eager ensemble chunk, both *_hist chunks, broadcast and merge,
held against kmc_tpu.

The chunk tests run 8 free-running steps on 4 bonded replicas of
small_cfg in both packages: topology, flags, keys, observables and
histograms bitwise, poses within 1e-4 A.

The trajectory test is teacher-forced: at each of 30 steps of a kmc_tpu
lazy-ensemble trajectory, the JAX state is carried into the port, the port
takes one step from it, and the two results are compared -- integer
topology, the dirty flags, keys and every observable bitwise, poses within
1e-4 A (1e-4 rad / quaternion units).  The float tolerance is the JAX
suite's fused-vs-unfused idealize tolerance: off the TPU, kmc_tpu runs the
unfused idealize (parallel/ensemble.py: the fused core only on a TPU)
while the port runs the fused core's plain version, and the two agree
within 1e-4 A (kmc_tpu/config.py, fused_align)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu.parallel.ensemble import init_ensemble as j_init_ensemble
from kmc_tpu.parallel.ensemble import lazy_ensemble_step as j_lazy_step
from kmc_tpu.parallel.ensemble import make_ensemble_step as j_eager_step
import kmc_tpu_torch
from kmc_tpu_torch import convert

from helpers import ideal_cis_pair, ideal_trans_pair
from test_torch_clusters import (jax_fields, port_cfg,
                                 spread_state, stack_fields)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_FIELDS = ("a_xy", "a_psi", "b_center", "b_quat")
POSE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache_small_torch():
    """Keep this module's JAX compiles out of the persistent cache (and so
    out of the tree), and keep torch to two threads per test worker."""
    from jax._src import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    threads = torch.get_num_threads()
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


def dense_cfg():
    """tests/test_lazy_align.py's dense configuration."""
    return JConfig(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
                   cell_range_z=200.0)


def bonded_start(cfg, r):
    """A cold start with bond geometry near the box centre: an unbonded
    ideal trans encounter (associates at p = 0.4 a step), a loose trans
    bond, a loose cis bond and a tilted, unlaid bonded ligand."""
    st = spread_state(cfg, 10 + r)
    st = ideal_trans_pair(st, a=0, b=0, site=1 + r % 3, cfg=cfg,
                          center_xy=(-150.0, -150.0), alpha=0.5 * r)
    st = ideal_trans_pair(st, a=1, b=1, site=2, cfg=cfg,
                          center_xy=(150.0, 150.0), alpha=-0.3, bond=True)
    st = st._replace(a_xy=st.a_xy.at[1].add(jnp.asarray([3.0, -2.0])))
    st = ideal_cis_pair(st, 2, 3, cfg, xy=(-150.0, 150.0), psi=0.2 * r,
                        bond=True)
    st = st._replace(a_xy=st.a_xy.at[3].add(jnp.asarray([2.0, 2.0])))
    st = ideal_trans_pair(st, a=4, b=2, site=3, cfg=cfg,
                          center_xy=(150.0, -150.0), alpha=1.0, bond=True)
    from kmc_tpu.geometry import quat_from_euler, quat_mul

    return st._replace(
        b_quat=st.b_quat.at[2].set(quat_mul(quat_from_euler(0.3, 0.1, 0.2),
                                            st.b_quat[2])),
        b_laid=st.b_laid.at[2].set(False),
        b_center=st.b_center.at[2, 2].add(12.0))


def jax_batch(states):
    """Single-replica JAX states stacked into one batched JAX state."""
    from kmc_tpu.state import SimState

    fields = stack_fields(states)
    return SimState(**{
        f: (jax.random.wrap_key_data(jnp.asarray(fields[f])) if f == "key"
            else jnp.asarray(fields[f])) for f in SimState._fields})


def assert_states_match(got, want, where):
    for f, w in want.items():
        g = getattr(got, f).numpy()
        if f in POSE_FIELDS:
            np.testing.assert_allclose(g, w, rtol=0, atol=POSE_TOL,
                                       err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          f"{f} {where}")


def assert_obs_match(got, want, where):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      f"obs {f} {where}")


def test_port_imports_no_jax():
    code = ("import sys, kmc_tpu_torch, kmc_tpu_torch.parallel.ensemble, "
            "kmc_tpu_torch.ops.align_batched, kmc_tpu_torch.convert, "
            "kmc_tpu_torch.cli, kmc_tpu_torch.engine.step, "
            "kmc_tpu_torch.ops.align, kmc_tpu_torch.io.checkpoint, "
            "kmc_tpu_torch.io.native, kmc_tpu_torch.io.writers, "
            "kmc_tpu_torch.utils.checks, kmc_tpu_torch.testing, "
            "kmc_tpu_torch.ops.hashing, kmc_tpu_torch.ops.lattice, "
            "kmc_tpu_torch.lattice.grid, kmc_tpu_torch.lattice.step, "
            "kmc_tpu_torch.lattice.io, kmc_tpu_torch.lattice.mapping, "
            "kmc_tpu_torch.lattice.rejection_free, "
            "kmc_tpu_torch.engine.params, kmc_tpu_torch.utils.profiling, "
            "kmc_tpu_torch.parallel.mesh, kmc_tpu_torch.parallel.distributed, "
            "kmc_tpu_torch.parallel.halo, kmc_tpu_torch.parallel.launch, "
            "kmc_tpu_torch.scripts.validate_vs_reference, "
            "kmc_tpu_torch.scripts.check_flagship_state, "
            "kmc_tpu_torch.scripts.early_cluster_size_check, "
            "kmc_tpu_torch.scripts.validate_lattice_physics, "
            "kmc_tpu_torch.scripts.measure_residual_overlap, "
            "kmc_tpu_torch.scripts.distributed_worker, "
            "kmc_tpu_torch.scripts.run_distributed_e2e, "
            "kmc_tpu_torch.scripts.bench, "
            "kmc_tpu_torch.scripts.replica_scaling, "
            "kmc_tpu_torch.scripts.weak_scaling, "
            "kmc_tpu_torch.scripts.run_distributed_bench, "
            "kmc_tpu_torch.scripts.mini_golden, "
            "kmc_tpu_torch.scripts.receptors_probe, "
            "kmc_tpu_torch.scripts.chan_flux; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'kmc_tpu' or "
            "m.startswith('kmc_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_source_is_the_packages_own():
    """The port compiles its own copy of the I/O codec, not the JAX
    package's native/kmcio.cpp; the copy is byte for byte the same."""
    from kmc_tpu_torch.io import native

    pkg = os.path.dirname(os.path.abspath(kmc_tpu_torch.__file__))
    src = os.path.abspath(native.SRC)
    assert os.path.commonpath([src, pkg]) == pkg, src
    with open(src, "rb") as f, \
            open(os.path.join(REPO, "native", "kmcio.cpp"), "rb") as g:
        assert f.read() == g.read()


def test_entry_points_default_to_cuda():
    cfg = port_cfg(dense_cfg())
    if torch.cuda.is_available():
        st = kmc_tpu_torch.init_ensemble(cfg, 2, seed=0)
        assert st.a_xy.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            kmc_tpu_torch.init_ensemble(cfg, 2, seed=0)
        with pytest.raises(RuntimeError):
            kmc_tpu_torch.make_lazy_ensemble_chunk(cfg, 1)
    st = kmc_tpu_torch.init_ensemble(cfg, 2, seed=0, device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        kmc_tpu_torch.lazy_ensemble_step(st, cfg, 2)       # defaults to cuda
    lcfg = kmc_tpu_torch.LatticeConfig(height=8, width=8)
    if torch.cuda.is_available():
        assert kmc_tpu_torch.init_lattice(lcfg, seed=0).grid.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            kmc_tpu_torch.init_lattice(lcfg, seed=0)
    assert not kmc_tpu_torch.init_lattice(lcfg, device="cpu").grid.is_cuda


@pytest.mark.parametrize("seed", [0, 3])
def test_init_ensemble_matches(seed):
    cfg = dense_cfg()
    want = jax_fields(j_init_ensemble(cfg, 4, seed=seed))
    got = kmc_tpu_torch.init_ensemble(port_cfg(cfg), 4, seed=seed,
                                      device="cpu")
    assert_states_match(got, want, f"seed {seed}")


def test_lazy_trajectory_teacher_forced():
    cfg = dense_cfg()
    tcfg = port_cfg(cfg)
    reps, k, steps = 4, 2, 30
    js = jax_batch([bonded_start(cfg, r) for r in range(reps)])
    step = jax.jit(lambda s: j_lazy_step(s, cfg, k))
    dirty_seen = 0
    for i in range(steps):
        fields = jax_fields(js)
        ts = convert.from_numpy(fields)
        js, jobs = step(js)
        ts, tobs = kmc_tpu_torch.lazy_ensemble_step(ts, tcfg, k,
                                                    device="cpu")
        assert_states_match(ts, jax_fields(js), f"step {i}")
        assert_obs_match(tobs, jobs, f"step {i}")
        dirty_seen += int(fields["dirty"].sum())
    final = jax_fields(js)
    # the window exercised bonds, dirty replicas and the K < R gather
    assert (final["a_trans"] >= 0).sum() > reps
    assert (final["a_cis"] >= 0).sum() >= 2 * reps
    assert dirty_seen > k


def test_full_k_matches_eager_all_align_step():
    """k_align = R aligns every replica every step: the port's lazy step
    then reproduces kmc_tpu's eager (all-align) ensemble step."""
    cfg = dense_cfg()
    tcfg = port_cfg(cfg)
    reps = 3
    js = jax_batch([bonded_start(cfg, r) for r in range(reps)])
    eager = j_eager_step(cfg, donate=False)
    for i in range(8):
        ts = convert.from_numpy(jax_fields(js))
        js, jobs = eager(js)
        ts, tobs = kmc_tpu_torch.lazy_ensemble_step(ts, tcfg, reps,
                                                    device="cpu")
        assert_states_match(ts, jax_fields(js), f"step {i}")
        assert_obs_match(tobs, jobs, f"step {i}")


def test_chunk_runs_and_keeps_invariants():
    """A free-running port chunk: bonds stay mutual, counters consistent,
    the step advances and the rotation gather never starves a replica."""
    cfg = port_cfg(dense_cfg())
    st = convert.from_numpy(stack_fields([bonded_start(dense_cfg(), r)
                                          for r in range(4)]))
    run = kmc_tpu_torch.make_lazy_ensemble_chunk(cfg, 25, k_align=1,
                                                 device="cpu")
    st, obs = run(st)
    assert (st.step == 26).all()
    na = cfg.n_a
    for r in range(4):
        a_trans, a_site = st.a_trans[r], st.a_site[r]
        for a in torch.nonzero(a_trans >= 0)[:, 0].tolist():
            b, s = int(a_trans[a]) - na, int(a_site[a])
            assert int(st.b_partner[r, b, s - 1]) == a
        a_cis = st.a_cis[r]
        for a in torch.nonzero(a_cis >= 0)[:, 0].tolist():
            assert int(a_cis[int(a_cis[a])]) == a
    assert torch.equal(obs.bond_num,
                       obs.bond_rl + obs.bond_mono_cis + obs.bond_cis)
    assert torch.isfinite(st.a_xy).all() and torch.isfinite(st.b_quat).all()


CHUNK = 8


@pytest.mark.parametrize("kind", ["eager", "eager_hist", "lazy_hist"])
def test_ensemble_chunks_match(small_cfg, kind):
    """The eager chunk and both *_hist chunks against kmc_tpu's on 4
    bonded replicas of small_cfg: topology, flags, keys, observables and
    histograms bitwise, poses within 1e-4 A."""
    from kmc_tpu.parallel import ensemble as jens
    from kmc_tpu_torch.parallel import ensemble as tens

    cfg = small_cfg
    tcfg = port_cfg(cfg)
    js = jax_batch([bonded_start(cfg, r) for r in range(4)])
    ts = convert.from_numpy(jax_fields(js))
    if kind == "eager":
        jf = jens.make_ensemble_chunk(cfg, CHUNK, donate=False)
        tf = tens.make_ensemble_chunk(tcfg, CHUNK, device="cpu")
    elif kind == "eager_hist":
        jf = jens.make_ensemble_chunk_hist(cfg, CHUNK, donate=False)
        tf = tens.make_ensemble_chunk_hist(tcfg, CHUNK, device="cpu")
    else:
        jf = jens.make_lazy_ensemble_chunk_hist(cfg, CHUNK, k_align=2,
                                                donate=False)
        tf = tens.make_lazy_ensemble_chunk_hist(tcfg, CHUNK, k_align=2,
                                                device="cpu")
    js, jout = jf(js)
    ts, tout = tf(ts)
    assert_states_match(ts, jax_fields(js), kind)
    if kind == "eager":
        assert_obs_match(tout, jout, kind)
        return
    assert_obs_match(tout[0], jout[0], kind)
    for name, got, want in zip(("hist", "ahist"), tout[1:], jout[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    # the replicas hold ligand-seeded complexes to count
    assert (tout[1].numpy()[:, 2:].sum() > 0)


def test_broadcast_and_merge_match(small_cfg):
    from kmc_tpu.parallel import ensemble as jens
    from kmc_tpu_torch.engine.observables import Observables
    from kmc_tpu_torch.parallel import ensemble as tens

    js = bonded_start(small_cfg, 0)
    ts = convert.from_numpy(jax_fields(js), batched=False)
    jb = jens.broadcast_ensemble(js, 5, seed=9)
    tb = tens.broadcast_ensemble(ts, 5, seed=9)
    assert_states_match(tb, jax_fields(jb), "broadcast")
    _, jobs = j_eager_step(small_cfg, donate=False)(jb)
    merged_t = tens.merge_observables(
        Observables(*(torch.from_numpy(np.array(x)) for x in jobs)))
    merged_j = jens.merge_observables(jobs)
    for f in merged_j._fields:
        np.testing.assert_allclose(getattr(merged_t, f).numpy(),
                                   np.asarray(getattr(merged_j, f)),
                                   rtol=1e-6, err_msg=f)
