"""The port's replica sharding (kmc_tpu_torch/parallel/mesh.py,
distributed.py, the sharded ensemble CLI) against kmc_tpu's, on the CPU.

Ranks are separate processes joined by gloo (``parallel/launch.py``
starts them; they import no JAX); kmc_tpu's side is computed here.

* World size 1, in this process: ``initialize`` is a no-op without
  ``KMC_COORDINATOR``, ``all_hosts_mean`` is the identity, and
  ``host_local_ensemble`` is kmc_tpu's.  With a coordinator that no rank
  serves, ``initialize`` raises.
* ``shard_replicated_state`` at 2 and 4 ranks gives each rank kmc_tpu's
  slice of ``init_ensemble(cfg, 8)``, and ``init_replicas`` builds the
  same block directly.
* Two ranks of ``host_local_ensemble`` with 4 replicas each, 30 eager
  steps (tests/test_distributed.py's two-process run): each rank's block
  against kmc_tpu's ``init_ensemble(cfg, 4, seed=p)`` and chunk,
  topology, counters and keys bitwise, poses within 1e-4 A
  (test_torch_ensemble.py's tolerance); the merged counters bitwise.
* The sharded ensemble CLI (--replicas 8 --steps 20) at 2 ranks writes
  the files of the 1-process port (text byte-identical, the checkpoint's
  arrays equal); a 2-rank run resumed by 1 process, and a 1-process run
  resumed by 2 ranks, equal 40 uninterrupted steps.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu.parallel import distributed as jdist
from kmc_tpu.parallel import ensemble as jens
from kmc_tpu_torch import cli as tcli
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.parallel import distributed, mesh
from kmc_tpu_torch.parallel.ensemble import init_ensemble, init_replicas
from kmc_tpu_torch.parallel.launch import free_port, spawn
from kmc_tpu_torch.testing import DIST_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_FIELDS = ("a_xy", "a_psi", "b_center", "b_quat")
POSE_TOL = 1e-4
# spawned ranks: one thread each, a hang fails the test within the limit
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
RANK_TIMEOUT = 300


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


def jax_fields(st):
    """A kmc_tpu SimState as numpy fields (key words as uint32)."""
    return {f: np.asarray(jax.random.key_data(v) if f == "key" else v)
            for f, v in st._asdict().items()}


def assert_fields_match(got, want, where):
    for f, w in want.items():
        g = np.asarray(got[f])
        if f in POSE_FIELDS:
            np.testing.assert_allclose(g, w, rtol=0, atol=POSE_TOL,
                                       err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          f"{f} {where}")


def port_fields(st):
    from kmc_tpu_torch import convert

    return convert.to_numpy(st)


# ---------------------------------------------------------------------------
# world size 1, in this process

def test_initialize_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("KMC_COORDINATOR", raising=False)
    assert distributed.initialize(device="cpu") is False
    assert mesh.world() == (0, 1)
    m = distributed.global_replica_mesh("cpu")
    assert (m.rank, m.size, m.device.type) == (0, 1, "cpu")


def test_initialize_raises_when_the_group_cannot_form():
    """A coordinator that nobody serves: rank 1 of 2 raises after its
    timeout rather than run unsharded."""
    code = ("from kmc_tpu_torch.parallel import distributed as d\n"
            f"d.initialize('127.0.0.1:{free_port()}', 2, 1, device='cpu', "
            "timeout=3)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=RANK_ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "Error" in proc.stderr


def test_all_hosts_mean_identity():
    x = np.arange(8.0)
    assert distributed.all_hosts_mean(x) is x
    t = torch.arange(8.0)
    assert torch.equal(distributed.all_hosts_mean(t), t)


def test_host_local_ensemble_matches(small_cfg):
    """One process: the block is init_ensemble(cfg, 8, seed=0), as
    kmc_tpu's host_local_ensemble gives it, and steps."""
    from kmc_tpu_torch.parallel.ensemble import make_ensemble_step

    cfg = SimConfig(**small_cfg.to_dict())
    got = distributed.host_local_ensemble(cfg, 8, device="cpu")
    want = jax_fields(jdist.host_local_ensemble(small_cfg, 8))
    assert_fields_match(port_fields(got), want, "host_local_ensemble")
    st, obs = make_ensemble_step(cfg, "cpu")(got)
    assert st.a_xy.shape == got.a_xy.shape and obs.bond_num.shape == (8,)


@pytest.mark.parametrize("size", [2, 4])
def test_shard_replicated_state_matches_slices(small_cfg, size):
    cfg = SimConfig(**small_cfg.to_dict())
    full_j = jax_fields(jens.init_ensemble(small_cfg, 8, seed=3))
    full_t = init_ensemble(cfg, 8, seed=3, device="cpu")
    for rank in range(size):
        m = mesh.ReplicaMesh(rank, size, torch.device("cpu"))
        sl = mesh.replica_sharding(m, 8)
        assert (sl.start, sl.stop) == (rank * 8 // size,
                                       (rank + 1) * 8 // size)
        got = mesh.shard_replicated_state(full_t, m)
        assert_fields_match(port_fields(got),
                            {f: v[sl] for f, v in full_j.items()},
                            f"rank {rank} of {size}")
        direct = init_replicas(cfg, range(sl.start, sl.stop), seed=3,
                               device="cpu")
        for a, b in zip(direct, got):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.replica_sharding(mesh.ReplicaMesh(0, 3, "cpu"), 8)


# ---------------------------------------------------------------------------
# two gloo ranks

STEPS, RPH = 30, 4


def test_two_process_localhost_matches_single(tmp_path):
    logs = spawn(2, ["-m", "kmc_tpu_torch.testing", "ensemble", "--device",
                     "cpu", "--out", str(tmp_path), "--steps", str(STEPS),
                     "--replicas-per-host", str(RPH)],
                 timeout=RANK_TIMEOUT, cwd=REPO, env=RANK_ENV)
    cfg = JConfig(**DIST_CFG)
    chunk = jens.make_ensemble_chunk(cfg, STEPS, donate=False)
    counters = []
    for p in range(2):
        st, obs = chunk(jens.init_ensemble(cfg, RPH, seed=p))
        got = dict(np.load(tmp_path / f"rank{p}.npz"))
        assert_fields_match(got, jax_fields(st), f"rank {p}")
        for f in obs._fields:
            np.testing.assert_array_equal(got[f"obs_{f}"],
                                          np.asarray(getattr(obs, f)), f)
        counters.append(np.asarray(obs.bond_num))
        assert got["step"].tolist() == [STEPS + 1] * RPH
    merged = np.load(tmp_path / "merged.npz")
    np.testing.assert_array_equal(merged["bond_num"],
                                  np.concatenate(counters))
    mean = float(np.concatenate(counters).astype(np.float32).mean())
    for log in logs:
        assert f'"bond_num_mean": {mean}' in log.strip().splitlines()[-1]


def _cli_args(out, steps):
    """tests/test_torch_cli.py's small ensemble, unfused, on the CPU."""
    return ["--out", str(out), "--steps", str(steps), "--seed", "1",
            "--quiet", "--device", "cpu", "--replicas", "8",
            "--set", "n_a=12", "--set", "n_b=4",
            "--set", "cell_range_x=1500", "--set", "cell_range_y=1500",
            "--set", "cell_range_z=500", "--set", "out_every=10",
            "--set", "fused_align=false"]


def _two_ranks(out, steps):
    spawn(2, ["-m", "kmc_tpu_torch.cli", *_cli_args(out, steps)],
          timeout=RANK_TIMEOUT, cwd=REPO, env=RANK_ENV)


def assert_same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        if f.endswith(".npz"):
            za, zb = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
            assert sorted(za.files) == sorted(zb.files), f
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], f"{f} {k}")
        else:
            with open(os.path.join(a, f), "rb") as fa, \
                    open(os.path.join(b, f), "rb") as fb:
                assert fa.read() == fb.read(), f


def test_cli_sharded_matches_single_process(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    assert tcli.main(_cli_args(one, 20)) == 0
    _two_ranks(two, 20)
    assert_same_files(one, two)
    assert "bond_ens.dat" in os.listdir(two)
    assert len((two / "bond_ens.dat").read_text().splitlines()) == 3


def test_cli_resume_across_world_sizes(tmp_path):
    """2 ranks then 1 process, and 1 process then 2 ranks, each 20 + 20
    steps, equal 40 uninterrupted steps of one process."""
    whole, a, b = tmp_path / "whole", tmp_path / "a", tmp_path / "b"
    assert tcli.main(_cli_args(whole, 40)) == 0
    _two_ranks(a, 20)
    assert tcli.main(_cli_args(a, 20)) == 0
    assert tcli.main(_cli_args(b, 20)) == 0
    _two_ranks(b, 20)
    assert_same_files(whole, a)
    assert_same_files(whole, b)
