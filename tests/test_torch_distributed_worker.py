"""The port's multi-process production loop (kmc_tpu_torch/scripts/
distributed_worker.py, run_distributed_e2e.py) against the JAX package's
scripts/distributed_worker.py, on the CPU.

Ranks are gloo processes started by ``parallel/launch.py`` (they import
no JAX); kmc_tpu's side is computed here, in this process.

* The worker's default mode at 2 ranks x 4 replicas x 30 steps gives the
  JAX expectation, kmc_tpu's ``make_ensemble_chunk`` on the blocks seeded
  0 and 1: ``bond_sum`` and ``step`` exact, ``xy_checksum`` within rtol
  1e-5 (tests/test_distributed.py's tolerance).
* The production loop at 2 ranks, 2 outputs of 10 steps: ``bond_ens.dat``
  is text-identical to the rows numpy makes with the JAX script's formula
  (mean, std, min, max in float32) from kmc_tpu's chunk on the same two
  blocks.  2 outputs and 2 resumed from the shard files equal 4
  uninterrupted outputs: the rows text-identical, each rank's shard
  bitwise.  ``ensemble_row`` on bonded replicas equals the JAX script's
  jitted ``collect`` once both are formatted.
* Shard files cross between the packages at one process: the JAX
  ``save_sharded_checkpoint``'s file loads in the port leaf for leaf
  bitwise, and the port's file loads in the JAX
  ``load_sharded_checkpoint`` to the same arrays.
* ``run_distributed_e2e.main`` at 2 gloo ranks exits 0 with the JAX keys
  plus ``device`` and ``seconds``; shard files edited between the two
  phases so that the time axis breaks make it exit 1.
* Without a card, the worker and the driver raise before writing
  anything.

The JAX worker is imported from scripts/ as tests/test_validation_tools.py
imports the JAX scripts; no JAX file changes.
"""

import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu.parallel import ensemble as jens
from kmc_tpu_torch import convert
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.engine.observables import observe
from kmc_tpu_torch.parallel.launch import spawn
from kmc_tpu_torch.scripts import distributed_worker as pw
from kmc_tpu_torch.scripts import run_distributed_e2e as pe
from kmc_tpu_torch.state import SimState
from kmc_tpu_torch.testing import bonded_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import distributed_worker as jw  # noqa: E402

RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
RANK_TIMEOUT = 300
RPH, OUT_EVERY = 4, 10
WORKER = "kmc_tpu_torch.scripts.distributed_worker"


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


def run_ranks(n, extra):
    """n gloo ranks of the port's worker with ``extra`` arguments."""
    return spawn(n, lambda rank, port: [
        "-m", WORKER, "--pid", str(rank), "--nproc", str(n), "--port",
        str(port), "--device", "cpu", *extra],
        timeout=RANK_TIMEOUT, cwd=REPO, env=RANK_ENV)


def jax_blocks():
    """kmc_tpu's two blocks of the worker's configuration, seeded 0 and 1
    (host_local_ensemble at 2 ranks, seed 0)."""
    cfg = JConfig(**pw.DIST_CFG)
    return cfg, [jens.init_ensemble(cfg, RPH, seed=p) for p in range(2)]


@functools.cache
def jax_chunk():
    """kmc_tpu's eager chunk of OUT_EVERY steps, compiled once."""
    return jens.make_ensemble_chunk(JConfig(**pw.DIST_CFG), OUT_EVERY,
                                    donate=False)


def numpy_row(obs_blocks):
    """The JAX script's row, made with numpy from each block's
    observables."""
    cat = {f: np.concatenate([np.asarray(getattr(o, f)) for o in obs_blocks])
           for f in ("time_ns",) + pw.COLS}
    row = {"t": np.max(cat["time_ns"])}
    for c in pw.COLS:
        v = cat[c].astype(np.float32)
        row[c] = [np.mean(v), np.std(v), np.min(v), np.max(v)]
    return pw.format_row(row)


def shard_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_shards(a, b):
    za, zb = shard_arrays(a), shard_arrays(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], k)


# ---------------------------------------------------------------------------
# the worker's default mode

def test_default_mode_matches_jax(tmp_path):
    out = tmp_path / "stats.json"
    run_ranks(2, ["--out", str(out), "--replicas-per-host", str(RPH),
                  "--steps", "30"])
    got = json.loads(out.read_text())
    bonds, xy, step = 0.0, 0.0, 0.0
    for st in jax_blocks()[1]:
        for _ in range(30 // OUT_EVERY):
            st, obs = jax_chunk()(st)
        bonds += float(jnp.sum(obs.bond_num))
        xy += float(jnp.sum(st.a_xy.astype(jnp.float64)))
        step = max(step, float(jnp.max(st.step)))
    assert got["bond_sum"] == bonds
    assert got["step"] == step == 31.0
    np.testing.assert_allclose(got["xy_checksum"], xy, rtol=1e-5)
    assert got["replicas_global"] == 2 * RPH
    assert got["device"] == "cpu" and got["seconds"] > 0


# ---------------------------------------------------------------------------
# the production loop: 4 outputs, and 2 + 2 resumed

@pytest.fixture(scope="module")
def e2e_runs(tmp_path_factory):
    """Two ranks: 4 uninterrupted outputs; 2 outputs (kept as they were)
    and 2 more resumed from the shard files."""
    root = tmp_path_factory.mktemp("e2e")
    dirs = {k: root / k for k in ("whole", "cut", "first")}
    base = ["--out", str(root / "unused"), "--replicas-per-host", str(RPH),
            "--out-every", str(OUT_EVERY)]
    run_ranks(2, base + ["--e2e-out-dir", str(dirs["whole"]), "--outputs",
                         "4"])
    run_ranks(2, base + ["--e2e-out-dir", str(dirs["cut"]), "--outputs",
                         "2"])
    shutil.copytree(dirs["cut"], dirs["first"])
    run_ranks(2, base + ["--e2e-out-dir", str(dirs["cut"]), "--outputs",
                         "2", "--resume"])
    return dirs


def test_e2e_rows_match_jax(e2e_runs):
    blocks = jax_blocks()[1]
    want = [pw.HEADER]
    for _ in range(2):
        outs = [jax_chunk()(st) for st in blocks]
        blocks = [st for st, _ in outs]
        want.append(numpy_row([obs for _, obs in outs]))
    got = (e2e_runs["first"] / "bond_ens.dat").read_text()
    assert got == "".join(want)
    timing = json.loads((e2e_runs["first"] / "timing.pid1.json").read_text())
    assert (timing["nproc"], timing["pid"], timing["resumed_at"],
            timing["final_step"]) == (2, 1, 0, 2 * OUT_EVERY + 1)


def test_e2e_resume_equals_uninterrupted(e2e_runs):
    whole, cut = e2e_runs["whole"], e2e_runs["cut"]
    rows = (cut / "bond_ens.dat").read_text()
    assert rows == (whole / "bond_ens.dat").read_text()
    assert len(rows.splitlines()) == 5
    for p in range(2):
        assert_same_shards(cut / f"checkpoint.shard{p}.npz",
                           whole / f"checkpoint.shard{p}.npz")
        timing = json.loads((cut / f"timing.pid{p}.json").read_text())
        assert (timing["resumed_at"], timing["final_step"]) == (
            2, 4 * OUT_EVERY + 1)
    assert shard_arrays(cut / "checkpoint.shard0.npz")["k_done"] == 4


def test_ensemble_row_matches_jax_collect():
    """The row on bonded replicas (non-trivial means and spreads) equals
    the JAX script's jitted collect, formatted."""
    cfg = SimConfig(**pw.DIST_CFG)
    st = bonded_state(cfg, 16, seed=3, device="cpu")
    obs = observe(st, cluster_labels(st, cfg), cfg)
    got = pw.format_row(pw.ensemble_row(obs))

    @jax.jit
    def collect(o):
        out = {"t": jnp.max(o["time_ns"])}
        for c in pw.COLS:
            v = o[c].astype(jnp.float32)
            out[c] = jnp.stack([jnp.mean(v), jnp.std(v), jnp.min(v),
                                jnp.max(v)])
        return out

    row = collect({f: jnp.asarray(getattr(obs, f).numpy())
                   for f in obs._fields})
    want = pw.format_row({c: np.asarray(v) for c, v in row.items()})
    assert got == want
    assert float(obs.bond_num.float().std()) > 0


# ---------------------------------------------------------------------------
# shard files across the packages, one process

def test_shard_files_cross_packages(tmp_path):
    """A cold-start block (the file's layout is what crosses).  At one
    process the JAX loader lays the block over every local device, so the
    block holds a multiple of their count."""
    jst = jens.init_ensemble(JConfig(**pw.DIST_CFG),
                             2 * jax.local_device_count(), seed=0)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    assert jw.save_sharded_checkpoint(str(jdir), jst, 3) >= 0
    got, k = pw.load_sharded_checkpoint(str(jdir), "cpu")
    assert k == 3
    want = {f: np.asarray(jax.random.key_data(v) if f == "key" else v)
            for f, v in jst._asdict().items()}
    for f, w in want.items():
        g = convert.to_numpy(got)[f]
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, f)

    pw.save_sharded_checkpoint(str(tdir), got, 7)
    back, k = jw.load_sharded_checkpoint(str(tdir), jst)
    assert k == 7
    for f, w in want.items():
        v = getattr(back, f)
        g = np.asarray(jax.random.key_data(v) if f == "key" else v)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, f)


# ---------------------------------------------------------------------------
# run_distributed_e2e

def _driver_argv(tmp_path):
    return ["--nproc", "2", "--device", "cpu", "--replicas-per-host", "2",
            "--outputs", "2", "--out-every", "5", "--workdir",
            str(tmp_path / "work"), "--out", str(tmp_path / "report.json")]


def test_driver_main_reports_the_jax_keys(tmp_path):
    assert pe.main(_driver_argv(tmp_path)) == 0
    rep = json.loads((tmp_path / "report.json").read_text())
    assert set(rep) == {"nproc", "replicas_global", "outputs_per_phase",
                        "out_every", "resume_time_axis_seamless",
                        "per_process", "machinery_s_per_interval", "note",
                        "device", "seconds"}
    assert (rep["nproc"], rep["replicas_global"], rep["device"]) == (
        2, 4, "cpu")
    assert set(rep["machinery_s_per_interval"]) == {
        "collect_mean", "checkpoint_mean", "step_mean"}
    assert [t["pid"] for t in rep["per_process"]] == [0, 1]
    assert all(t["resumed_at"] == 2 for t in rep["per_process"])


def test_driver_fails_on_a_broken_time_axis(tmp_path, monkeypatch,
                                            capsys):
    """The shard files' step counters moved on by 1,000 steps between
    the fresh run and the resume: the rows jump, and the driver exits 1
    without a report."""
    real, calls = pe.spawn, []

    def spawn_then_edit(nproc, workdir, extra, device):
        out = real(nproc, workdir, extra, device)
        calls.append(extra)
        if len(calls) == 1:
            i = list(SimState._fields).index("step")
            for p in range(nproc):
                path = os.path.join(workdir, f"checkpoint.shard{p}.npz")
                arrs = shard_arrays(path)
                arrs[f"leaf{i}"] = arrs[f"leaf{i}"] + 1000
                np.savez(path, **arrs)
        return out

    monkeypatch.setattr(pe, "spawn", spawn_then_edit)
    assert pe.main(_driver_argv(tmp_path)) == 1
    assert len(calls) == 2
    assert "without a gap" in capsys.readouterr().err
    assert not (tmp_path / "report.json").exists()


# ---------------------------------------------------------------------------
# no card

@pytest.mark.parametrize("which", ["worker", "driver"])
def test_without_a_card_raises_before_writing(tmp_path, which):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if which == "worker":
            pw.main(["--pid", "0", "--nproc", "1", "--port", "1", "--out",
                     str(tmp_path / "stats.json"), "--e2e-out-dir",
                     str(tmp_path / "e2e")])
        else:
            pe.main(["--nproc", "1", "--workdir", str(tmp_path / "work"),
                     "--out", str(tmp_path / "report.json")])
    assert os.listdir(tmp_path) == []
