"""The port's timing programs (kmc_tpu_torch/scripts/bench.py,
replica_scaling.py, weak_scaling.py and run_distributed_bench.py) against
the JAX package's bench.py and scripts/ on the same inputs, on the CPU.

* events_per_step is 67,400 at SimConfig() in both packages.
* bench: both mains in lazy and eager mode at the dense config (24 + 8
  molecules in 700 x 700 x 200 A, fused_align=False on both sides), 4
  replicas, a warm-up and one timed chunk of 3 steps: the stdout line has
  the JAX line's keys with the same metric and unit, and vs_baseline is
  the rate over the same BASELINE_MEASURED.json value; the state the
  port's bench leaves equals, bitwise, the port's chunk driven directly,
  and the JAX bench's topology, flags and keys bitwise, poses within the
  1e-4 A of tests/test_torch_ensemble.py.
* replica_scaling: both mains at 4 replicas, chunk 2: rows with the JAX
  rows' keys (plus the port's ``device`` and ``seconds``), the same
  replica count, ``--out`` the printed rows.
* weak_scaling: the JAX main with two of its virtual CPU devices and the
  port's gloo ranks at sizes 1 and 2 (2 replicas a rank): rows with the
  same keys; each rank's final block equals, bitwise, the same replicas
  run as one block in this process.
* run_distributed_bench: the JAX main with its ``run`` replaced by a stub
  (so it starts no jax.distributed processes) and the port's main on one
  and two gloo ranks of the worker: reports with the same keys.
* Each main raises without a card before it prints or writes anything.

The JAX programs are imported as tests/test_torch_validation_scripts.py
does; ``SimConfig`` is replaced with monkeypatch; no JAX file changes.
bench.py and scripts/replica_scaling.py turn JAX's persistent cache on
when they are imported, so they are imported inside their tests with
KMC_JAX_CACHE in tmp_path and the cache settings restored after."""

import contextlib
import importlib
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import kmc_tpu.config
import kmc_tpu.parallel.ensemble as jens
from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu.utils.profiling import events_per_step as j_events_per_step
from kmc_tpu_torch.config import SimConfig as TConfig
from kmc_tpu_torch.parallel.ensemble import (init_ensemble,
                                             make_ensemble_chunk,
                                             make_lazy_ensemble_chunk)
from kmc_tpu_torch.scripts import bench as pbench
from kmc_tpu_torch.scripts import replica_scaling as prs
from kmc_tpu_torch.scripts import run_distributed_bench as pdb
from kmc_tpu_torch.scripts import weak_scaling as pws
from kmc_tpu_torch.scripts.validate_vs_reference import state_arrays
from kmc_tpu_torch.state import SimState, take_replicas
from kmc_tpu_torch.utils.profiling import events_per_step

from test_torch_clusters import jax_fields
from test_torch_ensemble import assert_states_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "scripts")):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = dict(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
             cell_range_z=200.0, fused_align=False)
PORT_ONLY = {"device", "seconds"}
CPU = torch.device("cpu")


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


@pytest.fixture
def jax_import(monkeypatch, tmp_path):
    """Imports a JAX program afresh with its persistent cache in tmp_path;
    the cache settings it changes are restored afterwards."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    was = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.setenv("KMC_JAX_CACHE", str(tmp_path / "jax_cache"))
    names = []

    def load(name):
        sys.modules.pop(name, None)
        names.append(name)
        return importlib.import_module(name)

    try:
        yield load
    finally:
        for name in names:
            sys.modules.pop(name, None)
        for k, v in was.items():
            jax.config.update(k, v)


def small_configs(monkeypatch, module):
    """SimConfig() is the dense config in kmc_tpu and in ``module``."""
    monkeypatch.setattr(kmc_tpu.config, "SimConfig",
                        lambda **a: JConfig(**{**DENSE, **a}))
    monkeypatch.setattr(module, "SimConfig",
                        lambda **a: TConfig(**{**DENSE, **a}))
    return TConfig(**DENSE)


def run_jax_main(monkeypatch, module, argv):
    """A JAX program's ``main()`` (it reads sys.argv): (stdout, stderr)."""
    monkeypatch.setattr(sys, "argv", [module.__name__ + ".py", *argv])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        module.main()
    return out.getvalue(), err.getvalue()


def run_port_main(main, argv, **kw):
    """A port program's ``main(argv)``: (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv, **kw) == 0
    return out.getvalue(), err.getvalue()


def test_events_per_step_matches():
    assert events_per_step(TConfig()) == j_events_per_step(JConfig()) \
        == 67_400


# ---------------------------------------------------------------------------
# bench.py


@pytest.mark.parametrize("mode", ["lazy", "eager"])
def test_bench_matches_jax(mode, monkeypatch, tmp_path, jax_import):
    replicas, chunk, repeats = 4, 3, 1
    for k, v in (("REPLICAS", replicas), ("CHUNK", chunk),
                 ("REPEATS", repeats), ("MODE", mode)):
        monkeypatch.setenv(f"KMC_BENCH_{k}", str(v))
    cfg = small_configs(monkeypatch, pbench)
    jbench = jax_import("bench")

    # the JAX bench's final state, recorded from the chunk it builds
    jax_last = []
    make = "make_lazy_ensemble_chunk" if mode == "lazy" else \
        "make_ensemble_chunk"
    real_make = getattr(jens, make)

    def recording_make(*a, **kw):
        run = real_make(*a, **kw)

        def rec(state):
            out = run(state)
            jax_last[:] = [out[0]]
            return out
        return rec

    monkeypatch.setattr(jens, make, recording_make)
    jout, _ = run_jax_main(monkeypatch, jbench, [])
    jline = json.loads(jout.strip().splitlines()[-1])
    assert tmp_path.joinpath("jax_cache").is_dir()

    # the port's bench (sizes from the same variables), its state recorded
    port_last = []
    real_measure = pbench.measure

    def recording_measure(*a, **kw):
        steps, dt, state = real_measure(*a, **kw)
        port_last[:] = [state]
        return steps, dt, state

    monkeypatch.setattr(pbench, "measure", recording_measure)
    pout, perr = run_port_main(pbench.main, ["--device", "cpu"])
    lines = pout.strip().splitlines()
    assert len(lines) == 1
    pline = json.loads(lines[0])
    assert set(pline) == set(jline) | PORT_ONLY
    assert (pline["metric"], pline["unit"]) == (jline["metric"],
                                                jline["unit"])
    assert pline["device"] == "cpu"
    # vs_baseline is the rate over the same reference rate in both
    assert jline["vs_baseline"] is not None
    np.testing.assert_allclose(pline["vs_baseline"] / pline["value"],
                               jline["vs_baseline"] / jline["value"],
                               rtol=1e-12)
    assert f"# mode={mode} {replicas} replicas x {repeats * chunk} steps" \
        in perr

    # the port's bench state equals its chunk driven directly, bitwise
    state = init_ensemble(cfg, replicas, seed=0, device=CPU)
    run = (make_lazy_ensemble_chunk(cfg, chunk, k_align=32, device=CPU)
           if mode == "lazy" else make_ensemble_chunk(cfg, chunk, CPU))
    for _ in range(1 + repeats):
        state, _ = run(state)
    got = port_last[0]
    for f in SimState._fields:
        assert torch.equal(getattr(got, f), getattr(state, f)), f
    assert int(got.step[0]) == 1 + (1 + repeats) * chunk
    # and the JAX bench's: topology, flags, keys bitwise, poses 1e-4 A
    assert_states_match(got, jax_fields(jax_last[0]), f"bench {mode}")


# ---------------------------------------------------------------------------
# replica_scaling


def test_replica_scaling_matches_jax(monkeypatch, tmp_path, jax_import):
    small_configs(monkeypatch, prs)
    jrs = jax_import("replica_scaling")
    jout, _ = run_jax_main(monkeypatch, jrs, ["--counts", "4", "--chunk",
                                              "2"])
    jrows = [json.loads(l) for l in jout.strip().splitlines()]
    out = tmp_path / "rows.json"
    pout, perr = run_port_main(prs.main, ["--counts", "4", "--chunk", "2",
                                          "--device", "cpu", "--out",
                                          str(out)])
    prows = [json.loads(l) for l in pout.strip().splitlines()]
    assert [r["replicas"] for r in prows] == [r["replicas"] for r in jrows] \
        == [4]
    for p, j in zip(prows, jrows):
        assert set(p) == set(j) | PORT_ONLY
        assert p["device"] == "cpu"
        assert p["ms_per_step_inscan"] > 0 and p["ms_per_dispatch_total"] > 0
    assert json.loads(out.read_text()) == prows
    assert perr.startswith("# device: cpu")


# ---------------------------------------------------------------------------
# weak_scaling


def test_weak_scaling_rows_match_jax(monkeypatch, jax_import):
    small_configs(monkeypatch, pws)
    jws = jax_import("weak_scaling")
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])
    argv = ["--per-device", "2", "--chunk", "2", "--repeats", "1", "--cpu"]
    jout, _ = run_jax_main(monkeypatch, jws, argv)
    jrep = json.loads(jout)
    # the port's main at the CPU's first size only: the ranks' blocks are
    # held at sizes 1 and 2 below
    monkeypatch.setattr(pws, "CPU_DEVICES", 1)
    pout, perr = run_port_main(pws.main, argv)
    prep = json.loads(pout)
    assert set(prep) == {"weak_scaling"} | PORT_ONLY
    assert prep["device"] == "cpu"
    assert [r["devices"] for r in jrep["weak_scaling"]] == [1, 2]
    assert [r["devices"] for r in prep["weak_scaling"]] == [1]
    for p in prep["weak_scaling"]:
        assert set(p) == set(jrep["weak_scaling"][0])
        assert p["replicas"] == 2 and p["efficiency"] == 1.0
    assert "# 1 devices:" in perr


def test_weak_scaling_ranks_equal_one_block(tmp_path):
    cfg = TConfig(**DENSE)
    per, chunk, repeats = 2, 3, 1
    rows = pws.run_sizes([1, 2], per, chunk, repeats, "cpu", cfg=cfg,
                         work_dir=str(tmp_path), save_state=True,
                         log=io.StringIO())
    assert [(r["devices"], r["replicas"]) for r in rows] == [(1, 2), (2, 4)]
    for n in (1, 2):
        whole = init_ensemble(cfg, per * n, seed=0, device=CPU)
        run = make_ensemble_chunk(cfg, chunk, CPU)
        for _ in range(1 + repeats):
            whole, _ = run(whole)
        for p in range(n):
            want = state_arrays(take_replicas(
                whole, torch.arange(p * per, (p + 1) * per)))
            with np.load(tmp_path / f"n{n}" / f"rank{p}.npz") as z:
                assert sorted(z.files) == sorted(want)
                for k, w in want.items():
                    assert z[k].dtype == w.dtype, (n, p, k)
                    np.testing.assert_array_equal(z[k], w, f"{n} {p} {k}")


# ---------------------------------------------------------------------------
# run_distributed_bench


def test_distributed_bench_report_matches_jax(monkeypatch, tmp_path):
    import run_distributed_bench as jdb

    def stub(nproc, port, reps, steps, repeats, tag):
        # the keys of the JAX worker's ``bench`` (distributed_worker.py)
        return {"bench": {"nproc": nproc, "replicas_global": reps * nproc,
                          "steps_timed": repeats * steps,
                          "replica_steps_per_s": 100.0 * nproc}}

    monkeypatch.setattr(jdb, "run", stub)
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    run_jax_main(monkeypatch, jdb, ["--out", str(jpath)])
    jrep = json.loads(jpath.read_text())
    pout, _ = run_port_main(pdb.main, [
        "--replicas-per-host", "2", "--steps", "3", "--repeats", "1",
        "--device", "cpu", "--out", str(ppath)])
    prep = json.loads(ppath.read_text())
    assert json.loads(pout) == prep
    assert set(prep) == set(jrep) | PORT_ONLY
    for k in ("one_process", "two_process"):
        assert set(prep[k]) == set(jrep[k])
    assert (prep["one_process"]["nproc"], prep["two_process"]["nproc"]) \
        == (1, 2)
    assert prep["two_process"]["replicas_global"] == 4
    assert prep["two_process"]["steps_timed"] == 3
    assert prep["two_vs_one_total_rate"] == (
        prep["two_process"]["replica_steps_per_s"]
        / prep["one_process"]["replica_steps_per_s"])
    assert "gloo" in prep["caveat"] and prep["device"] == "cpu"


# ---------------------------------------------------------------------------
# no card


@pytest.mark.parametrize("name", ["bench", "replica_scaling", "weak_scaling",
                                  "run_distributed_bench"])
def test_main_without_a_card_raises_before_writing(name, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench": pbench.main, "replica_scaling": prs.main,
            "weak_scaling": pws.main, "run_distributed_bench": pdb.main}[name]
    out = tmp_path / "out.json"
    argv = [] if name in ("bench", "weak_scaling") else ["--out", str(out)]
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se), \
            pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not out.exists() and so.getvalue() == "" and se.getvalue() == ""
