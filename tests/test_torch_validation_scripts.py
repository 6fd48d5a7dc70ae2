"""The port's physics-validation scripts (kmc_tpu_torch/scripts/
early_cluster_size_check.py, validate_lattice_physics.py and
measure_residual_overlap.py) against the JAX package's scripts/ on the
same inputs, on the CPU.

* early_cluster_size_check: both mains on validation_torch/state.npz with
  both oracles, on a copy with overflow mass in some rows and one row
  without a cluster larger than 1, with --max-rows past the file's rows,
  and on a state file the JAX validation driver wrote: the same report
  (JSON-equal apart from the port's ``device`` and ``seconds``) and the
  same exit code.
* validate_lattice_physics: receptor_msd_slope_from_gro on the first 5
  frames of ref_data/refgolden_test.gro is equal; ``msd`` at 20 steps
  (with and without --ref-gro) gives a bitwise equal
  ``lattice_msd_A2_per_step`` and a JSON-equal report apart from
  ``device``, ``seconds`` and ``kernel``; ``rates`` at 40 steps gives a
  bitwise equal ``hist_fixed_dt`` and ``early_fd_per_step``, and its
  rejection-free fields are equal too: the free run (896 events to
  t = 41.7) meets no ulp tie.  Were they to part, the test replays both
  runs event by event and holds the parting state to ``testing.rf_tie``.
* measure_residual_overlap: at the tests' dense config (24 + 8 molecules
  in 700 x 700 x 200 A, fused_align=False on both sides), 4 replicas, 2
  chunks of 10 steps, the per-chunk counts and the report are equal.  No
  small config was found where the count is non-zero (boxes of 200-900 A
  with 24-150 receptors, diffusion constants up to 10^4 times the
  reference's, 8 replicas x 200 steps: 0 everywhere), so the count's
  accumulation is also held on a stand-in step that flags known replicas.
* Each script's main raises without a card before it writes anything.

The JAX scripts are imported from scripts/ as tests/test_validation_tools.py
does; ``SimConfig`` and ``run_config`` are replaced with monkeypatch; no
JAX file changes.  scripts/measure_residual_overlap.py turns JAX's
persistent cache on when it is imported, so it is imported inside its
test with KMC_JAX_CACHE in tmp_path and the cache settings restored
after."""

import contextlib
import importlib
import io
import itertools
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import kmc_tpu.config
from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu_torch.config import SimConfig as TConfig
from kmc_tpu_torch.scripts import early_cluster_size_check as pec
from kmc_tpu_torch.scripts import measure_residual_overlap as pro
from kmc_tpu_torch.scripts import validate_lattice_physics as plp
from kmc_tpu_torch.testing import rf_tie

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import early_cluster_size_check as jec  # noqa: E402
import validate_lattice_physics as jlp  # noqa: E402
import validate_vs_reference as jv  # noqa: E402

REF = os.path.join(REPO, "ref_data")
ORACLES = [os.path.join(REF, "refgolden_bond.dat"),
           os.path.join(REF, "refgolden2_bond.dat")]
STATE = os.path.join(REPO, "validation_torch", "state.npz")
DENSE = dict(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
             cell_range_z=200.0, fused_align=False, out_every=20)
PORT_ONLY = ("device", "seconds", "kernel")


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


def run_jax_main(monkeypatch, module, argv):
    """A JAX script's ``main()`` (it reads sys.argv): (return value,
    stderr)."""
    monkeypatch.setattr(sys, "argv", [module.__name__ + ".py", *argv])
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = module.main()
    return rc, err.getvalue()


def run_port_main(module, argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = module.main(argv)
    return rc, err.getvalue()


def read_report(path, drop=PORT_ONLY):
    with open(path) as f:
        rep = json.load(f)
    return {k: v for k, v in rep.items() if k not in drop}


def assert_same_mains(monkeypatch, tmp_path, jmod, pmod, argv, jargv=None):
    """Both mains on ``argv`` (plus --out): equal exit codes and reports
    apart from the port's own keys; returns (JAX report, port report)."""
    jout, pout = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jrc, _ = run_jax_main(monkeypatch, jmod,
                          [*(argv if jargv is None else jargv), "--out", jout])
    prc, _ = run_port_main(pmod, [*argv, "--out", pout])
    jrep, prep = read_report(jout), read_report(pout)
    assert prep == jrep
    assert prc == jrc
    return jrep, read_report(pout, drop=())


# ---------------------------------------------------------------------------
# early_cluster_size_check


def _edited_state(tmp_path):
    """A copy of the committed state with overflow mass (bin 16) in one
    replica of rows 3 and 7 and no cluster larger than 1 in row 1."""
    with np.load(STATE) as z:
        arrs = dict(z)
    h = arrs["hists"].copy()
    h[[3, 7], 0, -1] += 1.0
    h[1, :, 2:] = 0.0
    arrs["hists"] = h
    path = str(tmp_path / "state.npz")
    np.savez(path, **arrs)
    return path


@pytest.mark.parametrize("case", ["committed", "edited", "past_end",
                                  "failing"])
def test_early_cluster_size_matches(monkeypatch, tmp_path, case):
    state, rows, refs = STATE, "22", ORACLES
    if case == "edited":
        state = _edited_state(tmp_path)
    elif case == "past_end":
        rows = "1000"
    elif case == "failing":
        # the oracle's bond.dat with its cluster_size column raised far out
        # of any band
        ref = np.loadtxt(ORACLES[0])
        ref[:, 5] += 50.0
        bad = str(tmp_path / "bond.dat")
        np.savetxt(bad, ref, fmt="%.3f")
        refs = [ORACLES[1], bad]
    jrep, prep = assert_same_mains(
        monkeypatch, tmp_path, jec, pec,
        ["--state", state, "--ref-bond", *refs, "--max-rows", rows])
    assert prep["device"] == "cpu" and prep["seconds"] > 0
    with np.load(state) as z:
        n_rows = len(z["hists"])
    assert jrep["rows_considered"] == min(int(rows), n_rows)
    if case == "edited":
        assert jrep["rows_excluded_overflow"] == 2
        assert all(r["n_tested"] == min(int(rows), n_rows) - 2
                   for r in jrep["runs"])
    assert jrep["ok"] == (case != "failing")


def test_early_cluster_size_reads_the_jax_drivers_state_file(monkeypatch,
                                                             tmp_path):
    """A state file the JAX validation driver wrote (2 outputs of the dense
    config at 4 replicas, with histograms) gives both mains one report."""
    sf = str(tmp_path / "jax_state.npz")
    args = types.SimpleNamespace(
        replicas=4, seed=0, sub_chunks=1, align_mode="eager", init_cpt=None,
        write_outputs=None, state_file=sf, resume_state=True)
    with monkeypatch.context() as m:
        m.setattr(jv, "run_config", lambda: JConfig(**{**DENSE,
                                                       "out_every": 5}))
        with contextlib.redirect_stderr(io.StringIO()):
            jv._run_ensemble(args, 2, True)
    with np.load(sf) as z:
        assert z["hists"].shape == (2, 4, 17)
    jrep, _ = assert_same_mains(monkeypatch, tmp_path, jec, pec,
                                ["--state", sf, "--ref-bond", *ORACLES])
    assert jrep["rows_considered"] == 2


# ---------------------------------------------------------------------------
# validate_lattice_physics


def _gro(tmp_path, frames=5):
    cfg = JConfig()
    path = str(tmp_path / "test.gro")
    with open(os.path.join(REF, "refgolden_test.gro")) as f, \
            open(path, "w") as g:
        g.writelines(itertools.islice(
            f, frames * (cfg.n_a * 4 + cfg.n_b * 3 + 3)))
    return path


def test_receptor_msd_slope_from_gro_matches(tmp_path):
    cfg = JConfig()
    path = _gro(tmp_path)
    a = (path, cfg.n_a, cfg.n_b, (cfg.cell_range_x, cfg.cell_range_y),
         cfg.time_step)
    got, want = plp.receptor_msd_slope_from_gro(*a), \
        jlp.receptor_msd_slope_from_gro(*a)
    assert got == want
    assert got[1] == 5


@pytest.mark.parametrize("ref_gro", [False, True])
def test_lattice_msd_matches(monkeypatch, tmp_path, ref_gro):
    argv = ["msd", "--steps", "20"]
    if ref_gro:
        argv += ["--ref-gro", _gro(tmp_path)]
    jrep, prep = assert_same_mains(monkeypatch, tmp_path, jlp, plp,
                                   [*argv, "--device", "cpu"], jargv=argv)
    assert prep["lattice_msd_A2_per_step"] == jrep["lattice_msd_A2_per_step"]
    assert ("ref_binary_msd_A2_per_step" in jrep) == ref_gro
    assert prep["kernel"] == "plain" and prep["device"] == "cpu"


def _rf_parting(tcfg, jcfg, st0, t_end):
    """Replay both rejection-free runs event by event from ``st0`` (the
    port's state) until they part; return the port's state before the
    parting event."""
    import jax.numpy as jnp

    from kmc_tpu.lattice import grid as jg
    from kmc_tpu.lattice import rejection_free as jrf
    from kmc_tpu_torch import convert
    from kmc_tpu_torch.lattice import rejection_free as trf

    jstep = jax.jit(lambda s: jrf.rf_step(s, jcfg))
    js = jg.LatticeState(**{k: jnp.asarray(v) for k, v in
                            convert.lattice_to_numpy(st0).items()})
    ts = st0
    while float(ts.time) < t_end:
        prev = ts
        js, ts = jstep(js), trf.rf_step(ts, tcfg)
        if not np.array_equal(ts.grid.numpy(), np.asarray(js.grid)):
            return prev
    raise AssertionError("the runs differ but no event parted them")


def test_lattice_rates_match(monkeypatch, tmp_path):
    """``rates`` through both mains: every field equal; the rejection-free
    ones may differ only after an ulp tie of the free run."""
    argv = ["rates", "--steps", "40"]
    jout, pout = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jrc, _ = run_jax_main(monkeypatch, jlp, [*argv, "--out", jout])
    prc, _ = run_port_main(plp, [*argv, "--device", "cpu", "--out", pout])
    jrep, prep = read_report(jout), read_report(pout, drop=())
    rf_keys = ("hist_rf_matched_time", "rf_time", "rf_events", "ok")
    assert {k: v for k, v in prep.items()
            if k not in rf_keys + PORT_ONLY} == \
        {k: v for k, v in jrep.items() if k not in rf_keys}
    for k in ("hist_fixed_dt", "early_fd_per_step"):
        assert prep[k] == jrep[k], k
    assert prep["kernel"] == "plain"
    if any(prep[k] != jrep[k] for k in rf_keys):
        from kmc_tpu.lattice.mapping import reference_lattice_config
        from kmc_tpu_torch.config import LatticeConfig
        from kmc_tpu_torch.lattice.grid import init_lattice

        jcfg = reference_lattice_config(JConfig(), reaction="mono_cis",
                                        height=128, width=128, density=0.3)
        tcfg = LatticeConfig(**jcfg.to_dict())
        st0 = init_lattice(tcfg, seed=0, device="cpu")
        assert rf_tie(_rf_parting(tcfg, jcfg, st0, 40.0), tcfg)
    else:
        assert prc == jrc


# ---------------------------------------------------------------------------
# measure_residual_overlap


@pytest.fixture
def jax_residual_overlap(monkeypatch, tmp_path):
    """The JAX script, imported with its persistent cache in tmp_path; the
    cache settings it changes are restored afterwards."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    was = {k: getattr(jax.config, k) for k in keys}
    monkeypatch.setenv("KMC_JAX_CACHE", str(tmp_path / "jax_cache"))
    sys.modules.pop("measure_residual_overlap", None)
    try:
        yield importlib.import_module("measure_residual_overlap")
    finally:
        for k, v in was.items():
            jax.config.update(k, v)


def test_residual_overlap_matches(monkeypatch, tmp_path,
                                  jax_residual_overlap):
    kw = {k: v for k, v in DENSE.items() if k != "out_every"}
    monkeypatch.setattr(kmc_tpu.config, "SimConfig",
                        lambda **a: JConfig(**{**kw, **a}))
    monkeypatch.setattr(pro, "run_config",
                        lambda dense=False: TConfig(
                            **kw, sweep_exact_cleanup=False))
    argv = ["--replicas", "4", "--chunks", "2", "--chunk-steps", "10"]
    jout, pout = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    _, jerr = run_jax_main(monkeypatch, jax_residual_overlap,
                           [*argv, "--cpu", "--out", jout])
    prc, perr = run_port_main(pro, [*argv, "--device", "cpu", "--out", pout])
    assert prc == 0
    chunk_lines = lambda err: [l for l in err.splitlines()
                               if l.startswith("# chunk")]
    assert chunk_lines(perr) == chunk_lines(jerr)
    assert len(chunk_lines(perr)) == 2
    prep = read_report(pout)
    assert prep == read_report(jout)
    assert prep["replica_steps"] == 80
    assert tmp_path.joinpath("jax_cache").is_dir()


@pytest.mark.parametrize("dense", [False, True])
def test_residual_overlap_config_matches(dense):
    kw = dict(cell_range_x=2886.5, cell_range_y=2886.5) if dense else {}
    assert pro.run_config(dense).to_dict() == \
        JConfig(sweep_exact_cleanup=False, **kw).to_dict()


def test_residual_overlap_counts_each_chunk(monkeypatch):
    """The chunk count sums the flag over steps and replicas: a stand-in
    step flags replica r on steps where (step + r) % 3 == 0."""
    cfg = TConfig(**DENSE)
    seen = []

    def fake(state, cfg, device=None, batched=False):
        assert batched
        r = torch.arange(state.step.shape[0])
        flag = ((state.step.to(torch.int64) + r) % 3 == 0).to(torch.int32)
        seen.append(int(flag.sum()))
        return state._replace(step=state.step + 1), None, {
            "residual_overlap": flag}

    import kmc_tpu_torch.engine.step as step_mod

    monkeypatch.setattr(step_mod, "step_fn_diag", fake)
    calls = []
    counts, st = pro.measure(cfg, 5, 3, 4, device="cpu",
                             on_chunk=lambda k, t: calls.append((k, t)))
    assert counts == [sum(seen[i:i + 4]) for i in range(0, 12, 4)]
    assert sum(counts) > 0
    assert calls == list(zip(range(3), np.cumsum(counts).tolist()))
    assert int(st.step[0]) == 12 + 1


# ---------------------------------------------------------------------------
# no card


@pytest.mark.parametrize("argv", [
    ("lattice", ["msd", "--steps", "1"]),
    ("lattice", ["rates", "--steps", "1"]),
    ("overlap", ["--replicas", "2", "--chunks", "1", "--chunk-steps", "1"]),
], ids=["lattice_msd", "lattice_rates", "residual_overlap"])
def test_main_without_a_card_raises_before_writing(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    mod = {"lattice": plp, "overlap": pro}[argv[0]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([*argv[1], "--out", str(tmp_path / "report.json")])
    assert os.listdir(tmp_path) == []
