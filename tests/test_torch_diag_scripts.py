"""The port's flux diagnostics (kmc_tpu_torch/scripts/mini_golden.py,
receptors_probe.py and chan_flux.py) against the JAX package's scripts/ on
the same inputs, on the CPU.  About 40 s alone here.

* mini_golden: ``our_config(b)`` for b in 1, 3, 10 and ``probe_config()``
  give the same fields.
* receptors_probe ``ours``: at the dense 24 + 1 configuration (700 x 700 x
  200 A, every association rate 0, fused_align=False on both sides: JAX
  off the TPU runs the unfused idealize), 4 replicas, seed 7, 2 chunks of
  10 steps: every key of the npz equal per replica (exact integers),
  ``elig_mono`` nonzero.  ``report`` over fake ``runN/chan.dat`` files:
  the JAX and port reports equal apart from the port's own keys, also
  when each package reads the other's npz; with ``--ref-json
  RECEPTORS_PROBE_r05.json`` the port reproduces that file's ``ref_*``
  fields exactly.
* chan_flux: ``build_preformed`` at the mini configuration with 8
  complexes, topology, flags and key bitwise, positions within 1e-4 A,
  angles and quaternions within 1e-6 (float32 cos / sin of two
  libraries); ``--reuse-refs`` over fake chan.dat files at a dense
  configuration where all three eligibility counts are nonzero (40 + 8
  molecules in 640 x 640 x 200 A, diffusion 20x and rotation 30x the
  reference's, 3 preformed complexes), 4 replicas, 3 outputs of 10 steps:
  the run_ours series equal (exact integers) and the reports equal apart
  from the port's own keys.  With ``--ref-json`` the quarter points come
  from the reference's output count, and a run cut by ``--max-out``
  reports null where it did not reach.
* Each main raises without a card before it writes anything, and the
  stages that need the C++ reference source raise.

The JAX scripts are imported from scripts/ as tests/test_validation_tools.py
does; their configurations are replaced with monkeypatch; no JAX file
changes.  The JAX stages turn JAX's persistent cache on when they run, so
KMC_JAX_CACHE points into a temporary directory and the cache settings are
restored after.
"""

import contextlib
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu_torch import convert
from kmc_tpu_torch.config import SimConfig as TConfig
from kmc_tpu_torch.scripts import chan_flux as pcf
from kmc_tpu_torch.scripts import mini_golden as pmg
from kmc_tpu_torch.scripts import receptors_probe as prp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chan_flux as jcf  # noqa: E402
import mini_golden as jmg  # noqa: E402
import receptors_probe as jrp  # noqa: E402

PROBE = dict(n_a=24, n_b=1, cell_range_x=700.0, cell_range_y=700.0,
             cell_range_z=200.0, fused_align=False, ass_rate=0.0,
             mono_cis_ass_rate=0.0, cis_ass_rate=0.0, out_every=10)
# dense enough that trans, mono-cis and cis eligibility all count in 30
# steps from 3 preformed complexes
FLUX = dict(n_a=40, n_b=8, cell_range_x=640.0, cell_range_y=640.0,
            cell_range_z=200.0, fused_align=False, rb_a_d=20.0,
            bond_d=10.0, cis_d=10.0, rb_a_rot_d=0.0174 * 30,
            bond_rot_d=0.005 * 30, cis_rot_d=0.005 * 30)
PROBE_REPLICAS, PROBE_CHUNK, PROBE_CHUNKS = 4, 10, 2
PORT_ONLY = ("device", "seconds", "ref_json", "ours_outputs", "ours_steps",
             "ours_quarter_std", "ours_at_last_output")
R05 = os.path.join(REPO, "RECEPTORS_PROBE_r05.json")
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes", "jax_platforms")


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


@contextlib.contextmanager
def jax_scripts_env(cache_dir):
    """The JAX scripts' persistent cache pointed at ``cache_dir``; the
    settings they change restored afterwards."""
    was = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KMC_JAX_CACHE", str(cache_dir))
        try:
            yield mp
        finally:
            for k, v in was.items():
                jax.config.update(k, v)


def run_jax_main(mp, module, argv):
    """A JAX script's ``main()`` (it reads sys.argv): stderr."""
    mp.setattr(sys, "argv", [module.__name__ + ".py", *argv])
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        module.main()
    return err.getvalue()


def run_port_main(module, argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert module.main(argv) == 0
    return err.getvalue()


def read_json(path, drop=PORT_ONLY):
    with open(path) as f:
        rep = json.load(f)
    return {k: v for k, v in rep.items() if k not in drop}


def write_chan_dat(workdir, runs, rows, seed):
    """Fake instrumented-reference outputs: ``runs`` chan.dat files of
    ``rows`` cumulative rows (step, then 11 nondecreasing counters)."""
    rng = np.random.default_rng(seed)
    for r in range(runs):
        d = os.path.join(workdir, f"run{r}")
        os.makedirs(d, exist_ok=True)
        steps = 1000 * np.arange(1, rows + 1)[:, None]
        counts = np.cumsum(rng.integers(0, 9, size=(rows, 11)), axis=0)
        np.savetxt(os.path.join(d, "chan.dat"),
                   np.hstack([steps, counts]), fmt="%d")


# ---------------------------------------------------------------------------
# mini_golden


@pytest.mark.parametrize("which", ["1", "3", "10", "probe"])
def test_mini_config_matches(which):
    if which == "probe":
        got, want = prp.probe_config(), jrp.probe_config()
    else:
        got, want = pmg.our_config(float(which)), jmg.our_config(float(which))
    assert got.to_dict() == want.to_dict()
    assert (pmg.NA, pmg.NB, pmg.BOX_XY, pmg.BOX_Z) == \
        (jmg.NA, jmg.NB, jmg.BOX_XY, jmg.BOX_Z)


# ---------------------------------------------------------------------------
# receptors_probe


@pytest.fixture(scope="module")
def probe_runs(tmp_path_factory):
    """Both ``ours`` stages on the dense probe configuration: (JAX workdir,
    port workdir, JAX stderr, port stderr)."""
    base = tmp_path_factory.mktemp("probe")
    jdir, pdir = base / "jax", base / "port"
    jdir.mkdir()                        # the JAX stage writes into it as is
    steps = PROBE_CHUNK * PROBE_CHUNKS
    with jax_scripts_env(base / "jax_cache") as mp:
        mp.setattr(jrp, "probe_config", lambda: JConfig(**PROBE))
        mp.setattr(jrp, "OUR_STEPS", steps)
        mp.setattr(jrp, "OUT_EVERY", PROBE_CHUNK)
        mp.setattr(prp, "probe_config", lambda: TConfig(**PROBE))
        mp.setattr(prp, "OUT_EVERY", PROBE_CHUNK)
        common = ["--replicas", str(PROBE_REPLICAS), "--seed", "7"]
        jerr = run_jax_main(mp, jrp, ["ours", "--workdir", str(jdir),
                                      *common])
        perr = run_port_main(prp, ["ours", "--workdir", str(pdir), *common,
                                   "--steps", str(steps), "--device", "cpu"])
    assert (base / "jax_cache").is_dir()
    return jdir, pdir, jerr, perr


def test_probe_ours_matches_jax(probe_runs):
    jdir, pdir, jerr, perr = probe_runs
    progress = lambda err: [l.split(" (")[0] for l in err.splitlines()
                            if l.startswith("# ours")]
    assert progress(perr) == progress(jerr) == ["# ours 1/2", "# ours 2/2"]
    with np.load(jdir / prp.NPZ) as jz, np.load(pdir / prp.NPZ) as pz:
        assert set(pz.files) == set(jz.files) | {"device", "seconds"}
        for k in jz.files:
            assert pz[k].shape == jz[k].shape, k
            np.testing.assert_array_equal(pz[k], jz[k], k)
        assert int(pz["steps"]) == PROBE_CHUNK * PROBE_CHUNKS
        assert pz["elig_mono"].shape == (PROBE_REPLICAS,)
        assert pz["elig_mono"].sum() > 0
        assert str(pz["device"]) == "cpu" and float(pz["seconds"]) > 0


@pytest.mark.parametrize("form", ["chan_dat", "cross_npz"])
def test_probe_report_matches_jax(probe_runs, tmp_path, form):
    jdir, pdir, _, _ = probe_runs
    runs = 3
    for d in (jdir, pdir):
        write_chan_dat(d, runs, 9, seed=5)
    jout, pout = tmp_path / "jax.json", tmp_path / "port.json"
    argv = ["report", "--ref-runs", str(runs)]
    # chan_dat: each package on its own npz; cross_npz: on the other's
    jwork, pwork = (jdir, pdir) if form == "chan_dat" else (pdir, jdir)
    with pytest.MonkeyPatch.context() as mp:
        run_jax_main(mp, jrp, [*argv, "--workdir", str(jwork),
                               "--out", str(jout)])
    run_port_main(prp, [*argv, "--workdir", str(pwork), "--out", str(pout)])
    jrep, prep = read_json(jout), read_json(pout)
    assert prep == jrep
    assert jrep["ref_runs"] == runs and jrep["our_replicas"] == PROBE_REPLICAS
    full = read_json(pout, drop=())
    assert set(full) - set(jrep) == {"device", "seconds"}
    if form == "chan_dat":
        assert full["device"] == "cpu" and full["seconds"] > 0
    else:
        assert full["device"] is None and full["seconds"] is None


def test_probe_report_ref_json(probe_runs, tmp_path):
    _, pdir, _, _ = probe_runs
    out = tmp_path / "port.json"
    run_port_main(prp, ["report", "--workdir", str(pdir), "--ref-json", R05,
                        "--out", str(out)])
    rep = read_json(out, drop=())
    with open(R05) as f:
        r05 = json.load(f)
    for k in ("ref_runs", "ref_steps", "ref_rate_per_step", "ref_rate_se",
              "ref_rates", "ref_tail75_rate_per_step"):
        assert rep[k] == r05[k], k
    assert rep["jax_rate_per_step"] == r05["our_rate_per_step"]
    assert rep["jax_rate_se"] == r05["our_rate_se"]
    assert rep["ref_json"] == "RECEPTORS_PROBE_r05.json"
    ratio = rep["our_rate_per_step"] / r05["our_rate_per_step"]
    assert rep["ratio_port_over_jax"] == pytest.approx(ratio, rel=1e-12)
    lo, hi = rep["ratio_port_over_jax_ci95"]
    assert lo < ratio < hi
    assert rep["ratio_ours_over_ref"] == pytest.approx(
        rep["our_rate_per_step"] / r05["ref_rate_per_step"], rel=1e-12)


# ---------------------------------------------------------------------------
# chan_flux


def test_build_preformed_matches_jax():
    jst = jcf.build_preformed(jmg.our_config(10.0), 8)
    pst = pcf.build_preformed(pmg.our_config(10.0), 8)
    want = {f: np.asarray(getattr(jst, f)) for f in jst._fields
            if f != "key"}
    want["key"] = np.asarray(jax.random.key_data(jst.key))
    got = convert.to_numpy(pst, batched=False)
    for f, w in want.items():
        g = got[f]
        assert g.shape == w.shape and g.dtype == w.dtype, f
        if f in ("a_xy", "b_center"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f)
        elif f in ("a_psi", "b_quat"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, f)
    # 8 complexes of 1, 2, 3, 1, 2, 3, 1, 2 receptors
    assert int((got["a_trans"] >= 0).sum()) == 15


def test_chan_flux_matches_jax(tmp_path):
    work = tmp_path / "work"
    write_chan_dat(work, 2, 5, seed=3)
    series = {}

    def recording(mod, key):
        run = mod.run_ours

        def f(*a, **kw):
            series[key] = run(*a, **kw)
            return series[key]
        return f

    argv = ["--steps", "30", "--out-every", "10", "--replicas", "4",
            "--boost", "10", "--ref-runs", "2", "--workdir", str(work),
            "--preformed", "3", "--max-out", "3", "--reuse-refs",
            "--seed", "0"]
    jout, pout = tmp_path / "jax.json", tmp_path / "port.json"
    flux = lambda cls: lambda boost: cls(
        **FLUX, mono_cis_ass_rate=0.000047 * boost,
        cis_ass_rate=0.00096 * boost, out_every=1000)
    with jax_scripts_env(tmp_path / "jax_cache") as mp:
        mp.setattr(jmg, "our_config", flux(JConfig))
        mp.setattr(pmg, "our_config", flux(TConfig))
        mp.setattr(jcf, "run_ours", recording(jcf, "jax"))
        mp.setattr(pcf, "run_ours", recording(pcf, "port"))
        run_jax_main(mp, jcf, [*argv, "--cpu", "--out", str(jout)])
        run_port_main(pcf, [*argv, "--device", "cpu", "--out", str(pout)])
    assert len(series["port"]) == len(series["jax"]) == 3
    for i, (j, p) in enumerate(zip(series["jax"], series["port"])):
        assert sorted(p) == sorted(j)
        for k in j:
            np.testing.assert_array_equal(p[k], j[k], f"{k} output {i}")
    for k in ("elig_trans", "elig_mono", "elig_cis"):
        assert series["port"][-1][k].sum() > 0, k
    assert read_json(pout) == read_json(jout)
    full = read_json(pout, drop=())
    assert full["device"] == "cpu" and full["ours_outputs"] == 3
    assert full["ours_steps"] == 30


def _fake_series(n, replicas=3):
    """A stand-in run_ours: cumulative counts that grow by (k + 1) x
    (channel index + 1) x (replica + 1) at output k."""
    names = pcf.CHANNELS + ["residual_overlap"]
    out, acc = [], {c: np.zeros(replicas, np.int64) for c in names}
    for k in range(n):
        acc = {c: acc[c] + (k + 1) * (i + 1) * np.arange(1, replicas + 1)
               for i, c in enumerate(names)}
        out.append({c: v.copy() for c, v in acc.items()})
    return out


@pytest.mark.parametrize("max_out", [0, 2])
def test_chan_flux_ref_json_quarters(monkeypatch, tmp_path, max_out):
    """--ref-json: the quarter points of the reference's steps // out_every
    outputs, null past the run's last output; finals only for a full run."""
    ref = {"config": {"steps": 80, "boost": 10.0, "replicas": 3,
                      "ref_runs": 2},
           "channels": {c: {"ref_runs_final": [2.0, 4.0]}
                        for c in pcf.CHANNELS},
           "quarters": {c: {"ref_mean": [1.0, 2.0, 3.0, 4.0]}
                        for c in pcf.QUARTER_CHANNELS}}
    ref["channels"]["ref_extra"] = {c: [0.0, 1.0] for c in pcf.REF_EXTRA}
    path = tmp_path / "CHAN_FLUX_fake.json"
    path.write_text(json.dumps(ref))
    calls = []

    def fake(cfg, replicas, n_out, out_every, seed, init_state=None,
             device=None):
        calls.append((n_out, out_every, init_state is not None))
        return _fake_series(n_out, replicas)

    monkeypatch.setattr(pcf, "run_ours", fake)
    out = tmp_path / "port.json"
    run_port_main(pcf, ["--steps", "80", "--out-every", "10", "--replicas",
                        "3", "--preformed", "8", "--ref-json", str(path),
                        "--max-out", str(max_out), "--device", "cpu",
                        "--out", str(out)])
    rep = read_json(out, drop=())
    n_run = max_out or 8
    assert calls == [(n_run, 10, True)]
    series = _fake_series(8, 3)
    qs = [2, 4, 6, 7]                      # of the reference's 8 outputs
    for c in pcf.QUARTER_CHANNELS:
        assert rep["quarters"][c]["ref_mean"] == [1.0, 2.0, 3.0, 4.0]
        assert rep["quarters"][c]["ours_mean"] == [
            float(series[q][c].mean()) if q < n_run else None for q in qs]
    assert rep["ours_outputs"] == n_run and rep["ours_steps"] == 10 * n_run
    assert rep["config"] == {"steps": 80, "boost": 10.0, "replicas": 3,
                             "ref_runs": 2}
    assert rep["channels"]["ref_extra"] == ref["channels"]["ref_extra"]
    last = series[n_run - 1]
    for c in pcf.CHANNELS:
        ch = rep["channels"][c]
        assert ch["ref_runs_final"] == [2.0, 4.0]
        assert rep["ours_at_last_output"][c]["mean"] == last[c].mean()
        if max_out:
            assert ch["ours_mean_final"] is None
            assert ch["ratio_mean_vs_refmean"] is None
        else:
            assert ch["ours_mean_final"] == last[c].mean()
            assert ch["ratio_mean_vs_refmean"] == last[c].mean() / 3.0
    with pytest.raises(ValueError, match="asks for"):
        pcf.main(["--steps", "90", "--ref-json", str(path), "--device",
                  "cpu"])


# ---------------------------------------------------------------------------
# without a card, and without the reference source


@pytest.mark.parametrize("which", ["probe_ours", "chan_flux"])
def test_main_without_a_card_raises_before_writing(tmp_path, which):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    work = tmp_path / "work"
    if which == "probe_ours":
        mod, argv = prp, ["ours", "--workdir", str(work), "--steps", "5000"]
    else:
        mod, argv = pcf, ["--reuse-refs", "--workdir", str(work),
                          "--out", str(tmp_path / "report.json")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("which", ["probe_refs", "chan_flux_refs"])
def test_reference_stages_raise(tmp_path, which):
    if which == "probe_refs":
        mod, argv = prp, ["refs", "--workdir", str(tmp_path / "w")]
    else:
        mod, argv = pcf, ["--device", "cpu", "--workdir",
                          str(tmp_path / "w")]
    with pytest.raises(FileNotFoundError, match="main.cpp"):
        mod.main(argv)
    assert os.listdir(tmp_path) == []
