"""The port's oracle validation tools (kmc_tpu_torch/scripts/
validate_vs_reference.py and check_flagship_state.py) against the JAX
package's scripts/ on the same inputs, on the CPU.

* The readers of bond.dat, cluster.log (both parsers) and test.gro, the
  MSD curve, and the kinetics and cluster band reports (NaN rows included)
  give equal results: arrays bitwise, reports JSON-equal.
* truncate_outputs trims a port EnsembleOutputSet directory to the same
  files.
* _run_ensemble on a dense small config (24 + 8 molecules in 700 x 700 x
  200 A, fused_align=False, out_every=20), 8 replicas, 3 outputs of 2
  chunks, eager and lazy: kinetics series and both histograms bitwise.
  From tests/data/ref_position.cpt at SimConfig(out_every=2,
  fused_align=False), 4 replicas: the same series.
* The state file: a port run cut after output 1 and resumed equals an
  uninterrupted one bitwise (state file, series, written outputs); each
  package's file resumes in the other's _run_ensemble to the same
  series; --report-only equals the in-run report; both packages'
  check_flagship_state pass on the port's file.
* cmd_kinetics end to end (an anchor continuation, --skip-initial, both
  oracles) gives kmc_tpu's report; a pre-round-5 state file resumes with
  the same NaN padding; the partial report comes every 10 outputs;
  --time-limit stops at an output boundary.
* main() without --device cpu raises here before it writes anything.

The scripts are imported from scripts/ as tests/test_validation_tools.py
does, and run_config is replaced with monkeypatch; no JAX file changes."""

import contextlib
import io
import itertools
import json
import os
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from kmc_tpu.config import SimConfig as JConfig
from kmc_tpu_torch.config import SimConfig as TConfig
from kmc_tpu_torch.io.writers import EnsembleOutputSet
from kmc_tpu_torch.parallel.ensemble import init_ensemble, make_ensemble_chunk
from kmc_tpu_torch.scripts import check_flagship_state as pcf
from kmc_tpu_torch.scripts import validate_vs_reference as pv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import check_flagship_state as jcf  # noqa: E402
import validate_vs_reference as jv  # noqa: E402

REF = os.path.join(REPO, "ref_data")
REF_CPT = os.path.join(REPO, "tests", "data", "ref_position.cpt")
DENSE = dict(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
             cell_range_z=200.0, fused_align=False, out_every=20)
ANCHOR = dict(out_every=2, fused_align=False)
MAX_HIST = 16
N_OUT = 3


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


def _args(**kw):
    base = dict(replicas=8, seed=0, sub_chunks=2, align_mode="eager",
                init_cpt=None, write_outputs=None, state_file=None,
                resume_state=True, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def run_jax(cfg_kw, n_out, with_hist=True, **kw):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jv, "run_config", lambda: JConfig(**cfg_kw))
        return jv._run_ensemble(_args(**kw), n_out, with_hist)


def run_port(cfg_kw, n_out, with_hist=True, **kw):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pv, "run_config", lambda: TConfig(**cfg_kw))
        return pv._run_ensemble(_args(**kw), n_out, with_hist)


def assert_same_series(a, b):
    kin_a, hist_a, ahist_a = a
    kin_b, hist_b, ahist_b = b
    assert list(kin_a) == list(kin_b) == jv.KIN_COLS
    for c in jv.KIN_COLS:
        np.testing.assert_array_equal(kin_a[c], kin_b[c], err_msg=c)
    for x, y in ((hist_a, hist_b), (ahist_a, ahist_b)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def same_state_files(a, b):
    with np.load(a) as za, np.load(b) as zb:
        keys = (set(za.files) | set(zb.files)) - {"wall_s"}
        return sorted(k for k in keys if k not in za.files
                      or k not in zb.files
                      or not np.array_equal(za[k], zb[k]))


# ---------------------------------------------------------------------------
# readers and reports

@pytest.mark.parametrize("name", ["refgolden_bond.dat",
                                  "refgolden2_bond.dat"])
def test_read_bond_dat_matches(name):
    path = os.path.join(REF, name)
    got, want = pv.read_bond_dat(path), jv.read_bond_dat(path)
    assert got.shape == want.shape and got.shape[1] == 7
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["refgolden_cluster.log",
                                  "refgolden2_cluster.log"])
@pytest.mark.parametrize("parser", ["sizes", "receptors"])
def test_cluster_log_parsers_match(name, parser):
    path = os.path.join(REF, name)
    if parser == "sizes":
        got = pv.read_cluster_log(path, MAX_HIST)
        want = jv.read_cluster_log(path, MAX_HIST)
    else:
        got = pv.read_cluster_log_receptors(path, 150, MAX_HIST)
        want = jv.read_cluster_log_receptors(path, 150, MAX_HIST)
    assert len(got[0]) > 900
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_read_gro_centers_and_msd_match(tmp_path):
    cfg = JConfig()
    lines = 5 * (cfg.n_a * 4 + cfg.n_b * 3 + 3)
    path = str(tmp_path / "test.gro")
    with open(os.path.join(REF, "refgolden_test.gro")) as f, \
            open(path, "w") as g:
        g.writelines(itertools.islice(f, lines))
    t_p, x_p = pv.read_gro_centers(path, cfg.n_a, cfg.n_b)
    t_j, x_j = jv.read_gro_centers(path, cfg.n_a, cfg.n_b)
    assert x_p.shape == (5, cfg.n, 3)
    np.testing.assert_array_equal(t_p, t_j)
    np.testing.assert_array_equal(x_p, x_j)
    box = (cfg.cell_range_x, cfg.cell_range_y)
    for g, w in zip(pv.msd_curve(t_p, x_p, box), jv.msd_curve(t_j, x_j, box)):
        np.testing.assert_array_equal(g, w)


def _report_args(reps):
    return types.SimpleNamespace(replicas=reps, quantile=0.995,
                                 min_coverage=0.9)


@pytest.mark.parametrize("nan", ["none", "half_rows", "all_rows"])
def test_kinetics_report_matches(nan):
    rng = np.random.default_rng(1)
    n, reps = 40, 32
    ref = np.zeros((n, 7))
    ref[:, 0] = np.arange(1, n + 1) * 5e4
    kin = {}
    for ci, c in enumerate(jv.KIN_COLS):
        kin[c] = rng.poisson(3.0 + ci, size=(n, reps)).astype(np.float64)
        ref[:, 1 + ci] = rng.poisson(3.0 + ci, size=n)
    kin["cluster_size"] = kin["cluster_size"] / 3.0
    if nan == "half_rows":
        kin["max_complex"][: n // 2] = np.nan
        kin["bond_cis"][:5] = np.nan
    elif nan == "all_rows":
        kin["max_complex"][:] = np.nan
    args = _report_args(reps)
    got = pv._kinetics_report({c: v.copy() for c, v in kin.items()}, ref,
                              args)
    want = jv._kinetics_report(kin, ref, args)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("nan", ["none", "first_frames", "all_frames"])
def test_clusters_report_matches(nan):
    rng = np.random.default_rng(2)
    n, reps = 30, 16
    ens = rng.poisson(2.0, size=(n, reps, MAX_HIST + 1)).astype(np.float64)
    ref = rng.poisson(2.0, size=(n + 4, MAX_HIST + 1))
    if nan == "first_frames":
        ens[:7] = np.nan
    elif nan == "all_frames":
        ens[:] = np.nan
    args = _report_args(reps)
    got = pv._clusters_report(ens.copy(), ref, args)
    want = jv._clusters_report(ens, ref, args)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_truncate_outputs_matches(tmp_path):
    cfg = TConfig(**DENSE)
    out = str(tmp_path / "flag")
    writer = EnsembleOutputSet(out, cfg, fresh=True)
    chunk = make_ensemble_chunk(cfg, 5, device="cpu")
    state = init_ensemble(cfg, 4, seed=0, device="cpu")
    for _ in range(3):
        state, obs = chunk(state)
        writer(state, obs)
    writer.close()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(out, a)
    shutil.copytree(out, b)
    pv.truncate_outputs(a, cfg, 2)
    jv.truncate_outputs(b, JConfig(**DENSE), 2)
    names = sorted(os.listdir(out))
    assert {"bond.dat", "bond_ens.dat", "test.gro",
            "cluster.log"} <= set(names)
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(a, "bond.dat")) as f:
        assert len(f.readlines()) == 2


# ---------------------------------------------------------------------------
# the ensemble run and the state file

@pytest.fixture(scope="module")
def jax_lazy():
    """kmc_tpu's lazy run on DENSE: 3 outputs, histograms."""
    return run_jax(DENSE, N_OUT, align_mode="lazy")


@pytest.mark.parametrize("mode", ["eager", "lazy"])
def test_run_ensemble_matches_jax(mode, jax_lazy):
    got = run_port(DENSE, N_OUT, align_mode=mode)
    want = jax_lazy if mode == "lazy" else run_jax(DENSE, N_OUT,
                                                   align_mode=mode)
    assert got[0]["bond_rl"].shape == (N_OUT, 8)
    assert got[1].shape == (N_OUT, 8, MAX_HIST + 1)
    assert_same_series(got, want)


def test_init_cpt_run_matches_jax(tmp_path):
    """Anchor continuation from a mature reference checkpoint, 3 outputs
    of 2 eager steps at 4 replicas; then both packages' invariant check
    on the port's state file and on kmc_tpu's."""
    psf, jsf = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    with open(REF_CPT) as f:
        anchor_step = int(f.read().split()[-1])
    kw = dict(replicas=4, sub_chunks=1, init_cpt=REF_CPT)
    got = run_port(ANCHOR, N_OUT, False, state_file=psf, **kw)
    want = run_jax(ANCHOR, N_OUT, False, state_file=jsf, **kw)
    assert got[1] is None and got[0]["bond_rl"].min() > 0
    assert_same_series(got, want)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(pv, "run_config", lambda: TConfig(**ANCHOR))
        for path in (psf, jsf):
            rep = pcf.check_state(path, "cpu", batch=3)
            assert rep["ok"] and rep["replicas"] == 4, rep
            assert rep["steps_per_replica"] == anchor_step + 2 * N_OUT
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as m, contextlib.redirect_stdout(buf):
        m.setattr(sys, "argv", ["check_flagship_state.py", "--state", psf])
        rc = jcf.main()
    rep = json.loads(buf.getvalue())
    assert rc == 0 and rep["ok"] is True and rep["replicas"] == 4, rep
    assert rep["k_done_outputs"] == N_OUT


def test_state_file_cut_and_resume_in_port(tmp_path):
    """Lazy, histograms and the written output files: cut after output 1,
    resumed to 3, equals 3 uninterrupted outputs bitwise."""
    whole, cut = str(tmp_path / "whole.npz"), str(tmp_path / "cut.npz")
    ow, oc = str(tmp_path / "out_whole"), str(tmp_path / "out_cut")
    want = run_port(DENSE, N_OUT, align_mode="lazy", state_file=whole,
                    write_outputs=ow)
    run_port(DENSE, 1, align_mode="lazy", state_file=cut, write_outputs=oc)
    with open(os.path.join(oc, "bond.dat"), "a") as f:
        f.write("a row the state file never saw\n")    # the resume race
    got = run_port(DENSE, N_OUT, align_mode="lazy", state_file=cut,
                   write_outputs=oc)
    assert_same_series(got, want)
    assert same_state_files(whole, cut) == []
    with np.load(cut) as z:
        assert int(z["k_done"]) == N_OUT and float(z["wall_s"]) > 0
        assert z["leaf11"].dtype == np.uint32 and z["leaf11"].shape == (8, 2)
        assert z["kin"].shape == (N_OUT, len(pv.KIN_COLS), 8)
    for name in sorted(os.listdir(ow)):
        with open(os.path.join(ow, name), "rb") as f, \
                open(os.path.join(oc, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_state_file_resumes_across_packages(direction, tmp_path, jax_lazy):
    sf = str(tmp_path / "state.npz")
    first, then = ((run_port, run_jax) if direction == "port_to_jax"
                   else (run_jax, run_port))
    first(DENSE, 1, align_mode="lazy", state_file=sf)
    got = then(DENSE, N_OUT, align_mode="lazy", state_file=sf)
    assert_same_series(got, jax_lazy)
    with np.load(sf) as z:
        assert int(z["k_done"]) == N_OUT and int(z["n_leaf"]) == 13


def test_pre_r5_state_file_resumes_with_nan_padding(tmp_path):
    """A state file with 4 kinetics columns and no receptor histograms
    (the layout before round 5) resumes in both packages to the same
    series, the missing rows NaN."""
    sf, old = str(tmp_path / "state.npz"), str(tmp_path / "old.npz")
    run_port(DENSE, 1, align_mode="lazy", state_file=sf)
    with np.load(sf) as z:
        arrs = {k: z[k] for k in z.files if k not in ("ahists", "wall_s")}
    arrs["kin"] = arrs["kin"][:, :4]
    runs = []
    for run in (run_port, run_jax):
        with open(old, "wb") as f:
            np.savez(f, **arrs)
        runs.append(run(DENSE, N_OUT, align_mode="lazy", state_file=old))
    assert_same_series(*runs)
    kin, _, ahist = runs[0]
    assert np.isnan(kin["cluster_size"][0]).all()
    assert not np.isnan(kin["cluster_size"][1:]).any()
    assert np.isnan(ahist[0]).all() and not np.isnan(ahist[1:]).any()


def test_cmd_kinetics_report_matches_jax(tmp_path):
    """cmd_kinetics end to end in both packages: an anchor continuation
    from tests/data/ref_position.cpt (step 1,425,000: 285 oracle rows
    skipped), --skip-initial 1, 3 rows, lazy, both oracles' bond.dat and
    cluster.log: the same exit code and a JSON-equal report, the port's
    own keys aside."""
    common = dict(
        ref_bond=[os.path.join(REF, f"refgolden{i}_bond.dat")
                  for i in ("", "2")],
        ref_cluster=[os.path.join(REF, f"refgolden{i}_cluster.log")
                     for i in ("", "2")],
        replicas=4, seed=0, quantile=0.995, min_coverage=0.9, max_rows=3,
        sub_chunks=1, align_mode="lazy", init_cpt=REF_CPT,
        write_outputs=None, resume_state=False, skip_initial=1,
        report_only=False)
    reports, codes = [], []
    for mod, cfg in ((pv, TConfig(**ANCHOR)), (jv, JConfig(**ANCHOR))):
        out = str(tmp_path / f"{mod.__name__}.json")
        args = types.SimpleNamespace(
            **common, out=out, state_file=str(tmp_path / f"{id(mod)}.npz"),
            device="cpu", time_limit=0, invariants=False)
        with pytest.MonkeyPatch.context() as m, \
                contextlib.redirect_stdout(io.StringIO()):
            m.setattr(mod, "run_config", lambda cfg=cfg: cfg)
            codes.append(mod.cmd_kinetics(args))
        with open(out) as f:
            reports.append(json.load(f))
    port, want = reports
    assert port.pop("device") == "cpu" and port.pop("seconds") > 0
    assert port.pop("rows_asked") == 3
    assert port.pop("ensemble_seconds_all_runs") > 0
    assert want["anchor"]["skipped_rows"] == 285
    assert want["skip_initial_burn_in_rows"] == 1
    assert json.dumps(port, sort_keys=True) == json.dumps(want,
                                                          sort_keys=True)
    assert codes[0] == codes[1]


def _main_report(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pv.main(argv)
    return rc, json.loads(buf.getvalue())


def test_report_only_equals_in_run_report(tmp_path, monkeypatch):
    monkeypatch.setattr(pv, "run_config", lambda: TConfig(**DENSE))
    sf, out = str(tmp_path / "state.npz"), str(tmp_path / "report.json")
    base = ["kinetics", "--ref-bond",
            *(os.path.join(REF, f"refgolden{i}_bond.dat") for i in ("", "2")),
            "--ref-cluster",
            *(os.path.join(REF, f"refgolden{i}_cluster.log")
              for i in ("", "2")),
            "--replicas", "8", "--align-mode", "lazy", "--sub-chunks", "2",
            "--max-rows", str(N_OUT), "--state-file", sf, "--invariants",
            "--device", "cpu"]
    rc, run = _main_report(base + ["--out", out])
    with open(out) as f:
        assert json.load(f) == run
    rc2, again = _main_report(base + ["--report-only"])
    assert rc2 == rc
    assert again.pop("report_only_at_rows") == N_OUT
    for r in (run, again):
        assert r.pop("seconds") > 0
    assert again == run
    assert run["device"] == "cpu" and run["n_out"] == N_OUT
    assert run["invariants"]["ok"] is True
    assert len(run["kinetics_runs"]) == 2
    assert len(run["clusters_runs"]) == len(run["receptor_oligomer_runs"]) == 2
    assert set(run["kinetics_runs"][0]["columns"]) == set(pv.KIN_COLS)


def test_partial_report_every_ten_outputs(tmp_path, monkeypatch):
    cfg = dict(DENSE, out_every=2)
    monkeypatch.setattr(pv, "run_config", lambda: TConfig(**cfg))
    out = str(tmp_path / "report.json")
    rc, rep = _main_report([
        "kinetics", "--ref-bond", os.path.join(REF, "refgolden_bond.dat"),
        "--replicas", "4", "--max-rows", "10", "--sub-chunks", "1",
        "--device", "cpu", "--out", out])
    with open(out + ".partial") as f:
        partial = json.load(f)
    assert partial.pop("partial") is True and "partial" not in rep
    assert partial["n_out"] == rep["n_out"] == 10
    assert partial["kinetics_runs"] == rep["kinetics_runs"]
    assert not os.path.exists(out + ".partial.tmp")


def test_time_limit_stops_between_outputs(tmp_path, monkeypatch):
    """--time-limit stops the run at an output boundary; the state file
    holds the rows done and the report says so (partial, stopped)."""
    monkeypatch.setattr(pv, "run_config", lambda: TConfig(**DENSE))
    sf = str(tmp_path / "state.npz")
    rc, rep = _main_report([
        "kinetics", "--ref-bond", os.path.join(REF, "refgolden_bond.dat"),
        "--replicas", "4", "--max-rows", "5", "--state-file", sf,
        "--time-limit", "1e-9", "--device", "cpu"])
    assert rep["partial"] is True and rep["n_out"] == 1
    assert rep["stopped"]["rows_done"] == 1
    assert rep["stopped"]["rows_asked"] == rep["rows_asked"] == 5
    with np.load(sf) as z:
        assert int(z["k_done"]) == 1


def test_main_without_a_card_raises_before_writing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    sf, out = str(tmp_path / "state.npz"), str(tmp_path / "report.json")
    argv = ["kinetics", "--ref-bond", os.path.join(REF, "refgolden_bond.dat"),
            "--replicas", "2", "--max-rows", "1", "--state-file", sf,
            "--out", out]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pv.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcf.main(["--state", sf])
    assert os.listdir(tmp_path) == []


def test_device_label_picks_the_card_by_uuid(monkeypatch):
    """nvidia-smi lists every card of the host; the report names the one
    the process runs on (here the host's second card, the process's cuda:0),
    not the line at the process's device index."""
    smi = ("GPU-aaaaaaaa-0000-0000-0000-000000000000, NVIDIA H100 80GB HBM3, "
           "700.00 W\n"
           "GPU-BBBBBBBB-1111-1111-1111-111111111111, NVIDIA H100 PCIe, "
           "350.00 W\n")
    seen = {}

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return types.SimpleNamespace(stdout=smi)

    monkeypatch.setattr(pv.subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            uuid="bbbbbbbb-1111-1111-1111-111111111111"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    assert pv.device_label("cuda:0") == "NVIDIA H100 PCIe, 350.00 W"
    assert "--query-gpu=uuid,name,power.limit" in seen["cmd"]
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid="cccc"))
    assert pv.device_label("cuda:0") == "card, power limit not read"
    assert pv.device_label("cpu") == "cpu"
