"""The port's command line (kmc_tpu_torch.cli) against kmc_tpu.cli.

Both run tests/test_cli.py's small configuration with the same seed and
``--set fused_align=false``, so both packages run the unfused idealize
and a free-running comparison carries no fused-vs-unfused drift; the port
runs with ``--device cpu``.  bond.dat, cluster.log, hist.dat and
parameter.log must be byte-identical, and the numbers of test.gro and
position.cpt must agree within their printed precision (one unit in the
last printed digit: the two packages' poses agree to float32 rounding,
not bitwise, after 40 free-running steps).

The lattice engine (``--engine lattice``) at 64^2, 200 steps, output every
50: lattice.dat byte-identical and the checkpoints equal, before and after
a resume.  Its rejection-free mode (``--lattice-rf``) runs on the card
by default and never falls back to the CPU; its files are compared with
kmc_tpu.cli's in tests/test_torch_rejection_free.py.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmc_tpu import cli as jcli
from kmc_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _args(out, *extra):
    """tests/test_cli.py's arguments, with the unfused idealize."""
    return ["--out", str(out), "--seed", "1", "--quiet",
            "--set", "n_a=12", "--set", "n_b=4",
            "--set", "cell_range_x=1500", "--set", "cell_range_y=1500",
            "--set", "cell_range_z=500", "--set", "out_every=20",
            "--set", "fused_align=false", *extra]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _numbers(path):
    """Every number of a text file, in order."""
    out = []
    text = _read(path).decode().replace(",", " ").replace("=", " ")
    for tok in text.split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return np.asarray(out)


def _assert_same_outputs(jd, td, exact, printed):
    for f in exact:
        assert _read(os.path.join(td, f)) == _read(os.path.join(jd, f)), f
    for f, unit in printed:
        a, b = _numbers(os.path.join(td, f)), _numbers(os.path.join(jd, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=unit * 1.001,
                                   err_msg=f)


SINGLE_EXACT = ("bond.dat", "cluster.log", "hist.dat", "parameter.log")
SINGLE_PRINTED = (("test.gro", 1e-3), ("position.cpt", 1e-3))


def test_cli_single_run_and_resume_match(tmp_path, capsys):
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["--steps", "40", *_args(jd)]) == 0
    assert tcli.main(["--steps", "40", *_args(td), "--device", "cpu"]) == 0
    _assert_same_outputs(jd, td, SINGLE_EXACT, SINGLE_PRINTED)
    assert len(_read(td / "bond.dat").splitlines()) == 2
    assert os.path.exists(td / "checkpoint.npz")

    # resume from the native checkpoint: the time axis continues
    capsys.readouterr()
    assert jcli.main(["--steps", "20", *_args(jd)]) == 0
    assert tcli.main(["--steps", "20", *_args(td), "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert said.count("resuming from") == 2 and "at step 41" in said
    _assert_same_outputs(jd, td, SINGLE_EXACT, SINGLE_PRINTED)
    times = [float(r.split()[0]) for r in _read(td / "bond.dat").splitlines()]
    assert times == [200.0, 400.0, 600.0]


def test_cli_resume_from_reference_cpt(tmp_path, capsys):
    """Without a native checkpoint the run resumes from position.cpt."""
    td = tmp_path / "port"
    assert tcli.main(["--steps", "20", *_args(td), "--device", "cpu"]) == 0
    os.remove(td / "checkpoint.npz")
    capsys.readouterr()
    assert tcli.main(["--steps", "20", *_args(td), "--device", "cpu"]) == 0
    assert "position.cpt at step 21" in capsys.readouterr().out
    times = [float(r.split()[0]) for r in _read(td / "bond.dat").splitlines()]
    assert times == [200.0, 400.0]


def test_cli_ensemble_matches(tmp_path, capsys):
    jd, td = tmp_path / "jax", tmp_path / "port"
    extra = ("--steps", "20", "--replicas", "4")
    assert jcli.main([*extra, *_args(jd)]) == 0
    assert tcli.main([*extra, *_args(td), "--device", "cpu"]) == 0
    _assert_same_outputs(jd, td, ("bond_ens.dat", *SINGLE_EXACT),
                         SINGLE_PRINTED)
    assert os.path.exists(td / "ensemble_checkpoint.npz")
    capsys.readouterr()
    assert tcli.main([*extra, *_args(td), "--device", "cpu"]) == 0
    assert "resuming ensemble from" in capsys.readouterr().out
    assert len(_read(td / "bond_ens.dat").splitlines()) == 3


def test_cli_bad_value_and_unknown_key(tmp_path):
    for argv in (["--set", "n_a=abc"], ["--set", "nope=1"]):
        with pytest.raises(SystemExit) as want:
            jcli.main(["--steps", "1", "--out", str(tmp_path), *argv])
        with pytest.raises(SystemExit) as got:
            tcli.main(["--steps", "1", "--out", str(tmp_path), *argv,
                       "--device", "cpu"])
        assert str(got.value) == str(want.value)
        assert ("invalid value for n_a" in str(got.value)
                or "unknown config key" in str(got.value))


@pytest.mark.parametrize("flag", [["--engine", "lattice"],
                                  ["--lattice-pallas"], ["--lattice-rf"]])
def test_cli_lattice_not_ported(tmp_path, flag):
    """The rejection-free mode, whatever other lattice flags come with it,
    runs on the card by default and never falls back to the CPU: without
    a card it raises before anything is written."""
    argv = ["--steps", "1", "--out", str(tmp_path), *flag, "--lattice-rf",
            "--quiet"]
    if torch.cuda.is_available():
        assert tcli.main(argv) == 0
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)
    assert not os.listdir(tmp_path)                # nothing else ran


def test_cli_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "kmc_tpu_torch.cli", "--engine", "lattice",
         "--lattice-rf", "--steps", "1", "--out", str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr
    else:
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def _lattice_args(out, *extra):
    return ["--engine", "lattice", "--out", str(out), "--seed", "1",
            "--quiet", "--out-every", "50", "--set", "height=64",
            "--set", "width=64", "--set", "density=0.15",
            "--set", "ass_prob=0.3", "--set", "diss_prob=0.1", *extra]


def _assert_same_lattice_ckpt(jd, td):
    j = np.load(os.path.join(jd, "lattice_checkpoint.npz"))
    t = np.load(os.path.join(td, "lattice_checkpoint.npz"))
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("pallas", [[], ["--lattice-pallas"]],
                         ids=["xla", "pallas_flag"])
def test_cli_lattice_matches(tmp_path, capsys, pallas):
    """64^2, 200 steps in chunks of 50, then a resume of 100: the same
    files as kmc_tpu.cli's XLA step.  On the CPU the port runs the plain
    version, with or without --lattice-pallas."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["--steps", "200", *_lattice_args(jd),
                      "--platform", "cpu"]) == 0
    assert tcli.main(["--steps", "200", *_lattice_args(td, *pallas),
                      "--device", "cpu"]) == 0
    assert _read(td / "lattice.dat") == _read(jd / "lattice.dat")
    rows = _read(td / "lattice.dat").decode().splitlines()
    assert [int(r.split()[0]) for r in rows] == [50, 100, 150, 200]
    assert len({r.split()[1] for r in rows}) == 1      # mass conserved
    _assert_same_lattice_ckpt(jd, td)

    capsys.readouterr()
    assert jcli.main(["--steps", "100", *_lattice_args(jd),
                      "--platform", "cpu"]) == 0
    assert tcli.main(["--steps", "100", *_lattice_args(td, *pallas),
                      "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert said.count("resuming lattice from") == 2 and "at step 200" in said
    assert _read(td / "lattice.dat") == _read(jd / "lattice.dat")
    assert _read(td / "lattice.dat").decode().splitlines()[-1].startswith(
        "300 ")
    _assert_same_lattice_ckpt(jd, td)


def test_cli_lattice_defaults_to_cuda(tmp_path):
    argv = ["--steps", "50", *_lattice_args(tmp_path)]
    if torch.cuda.is_available():
        assert tcli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)
        assert not os.path.exists(tmp_path / "lattice.dat")


def test_cli_defaults_to_cuda(tmp_path):
    argv = ["--steps", "20", *_args(tmp_path)]
    if torch.cuda.is_available():
        assert tcli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)
        assert not os.path.exists(tmp_path / "bond.dat")
