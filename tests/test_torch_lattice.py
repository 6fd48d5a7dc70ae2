"""The port's lattice engine (kmc_tpu_torch/lattice/, ops/lattice.py)
held against kmc_tpu's, bitwise, on the CPU.

* ``LatticeConfig`` and the mapping (``reference_lattice_config``,
  ``msd_per_step_A2``) equal kmc_tpu's.
* ``init_lattice`` by density and with ``n_particles`` (the permutation
  path) gives the same grid.
* ``lattice_step`` over 40 steps at 64^2 (dense) and at 48 x 80 with the
  mapped receptor probabilities gives the same grid and disp after every
  step, and those steps cover all 8 (hop axis, reaction direction)
  variants; ``lattice_step(row0, col0)`` on an offset block too.  The JAX
  side is jitted, as the JAX package runs it: XLA turns its division by
  the constant float32(hop_prob) into a product with the float32
  reciprocal, which the port does as well.
* The Pallas kernel itself (``make_pallas_lattice_step(cfg,
  interpret=True)``, whole-grid form at 32^2, 6 steps) against the port's
  plain version.  The tiled form is left to tests/test_pallas_lattice.py:
  interpret mode takes over a minute for it on a CPU.
* ``species_histogram``, ``particle_count`` and ``msd`` equal kmc_tpu's,
  ``lattice.dat`` rows are byte-identical from the same states, and
  checkpoints are read across both packages with equal fields, one
  written without ``time`` included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu.config import LatticeConfig as JLatticeConfig
from kmc_tpu.config import SimConfig as JSimConfig
from kmc_tpu.lattice import grid as jg
from kmc_tpu.lattice import io as jio
from kmc_tpu.lattice import mapping as jmap
from kmc_tpu.lattice import step as js
from kmc_tpu.ops.pallas_lattice import \
    make_pallas_lattice_step as j_make_pallas_step
from kmc_tpu_torch import convert
from kmc_tpu_torch.config import LatticeConfig, SimConfig
from kmc_tpu_torch.lattice import grid as tg
from kmc_tpu_torch.lattice import io as tio
from kmc_tpu_torch.lattice import mapping as tmap
from kmc_tpu_torch.lattice import step as ts
from kmc_tpu_torch.ops import lattice as k3

DENSE = dict(density=0.15, ass_prob=0.3, diss_prob=0.1)


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


def _tstate(st):
    """A kmc_tpu LatticeState as the port's, on the CPU."""
    return convert.lattice_from_numpy(
        {k: np.asarray(v) for k, v in st._asdict().items()})


def assert_same_state(got, want, what=""):
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    for name in tg.LatticeState._fields:
        g = getattr(got, name).cpu().numpy()
        assert g.dtype == want[name].dtype, (name, what)
        assert g.shape == want[name].shape, (name, what)
        np.testing.assert_array_equal(g, want[name], err_msg=f"{name} {what}")


def mapped_receptor_cfg(h, w):
    """BASELINE config 2's mapped receptor probabilities at (h, w)."""
    d = jmap.reference_lattice_config(JSimConfig(), height=h, width=w)
    return d.replace(density=0.3)


def test_config_and_mapping_match():
    assert LatticeConfig().to_dict() == JLatticeConfig().to_dict()
    cfg = LatticeConfig.from_dict({"height": 64, "hop_prob": 0.5, "x": 1})
    assert cfg.to_dict() == JLatticeConfig.from_dict(
        {"height": 64, "hop_prob": 0.5, "x": 1}).to_dict()
    for species in ("receptor", "ligand"):
        for reaction in ("mono_cis", "cis", "trans"):
            kw = dict(species=species, reaction=reaction, height=128,
                      width=64, rate_scale=3.0)
            assert (tmap.reference_lattice_config(SimConfig(), **kw).to_dict()
                    == jmap.reference_lattice_config(JSimConfig(), **kw)
                    .to_dict())
        assert (tmap.msd_per_step_A2(SimConfig(), species)
                == jmap.msd_per_step_A2(JSimConfig(), species))


@pytest.mark.parametrize("seed", [0, 1, 13])
@pytest.mark.parametrize("shape,density", [((32, 32), 0.1), ((48, 80), 0.3),
                                           ((64, 64), 0.04)])
def test_init_lattice_by_density_matches(seed, shape, density):
    kw = dict(height=shape[0], width=shape[1], density=density)
    got = tg.init_lattice(LatticeConfig(**kw), seed=seed, device="cpu")
    assert_same_state(got, jg.init_lattice(JLatticeConfig(**kw), seed=seed))


@pytest.mark.parametrize("shape,n", [((32, 32), 100), ((64, 64), 2500)])
def test_init_lattice_n_particles_matches(shape, n):
    kw = dict(height=shape[0], width=shape[1])
    got = tg.init_lattice(LatticeConfig(**kw), seed=1, n_particles=n,
                          device="cpu")
    assert_same_state(got, jg.init_lattice(JLatticeConfig(**kw), seed=1,
                                           n_particles=n))
    assert int(tg.particle_count(got)) == n


@pytest.mark.parametrize("case", ["dense_64", "mapped_48x80"])
def test_lattice_step_matches_40_steps(case):
    if case == "dense_64":
        jcfg, seed = JLatticeConfig(height=64, width=64, **DENSE), 13
    else:
        jcfg, seed = mapped_receptor_cfg(48, 80), 2
    tcfg = LatticeConfig(**jcfg.to_dict())
    a = jg.init_lattice(jcfg, seed=seed)
    b = tg.init_lattice(tcfg, seed=seed, device="cpu")
    step, tstep = js.make_lattice_step(jcfg), ts.make_lattice_step(tcfg)
    variants = set()
    for i in range(40):
        jdir, jpar = js.step_controls(a)
        tdir, tpar = ts.step_controls(b)
        np.testing.assert_array_equal(tdir.numpy(), np.asarray(jdir))
        np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
        variants.add(ts.step_variant(b))
        a, b = step(a), tstep(b)
        assert_same_state(b, a, f"after step {i + 1}")
    assert variants == {(h, r) for h in range(2) for r in range(4)}
    hist = tg.species_histogram(b).numpy()
    assert hist[1] > 0 and (case != "dense_64" or hist[2:].sum() > 0)


def test_lattice_step_offset_block_matches():
    """A 16 x 24 block at global origin (-6, 40) of a 64 x 64 grid, its
    hashes and parity on global coordinates: lattice_step(row0, col0)."""
    jcfg = JLatticeConfig(height=64, width=64, **DENSE)
    tcfg = LatticeConfig(**jcfg.to_dict())
    big = jg.init_lattice(jcfg, seed=5)
    a = big._replace(grid=big.grid[:16, :24], disp=big.disp[:16, :24])
    b = _tstate(a)
    step = jax.jit(lambda s: js.lattice_step(s, jcfg, -6, 40))
    for i in range(12):
        a, b = step(a), ts.lattice_step(b, tcfg, row0=-6, col0=40)
        assert_same_state(b, a, f"after step {i + 1}")


def test_pallas_kernel_interpret_matches_plain():
    """kmc_tpu's K3 in interpret mode (whole grid) against the port's
    plain version and against the port's wrapper, which on CPU tensors
    runs the plain version and launches nothing."""
    jcfg = JLatticeConfig(height=32, width=32, **DENSE)
    tcfg = LatticeConfig(**jcfg.to_dict())
    a = jg.init_lattice(jcfg, seed=3)
    b = c = tg.init_lattice(tcfg, seed=3, device="cpu")
    pls = j_make_pallas_step(jcfg, interpret=True)
    wrapped = k3.make_pallas_lattice_step(tcfg)
    launches = k3.lattice_block_call.launches
    for i in range(6):
        a = pls(a)
        b = ts.lattice_step(b, tcfg)
        c = wrapped(c)
        assert_same_state(b, a, f"after step {i + 1}")
        assert_same_state(c, a, f"wrapper, after step {i + 1}")
    assert k3.lattice_block_call.launches == launches
    chunk = k3.make_pallas_lattice_chunk(tcfg, 6)(
        tg.init_lattice(tcfg, seed=3, device="cpu"))
    assert_same_state(chunk, a, "chunk")


def _states():
    """A few kmc_tpu states with occupied, displaced, merged cells."""
    jcfg = JLatticeConfig(height=32, width=48, **DENSE)
    st = jg.init_lattice(jcfg, seed=4)
    chunk = js.make_lattice_chunk(jcfg, 25)
    out = [st]
    for _ in range(3):
        out.append(chunk(out[-1]))
    return out


def test_observables_and_lattice_dat_match(tmp_path):
    """From the same states: histogram, count and MSD equal, lattice.dat
    byte-identical.  The MSD's squared displacements are integers, so
    the float32 sums are exact and equal while they stay below 2^24;
    beyond that the two summation orders may round differently."""
    jp, tp = tmp_path / "jax.dat", tmp_path / "port.dat"
    for st in _states():
        t = _tstate(st)
        np.testing.assert_array_equal(tg.species_histogram(t).numpy(),
                                      np.asarray(jg.species_histogram(st)))
        assert int(tg.particle_count(t)) == int(jg.particle_count(st))
        m = tg.msd(t)
        assert m.dtype == torch.float32
        assert np.float32(m.item()) == np.asarray(jg.msd(st))
        jio.append_lattice_dat(str(jp), st)
        tio.append_lattice_dat(str(tp), t)
    assert tp.read_bytes() == jp.read_bytes()
    assert float(tp.read_text().splitlines()[-1].split()[2]) > 0


def test_checkpoints_cross_read(tmp_path):
    st = _states()[-1]
    jio.save_lattice(str(tmp_path / "j.npz"), st)
    assert_same_state(tio.load_lattice(str(tmp_path / "j.npz"), "cpu"), st)
    tio.save_lattice(str(tmp_path / "t.npz"), _tstate(st))
    assert_same_state(_tstate(jio.load_lattice(str(tmp_path / "t.npz"))), st)
    z = np.load(tmp_path / "t.npz")
    w = np.load(tmp_path / "j.npz")
    assert sorted(z.files) == sorted(w.files)
    for k in z.files:
        assert z[k].dtype == w[k].dtype and z[k].shape == w[k].shape, k
    # a checkpoint from before the time field: time resumes from step
    old = {k: np.asarray(v) for k, v in st._asdict().items() if k != "time"}
    np.savez(tmp_path / "old.npz", **old)
    got = tio.load_lattice(str(tmp_path / "old.npz"), "cpu")
    assert_same_state(got, jio.load_lattice(str(tmp_path / "old.npz")))
    assert float(got.time) == float(got.step) == 75.0


def test_output_set_and_convert_round_trip(tmp_path):
    st = _tstate(_states()[1])
    outs = tio.LatticeOutputSet(str(tmp_path), LatticeConfig())
    outs(st)
    outs(st)
    assert len((tmp_path / "lattice.dat").read_text().splitlines()) == 2
    assert os.path.exists(tmp_path / "lattice_checkpoint.npz")
    back = convert.lattice_from_numpy(convert.lattice_to_numpy(st))
    for name in tg.LatticeState._fields:
        assert torch.equal(getattr(back, name), getattr(st, name))
    tio.LatticeOutputSet(str(tmp_path), LatticeConfig(), fresh=True)
    assert (tmp_path / "lattice.dat").read_text() == ""
